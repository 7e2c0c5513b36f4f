"""VALL-E X: cross-lingual zero-shot TTS as a codec language model (port
of ``speecht5_tpu/models/vallex.py``).

- ``VALLEX_AR``: a causal decoder-only LM over the first codebook, on the
  sequence [phonemes][bos + acoustic prompt codes + codes], espnet
  sinusoids per segment; ``generate`` prefills the whole prefix into the
  KV cache in one causal pass (Tq = prefix length: the decoder's dense
  branch) and then takes one cached step per code, each step's attention
  on the ``flash_attention_bias`` kernel when ``ar.use_pallas_attn`` is on
  (the step's position is the cache index less the phonemes); a row that
  emitted ``code_eos`` keeps emitting it, and its length is the step it
  first did (JAX's ``newly``).  Greedy at temperature 0; above it the
  codes are drawn from the caller's ``torch.Generator`` (JAX's
  ``categorical`` stream cannot be matched).
- ``VALLEX_NAR``: one ``TransformerEncoder`` pass per codebook 1..K-1 on
  [phonemes][sum of the embeddings of the codebooks below + a stage
  embedding], through ``out_<stage>``; it has no rel-pos bias, so its
  attention takes the plain route, as in JAX.
- ``VALLEX.synthesize``: AR then the NAR passes, greedy.

Parameters live in f32 and the stacks compute in ``dtype``; the output
projections read f32 features.  Names follow the JAX tree
(``utils/convert.vallex_from_jax_params``).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace as dc_replace

import torch
from torch import nn

from ..config import RelPosConfig, TransformerConfig
from ..ops.positional import espnet_sinusoidal_table
from ..utils.device import resolve_device
from .common import init_weights
from .decoder import TransformerDecoder
from .encoder import TransformerEncoder

# decode steps between two host reads of the stop condition
STOP_CHECK_EVERY = 4


def _stack(layers: int = 12) -> TransformerConfig:
    return TransformerConfig(d_model=1024, ffn_dim=4096, num_layers=layers, num_heads=16,
                             layer_norm_first=True, use_rel_pos_bias=False,
                             rel_pos=RelPosConfig(enabled=False))


@dataclass(frozen=True)
class VALLEXConfig:
    phoneme_vocab: int = 512          # incl. language-id tokens
    codebook_size: int = 1024
    n_codebooks: int = 8
    d_model: int = 1024
    ar: TransformerConfig = field(default_factory=_stack)
    nar: TransformerConfig = field(default_factory=_stack)
    pad_id: int = 0
    max_len: int = 2048
    dtype: str = "float32"

    @property
    def code_eos(self) -> int:        # the extra symbol of codebook 0
        return self.codebook_size

    @property
    def code_bos(self) -> int:
        return self.codebook_size + 1

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def vallex_tiny(**kw) -> VALLEXConfig:
    t = TransformerConfig(d_model=48, ffn_dim=96, num_layers=2, num_heads=4, dropout=0.0,
                          attention_dropout=0.0, layer_norm_first=True,
                          use_rel_pos_bias=False, rel_pos=RelPosConfig(enabled=False))
    return dc_replace(VALLEXConfig(phoneme_vocab=32, codebook_size=24, n_codebooks=4,
                                   d_model=48, ar=t, nar=t, max_len=128), **kw)


class _Positions(nn.Module):
    """The espnet sinusoid table [max_len, d] as a buffer (not saved)."""

    def __init__(self, max_len: int, d: int):
        super().__init__()
        self.register_buffer("table", torch.from_numpy(espnet_sinusoidal_table(max_len, d)),
                             persistent=False)

    def first(self, n: int, dtype):
        """Rows 0..n-1; JAX's slice would come up short past the table."""
        if n > self.table.shape[0]:
            raise ValueError(f"{n} positions; the table has {self.table.shape[0]}")
        return self.table[:n].to(dtype)


class VALLEX_AR(nn.Module):
    """Causal codec LM over codebook 0 (decoder-only)."""

    def __init__(self, cfg: VALLEXConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = cfg.compute_dtype
        self.phone_embed = nn.Embedding(cfg.phoneme_vocab, cfg.d_model)
        self.code_embed = nn.Embedding(cfg.codebook_size + 2, cfg.d_model)  # +eos +bos
        self.decoder = TransformerDecoder(cfg.ar, self.dtype, cross_attention=False)
        self.out_proj = nn.Linear(cfg.d_model, cfg.codebook_size + 1)       # +eos
        self.pos = _Positions(cfg.max_len, cfg.d_model)
        self.steps_run = 0      # cached decode steps, over every call

    def _embed_seq(self, phonemes, prev_codes):
        """[phonemes][bos + codes], each segment's sinusoids from 0 -> (x, valid)."""
        dt = self.dtype
        p = self.phone_embed(phonemes).to(dt) + self.pos.first(phonemes.shape[1], dt)
        c = self.code_embed(prev_codes).to(dt) + self.pos.first(prev_codes.shape[1], dt)
        valid = torch.cat([phonemes != self.cfg.pad_id,
                           torch.ones(prev_codes.shape, dtype=torch.bool,
                                      device=prev_codes.device)], dim=1)
        return torch.cat([p, c], dim=1), valid

    def forward(self, phonemes, prev_codes):
        """Teacher-forced: prev_codes [B, T] (the bos-shifted codebook-0
        stream, prompt included) -> f32 logits [B, T, codebook_size + 1] at
        the code positions."""
        x, valid = self._embed_seq(phonemes, prev_codes)
        feats = self.decoder(x, None, self_valid=valid, causal=True)
        return self.out_proj(feats[:, phonemes.shape[1]:].float())

    def _sample(self, logits, temperature: float, generator):
        if temperature <= 0:
            return logits.argmax(-1)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    @torch.no_grad()
    def generate(self, phonemes, prompt_codes, *, max_new: int = 64, generator=None,
                 temperature: float = 0.0):
        """Prefill [phonemes][bos + prompt], then a code a step until
        ``code_eos`` -> (codes [B, max_new] int64, lengths [B] int64), as
        JAX's while_loop leaves them: the slots after the step at which
        every row had stopped stay 0."""
        cfg = self.cfg
        B, Lp = phonemes.shape
        dev = phonemes.device
        if prompt_codes.shape[1] + max_new > cfg.max_len:
            # the last step reads position Tp + max_new - 1; JAX reads the
            # table clamped past its end (ROADMAP C.2)
            raise ValueError(f"prompt {prompt_codes.shape[1]} + max_new {max_new} codes "
                             f"need positions past the table's {cfg.max_len}")
        prev = torch.cat([torch.full((B, 1), cfg.code_bos, dtype=torch.int64, device=dev),
                          prompt_codes.long()], dim=1)
        x, valid = self._embed_seq(phonemes, prev)
        L0 = x.shape[1]
        cache = self.decoder.init_cache(None, B, L0 + max_new)
        # padded phonemes are never attendable; the causal mask hides the
        # slots not yet written
        self_valid = torch.cat([valid[:, :Lp], torch.ones((B, max_new + L0 - Lp),
                                                          dtype=torch.bool, device=dev)], 1)
        feats, cache = self.decoder.decode_step(x, cache, self_valid=self_valid)
        tok = self._sample(self.out_proj(feats[:, -1].float()), temperature, generator)
        eos = cfg.code_eos
        out = torch.zeros((B, max_new), dtype=torch.int64, device=dev)
        out[:, 0] = tok
        done = tok == eos
        lengths = torch.where(done, 0, max_new)
        n_written = torch.ones((), dtype=torch.int64, device=dev)
        for t in range(max_new - 1):
            if t % STOP_CHECK_EVERY == 0 and bool(done.all()):
                break
            running = ~done.all()
            emb = (self.code_embed(tok)[:, None].to(self.dtype)
                   + self.pos.table[cache["index"] - Lp].to(self.dtype))
            feats, cache = self.decoder.decode_step(emb, cache, self_valid=self_valid)
            self.steps_run += 1
            nxt = self._sample(self.out_proj(feats[:, 0].float()), temperature, generator)
            newly = ~done & (nxt == eos)
            lengths = torch.where(newly, t + 1, lengths)
            done = done | newly
            tok = torch.where(done, eos, nxt)
            out[:, t + 1] = tok
            n_written = torch.where(running, t + 2, n_written)
        out = out * (torch.arange(max_new, device=dev) < n_written)
        return out, lengths


class VALLEX_NAR(nn.Module):
    """Codebook ``stage`` from the phonemes, the sum of the embeddings of
    the codebooks below it and a stage embedding."""

    def __init__(self, cfg: VALLEXConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = cfg.compute_dtype
        d = cfg.d_model
        self.phone_embed = nn.Embedding(cfg.phoneme_vocab, d)
        # a table for each codebook a stage reads: 0..K-2 (JAX declares K,
        # but flax never creates the last, which no stage reads)
        for j in range(cfg.n_codebooks - 1):
            self.add_module(f"code_embed_{j}", nn.Embedding(cfg.codebook_size, d))
        self.stage_embed = nn.Embedding(cfg.n_codebooks, d)
        self.encoder = TransformerEncoder(cfg.nar, dtype=self.dtype)
        for j in range(1, cfg.n_codebooks):
            self.add_module(f"out_{j}", nn.Linear(d, cfg.codebook_size))
        self.pos = _Positions(cfg.max_len, d)

    def forward(self, phonemes, codes, stage: int, *, code_valid=None):
        """codes [B, n_codebooks, T] (only the codebooks below ``stage``
        are read), ``stage`` in [1, n_codebooks) -> f32 logits [B, T,
        codebook_size] of codebook ``stage``."""
        dt = self.dtype
        B, _, T = codes.shape
        dev = codes.device
        p = self.phone_embed(phonemes).to(dt) + self.pos.first(phonemes.shape[1], dt)
        acc = torch.zeros((B, T, self.cfg.d_model), dtype=dt, device=dev)
        for j in range(stage):
            acc = acc + getattr(self, f"code_embed_{j}")(codes[:, j].long()).to(dt)
        acc = acc + self.stage_embed.weight[stage].to(dt)
        acc = acc + self.pos.first(T, dt)
        if code_valid is None:
            code_valid = torch.ones((B, T), dtype=torch.bool, device=dev)
        valid = torch.cat([phonemes != self.cfg.pad_id, code_valid], dim=1)
        enc = self.encoder(torch.cat([p, acc], dim=1), valid)
        feats = enc["encoder_out"][:, phonemes.shape[1]:]
        return getattr(self, f"out_{stage}")(feats.float())


class VALLEX(nn.Module):
    """AR + NAR with end-to-end synthesis."""

    def __init__(self, cfg: VALLEXConfig):
        super().__init__()
        self.cfg = cfg
        self.ar = VALLEX_AR(cfg)
        self.nar = VALLEX_NAR(cfg)

    def forward_ar(self, phonemes, prev_codes):
        return self.ar(phonemes, prev_codes)

    def forward_nar(self, phonemes, codes, stage: int, *, code_valid=None):
        return self.nar(phonemes, codes, stage, code_valid=code_valid)

    @torch.no_grad()
    def synthesize(self, phonemes, prompt_codes, *, max_new: int = 64, generator=None,
                   temperature: float = 0.0):
        """phonemes [B, Lp] (language id + text phonemes), prompt_codes [B,
        n_codebooks, Tp] -> (codes [B, n_codebooks, max_new] int64, lengths
        [B]): codebook 0 from the AR stage (eos mapped into the codebook),
        every other from its NAR pass, zero past each row's length."""
        cfg = self.cfg
        B = phonemes.shape[0]
        c0, lengths = self.ar.generate(phonemes, prompt_codes[:, 0], max_new=max_new,
                                       generator=generator, temperature=temperature)
        c0 = torch.clamp_max(c0, cfg.codebook_size - 1)
        valid = torch.arange(max_new, device=c0.device)[None, :] < lengths[:, None]
        codes = torch.zeros((B, cfg.n_codebooks, max_new), dtype=torch.int64,
                            device=c0.device)
        codes[:, 0] = c0 * valid
        for j in range(1, cfg.n_codebooks):
            logits = self.nar(phonemes, codes, j, code_valid=valid)
            codes[:, j] = logits.argmax(-1) * valid
        return codes, lengths


def init_vallex(cfg: VALLEXConfig, generator: torch.Generator = None,
                device="cuda") -> VALLEX:
    """A ``VALLEX`` with random weights from ``generator`` (``init_weights``:
    the JAX initialisers), drawn on the generator's device (one on
    ``device`` seeded 0 when None), on ``device`` in eval mode."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = VALLEX(cfg).to(generator.device)
    init_weights(model, generator)
    return model.to(dev).eval()
