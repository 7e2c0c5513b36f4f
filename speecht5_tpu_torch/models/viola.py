"""VioLA: one decoder-only codec LM for ASR, MT and TTS (port of
``speecht5_tpu/models/viola.py``).

Every task is conditional language modelling over one shared token space:

    ASR : [<lang>][<asr>] semantic-units <sep> text            </s>
    MT  : [<lang>][<mt>]  text_src       <sep> text_tgt        </s>
    TTS : [<lang>][<tts>] text           <sep> acoustic-codes  </s>

(control ids, then text tokens from ``text0``, semantic units from
``unit0`` and codebook-0 codes from ``code0``).  The trunk is a pre-LN
``TransformerDecoder`` without cross-attention: scaled embeddings plus
fairseq sinusoids, tied output logits, the loss masked to the target
segment (``lm_loss``).  ``generate`` is greedy: one causal prefill of the
prefix into the KV cache (the decoder's dense branch), then a cached step
a token, each step's attention on the ``flash_attention_bias`` kernel when
``trunk.use_pallas_attn`` is on; ``pad_id`` never wins, ``allowed_range``
keeps one block of the space (and eos) at -1e9 elsewhere, and a finished
row emits ``pad_id``.  Codebooks 1..K-1 come from the port's
``VALLEX_NAR`` over the shared space (``nar_logits``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace as dc_replace
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..config import RelPosConfig, TransformerConfig
from ..ops.positional import fairseq_sinusoidal_table
from ..utils.device import resolve_device
from .common import init_weights
from .decoder import TransformerDecoder
from .vallex import STOP_CHECK_EVERY, VALLEX_NAR, VALLEXConfig, _stack

TASKS = ("asr", "mt", "tts")
NEG_INF = -1e9


@dataclass(frozen=True)
class VioLAConfig:
    text_vocab: int = 512
    unit_vocab: int = 1024            # semantic codec units (the ASR source)
    codebook_size: int = 1024         # acoustic codes per codebook
    n_codebooks: int = 8
    n_langs: int = 4
    trunk: TransformerConfig = field(default_factory=lambda: _stack(24))
    nar: TransformerConfig = field(default_factory=_stack)
    max_positions: int = 4096
    scale_embedding: bool = True
    dtype: str = "float32"
    pad_id: int = 1
    eos_id: int = 2
    sep_id: int = 3

    # the shared token space (static offsets)
    @property
    def task0(self) -> int:
        return 4

    @property
    def lang0(self) -> int:
        return self.task0 + len(TASKS)

    @property
    def n_special(self) -> int:
        return self.lang0 + self.n_langs

    @property
    def text0(self) -> int:
        return self.n_special

    @property
    def unit0(self) -> int:
        return self.text0 + self.text_vocab

    @property
    def code0(self) -> int:
        return self.unit0 + self.unit_vocab

    @property
    def total_vocab(self) -> int:
        return self.code0 + self.codebook_size

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def task_id(self, task: str) -> int:
        return self.task0 + TASKS.index(task)

    def lang_id(self, lang: int) -> int:
        return self.lang0 + lang


def viola_tiny(**kw) -> VioLAConfig:
    t = TransformerConfig(d_model=48, ffn_dim=96, num_layers=2, num_heads=4, dropout=0.0,
                          attention_dropout=0.0, layer_norm_first=True,
                          use_rel_pos_bias=False, rel_pos=RelPosConfig(enabled=False))
    return dc_replace(VioLAConfig(text_vocab=16, unit_vocab=12, codebook_size=12,
                                  n_codebooks=3, n_langs=2, trunk=t, nar=t,
                                  max_positions=128), **kw)


def build_example(cfg: VioLAConfig, task: str, lang: int, src: Sequence[int],
                  tgt: Sequence[int], max_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """One training row ``[<lang>][<task>] src <sep> tgt </s>`` padded to
    ``max_len`` -> (tokens int32 [max_len], target_mask bool [max_len]:
    the target segment and its closing eos, the tokens whose prediction
    the loss weighs).  ``src`` / ``tgt`` are ids of the shared space."""
    seq = ([cfg.lang_id(lang), cfg.task_id(task)] + list(src) + [cfg.sep_id] + list(tgt)
           + [cfg.eos_id])
    assert len(seq) <= max_len, (len(seq), max_len)
    tokens = np.full((max_len,), cfg.pad_id, np.int32)
    tokens[: len(seq)] = seq
    mask = np.zeros((max_len,), bool)
    sep_pos = 2 + len(src)
    mask[sep_pos + 1: sep_pos + 2 + len(tgt)] = True
    return tokens, mask


class VioLAModel(nn.Module):
    def __init__(self, cfg: VioLAConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = cfg.compute_dtype
        d = cfg.trunk.d_model
        self.embed_tokens = nn.Embedding(cfg.total_vocab, d)
        self.decoder = TransformerDecoder(cfg.trunk, self.dtype, cross_attention=False)
        self.nar = VALLEX_NAR(VALLEXConfig(
            phoneme_vocab=cfg.total_vocab, codebook_size=cfg.codebook_size,
            n_codebooks=cfg.n_codebooks, d_model=cfg.nar.d_model, nar=cfg.nar,
            pad_id=cfg.pad_id, max_len=cfg.max_positions, dtype=cfg.dtype))
        table = fairseq_sinusoidal_table(cfg.pad_id + 2 + cfg.max_positions, d, cfg.pad_id)
        self.register_buffer("positions", torch.from_numpy(table), persistent=False)
        self.steps_run = 0      # cached decode steps after the prefill, over every call

    def _embed(self, tokens, positions):
        scale = math.sqrt(self.cfg.trunk.d_model) if self.cfg.scale_embedding else 1.0
        x = self.embed_tokens(tokens.long()).to(self.dtype) * scale
        return x + self.positions[positions].to(self.dtype)

    def _logits(self, feats):
        return feats.float() @ self.embed_tokens.weight.float().t()

    def forward(self, tokens):
        """Teacher-forced: [B, L] -> f32 logits [B, L, V]; logits[:, t]
        predicts tokens[:, t + 1]."""
        valid = tokens != self.cfg.pad_id
        pos = self.cfg.pad_id + torch.cumsum(valid.long(), dim=-1) * valid
        feats = self.decoder(self._embed(tokens, pos), None, self_valid=valid, causal=True)
        return self._logits(feats)

    def lm_loss(self, tokens, target_mask):
        """Cross-entropy over the target segments (``build_example``'s
        mask), the mean over the weighed tokens."""
        logits = self(tokens)
        lp = torch.log_softmax(logits[:, :-1], dim=-1)
        nll = -torch.gather(lp, -1, tokens[:, 1:, None].long())[..., 0]
        w = target_mask[:, 1:].float()
        return (nll * w).sum() / torch.clamp_min(w.sum(), 1.0)

    def init_cache(self, batch_size: int, max_len: int):
        return self.decoder.init_cache(None, batch_size, max_len)

    def decode_step(self, tokens_t, cache, *, self_valid=None):
        """tokens_t [B, Tq] (the prefix, or one token) at positions from
        ``cache["index"]`` -> (f32 logits [B, V] of the last, new cache)."""
        Tq = tokens_t.shape[1]
        pos = (self.cfg.pad_id + 1 + cache["index"]
               + torch.arange(Tq, device=tokens_t.device)).expand(tokens_t.shape)
        feats, cache = self.decoder.decode_step(self._embed(tokens_t, pos), cache,
                                                self_valid=self_valid)
        return self._logits(feats[:, -1]), cache

    def _keep(self, eos: int, allowed_range, device):
        keep = torch.ones(self.cfg.total_vocab, dtype=torch.bool, device=device)
        if allowed_range is None:
            keep[self.cfg.pad_id] = False
        else:
            lo, hi = allowed_range
            keep[:] = False
            keep[lo:hi] = True
            keep[eos] = True
        return keep

    @torch.no_grad()
    def generate(self, prefix, *, max_new: int, eos_id: Optional[int] = None,
                 allowed_range: Optional[Tuple[int, int]] = None):
        """Greedy continuation of ``prefix`` [B, Lp] -> (tokens [B, max_new]
        int64, lengths [B] int64: the step a row emitted eos, max_new if it
        never did; the slots after it hold ``pad_id``).  A right-padded row
        continues after its pads, as in JAX (ROADMAP C.2)."""
        cfg = self.cfg
        eos = cfg.eos_id if eos_id is None else eos_id
        B, Lp = prefix.shape
        dev = prefix.device
        if Lp + max_new - 2 > cfg.max_positions:     # the last step's position
            raise ValueError(f"{Lp} + {max_new} tokens; the trunk has "
                             f"{cfg.max_positions} positions")
        cache = self.init_cache(B, Lp + max_new)
        self_valid = torch.cat([prefix != cfg.pad_id,
                                torch.ones((B, max_new), dtype=torch.bool, device=dev)], 1)
        keep = self._keep(eos, allowed_range, dev)
        pick = lambda logits: torch.where(keep, logits, NEG_INF).argmax(-1)
        logits, cache = self.decode_step(prefix, cache, self_valid=self_valid)
        tok = pick(logits)
        out = torch.full((B, max_new), cfg.pad_id, dtype=torch.int64, device=dev)
        out[:, 0] = tok
        done = tok == eos
        lengths = torch.where(done, 0, max_new)
        for i in range(1, max_new):
            # once every row is done, the rest of each row is pad_id
            if (i - 1) % STOP_CHECK_EVERY == 0 and bool(done.all()):
                break
            logits, cache = self.decode_step(out[:, i - 1: i], cache, self_valid=self_valid)
            self.steps_run += 1
            tok = torch.where(done, cfg.pad_id, pick(logits))
            newly = ~done & (tok == eos)
            lengths = torch.where(newly, i, lengths)
            done = done | newly
            out[:, i] = tok
        return out, lengths

    def nar_logits(self, context_tokens, codes, stage: int, *, code_valid=None):
        """Codebook ``stage`` (in [1, n_codebooks)) from the task context
        and the codebooks below it; ``codes`` raw codebook ids [B,
        n_codebooks, T] -> f32 logits [B, T, codebook_size]."""
        return self.nar(context_tokens, codes, stage, code_valid=code_valid)


def init_viola(cfg: VioLAConfig, generator: torch.Generator = None,
               device="cuda") -> VioLAModel:
    """A ``VioLAModel`` with random weights from ``generator`` (``init_weights``:
    the JAX initialisers), drawn on the generator's device (one on
    ``device`` seeded 0 when None), on ``device`` in eval mode."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = VioLAModel(cfg).to(generator.device)
    init_weights(model, generator)
    return model.to(dev).eval()
