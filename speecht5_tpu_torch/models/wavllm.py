"""WavLLM: a Whisper + WavLM dual speech encoder into a LLaMA decoder with
LoRA or LoRA-MoE adapters.

Port of ``speecht5_tpu/models/wavllm.py`` (reference WavLLM/wavllm/models/
speechllm_model.py:43-91 the GLU conv subsampler, :183-214 the dual
encoders summed with ``wavlm_output_weight``; whisper_encoder.py; llama.py
:169-345 RMSNorm, interleaved RoPE, LoRA on wq/wk/wv/wo with scaling
alpha / r, the KV-cached decode, the SwiGLU FFN; :147-149 LoRA-MoE):

- ``WhisperStyleEncoder``: two convs with GELU, the learned position table
  (initialised from the espnet sinusoids), pre-LN ``EncoderLayer``s without
  relative positions (plain attention, as JAX computes it outside any
  kernel), a final LayerNorm at flax's epsilon 1e-6;
- ``models/wavlm.WavLMEncoderModel`` (its attention on the
  ``flash_attention_bias`` kernel with ``wavlm.use_pallas_attn``, its
  extractor's layers 1.. on the conv-stack kernel with ``wavlm.conv.impl
  = "pallas"``);
- ``LLaMABlock``: the prefill and ``forward_sft`` (many queries, causal by
  slot, masked by validity) on the plain route, as in JAX; with
  ``cfg.use_pallas_attn`` one query against the KV cache (a decode step)
  runs ``cuda_kernels.flash_attention_bias_cached`` on the cache ``[B,
  Lmax, H, Dh]`` where it lies, q scaled by Dh^-0.5, the step's key mask
  ``[B, Lmax]`` (valid and causal) and the beam's ancestry map ``rows``;
- ``WavLLMModel``: ``encode_audio``, the packing ``[left? | audio |
  prompt | target]``, ``forward_sft``, greedy ``generate`` and
  ``generate_beam``.  RoPE positions count real tokens (``cumsum(valid) -
  1``), causal masking uses slots.  The beam reorders its lanes through
  an ancestry map that the cached step reads (JAX gathers every cache
  tensor each step: the same tokens and scores); top-k ties go to the
  lower index, as ``jax.lax.top_k``.

Parameters live in f32 unless ``init_wavllm`` is asked for another dtype
(the matrices of the frozen parts only); every layer casts to its compute
dtype as flax's ``dtype`` does.  Submodule names follow the JAX tree
(``llama_layers_<i>`` -> ``llama_layers.<i>``), so
``utils/convert.wavllm_from_jax_params`` carries its weights.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch import nn

from ..config import RelPosConfig, TransformerConfig
from ..ops import cuda_kernels
from ..ops.positional import espnet_sinusoidal_table
from ..utils.device import resolve_device
from ..utils.masks import length_mask
from .common import Dense, LayerNorm32
from .layers import EncoderLayer
from .wavlm import WavLMConfig, WavLMEncoderModel, wavlm_tiny

NEG_INF = -1e9


@dataclass(frozen=True)
class WavLLMConfig:
    # whisper-style encoder
    n_mels: int = 80
    whisper_d: int = 1280
    whisper_layers: int = 32
    whisper_heads: int = 20
    whisper_ffn: int = 5120
    max_source_positions: int = 1500   # whisper learned-position table length
    # wavlm encoder (the released checkpoint topology, models/wavlm.py)
    use_wavlm: bool = True
    wavlm: WavLMConfig = field(default_factory=WavLMConfig)
    wavlm_output_weight: float = 0.5
    # llama decoder
    vocab_size: int = 32000
    llama_dim: int = 4096
    llama_layers: int = 32
    llama_heads: int = 32
    llama_ffn: int = 11008
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    # adapters
    adapter_mid: int = 512
    # lora
    lora_r: int = 8
    lora_alpha: int = 32
    lora_dropout: float = 0.1
    lora_moe: bool = False
    n_experts: int = 3
    # ids
    pad_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    dtype: str = "float32"
    # the port's route flag: the LLaMA decode step's attention through the
    # CUDA kernel ``flash_attention_bias_cached`` (the JAX module runs XLA)
    use_pallas_attn: bool = False

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def wavllm_tiny(**kw) -> WavLLMConfig:
    cfg = WavLLMConfig(
        n_mels=20, whisper_d=32, whisper_layers=2, whisper_heads=4,
        whisper_ffn=64, max_source_positions=64,
        wavlm=wavlm_tiny(),
        vocab_size=48, llama_dim=32, llama_layers=2, llama_heads=4,
        llama_ffn=64, max_seq_len=128, adapter_mid=32, lora_r=4,
        lora_alpha=8, lora_dropout=0.0,
    )
    return dataclasses.replace(cfg, **kw)


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + 1e-6) * weight in f32, back in x's dtype (the
    epsilon JAX hard-codes, wavllm.py:97)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + 1e-6)
        return (y * self.weight.float()).to(x.dtype)


@functools.lru_cache(maxsize=8)
def rope_tables(head_dim: int, max_len: int, theta: float):
    """(cos, sin) f32 [max_len, head_dim / 2], computed in f32 as JAX does
    (wavllm.py:101-105)."""
    freqs = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim))
    ang = torch.outer(torch.arange(max_len, dtype=torch.float32), freqs)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin, positions):
    """x [B, T, H, Dh]; positions int [B, T] -> x rotated by interleaved
    pairs (x[..., 0::2], x[..., 1::2]), llama's view_as_complex."""
    c = cos[positions][:, :, None, :]
    s = sin[positions][:, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


class _Linear(nn.Linear):
    """Bias-free ``nn.Linear`` computing in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32):
        super().__init__(in_features, out_features, bias=False)
        self.compute_dtype = dtype

    def forward(self, x):
        return F.linear(x.to(self.compute_dtype), self.weight.to(self.compute_dtype))


class _Conv1d(nn.Conv1d):
    """flax ``nn.Conv`` with explicit padding over channels-last [B, T, C],
    computed in ``dtype``."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1, padding: int = 0,
                 dtype=torch.float32):
        super().__init__(c_in, c_out, k, stride=stride, padding=padding)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        y = F.conv1d(x.to(dt).transpose(1, 2), self.weight.to(dt), self.bias.to(dt),
                     self.stride, self.padding)
        return y.transpose(1, 2)


class LoRALinear(nn.Module):
    """y = x W + (dropout(x) A B) * alpha / r, the low-rank update in f32
    (reference llama.py:212-276; JAX wavllm.py:120-171).  With
    ``n_experts`` > 0 the update mixes expert (A, B) pairs by each
    example's gate (LoRA-MoE).  ``weight`` [out, in] (torch layout);
    ``lora_A`` [in, r] / [E, in, r] and ``lora_B`` [r, out] / [E, r, out]
    keep the JAX layout."""

    def __init__(self, d_in: int, features: int, r: int, alpha: float,
                 dropout: float = 0.0, n_experts: int = 0):
        super().__init__()
        self.r, self.dropout, self.n_experts = r, dropout, n_experts
        self.scale = alpha / r if r > 0 else 0.0
        self.weight = nn.Parameter(torch.empty(features, d_in))
        if r > 0:
            lead = (n_experts,) if n_experts > 0 else ()
            self.lora_A = nn.Parameter(torch.empty(*lead, d_in, r))
            self.lora_B = nn.Parameter(torch.zeros(*lead, r, features))

    def forward(self, x, gate=None):
        y = F.linear(x, self.weight.to(x.dtype))
        if self.r <= 0:
            return y
        xd = F.dropout(x, self.dropout, self.training).float()
        A, B = self.lora_A.float(), self.lora_B.float()
        if self.n_experts > 0:
            up = torch.einsum("bter,erf->betf", torch.einsum("btd,edr->bter", xd, A), B)
            up = torch.einsum("betf,be->btf", up, gate.float())
        else:
            up = (xd @ A) @ B
        return y + (self.scale * up).to(y.dtype)


class LLaMABlock(nn.Module):
    def __init__(self, cfg: WavLLMConfig, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        D = cfg.llama_dim
        n_exp = cfg.n_experts if cfg.lora_moe else 0
        lora = lambda: LoRALinear(D, D, cfg.lora_r, cfg.lora_alpha, cfg.lora_dropout, n_exp)
        self.wq, self.wk, self.wv, self.wo = lora(), lora(), lora(), lora()
        self.attention_norm = RMSNorm(D)
        self.ffn_norm = RMSNorm(D)
        self.w1 = _Linear(D, cfg.llama_ffn, dtype)
        self.w3 = _Linear(D, cfg.llama_ffn, dtype)
        self.w2 = _Linear(cfg.llama_ffn, D, dtype)

    def kernel_route(self) -> bool:
        """Whether a decode step's attention takes the kernel (forward-only)."""
        return self.cfg.use_pallas_attn and not self.training

    def forward(self, x, cos, sin, positions, allowed, *, gate=None, cache=None,
                cache_index: int = 0, cache_rows=None):
        """x [B, T, D]; ``positions`` int [B, T] drive RoPE (real-token
        counts).  Without a cache (``forward_sft``) or for a prefill
        (T > 1, the cache written at ``cache_index``): ``allowed`` bool [B,
        T, T], causal by slot and valid, over the step's own keys.  A decode
        step (T == 1 with a cache): ``allowed`` bool [B, Lmax] over the
        cache, read through ``cache_rows`` (int64 [B, Lmax]) when given.
        ``cache`` {"k", "v": [B, Lmax, H, Dh]} is written in place."""
        cfg = self.cfg
        B, T, _ = x.shape
        H = cfg.llama_heads
        Dh = cfg.llama_dim // H
        h = self.attention_norm(x)
        q = apply_rope(self.wq(h, gate).view(B, T, H, Dh), cos, sin, positions)
        k = apply_rope(self.wk(h, gate).view(B, T, H, Dh), cos, sin, positions)
        v = self.wv(h, gate).view(B, T, H, Dh)
        if cache is not None:
            cache["k"][:, cache_index : cache_index + T] = k.to(cache["k"].dtype)
            cache["v"][:, cache_index : cache_index + T] = v.to(cache["v"].dtype)
        if cache is None or T > 1:
            o = self._attend(q, k, v, allowed)
        elif self.kernel_route():
            o = cuda_kernels.flash_attention_bias_cached(q * (Dh ** -0.5), cache["k"],
                                                         cache["v"], allowed, cache_rows)
        else:
            k, v = cache["k"], cache["v"]
            if cache_rows is not None:
                # the ancestry view: one gather of (row, position) pairs
                Tc = k.shape[1]
                flat = (cache_rows * Tc + torch.arange(Tc, device=x.device)[None, :]).reshape(-1)
                k = k.reshape(B * Tc, H, Dh)[flat].view(B, Tc, H, Dh)
                v = v.reshape(B * Tc, H, Dh)[flat].view(B, Tc, H, Dh)
            o = self._attend(q, k.to(q.dtype), v, allowed[:, None, :])
        x = x + self.wo(o.reshape(B, T, cfg.llama_dim), gate)
        h = self.ffn_norm(x)
        return x + self.w2(F.silu(self.w1(h)) * self.w3(h))

    def _attend(self, q, k, v, allowed):
        """The plain route (JAX wavllm.py:228-238): q.k in the compute dtype,
        f32 logits / sqrt(Dh), -1e9 where not ``allowed`` ([B, Tq, Tk]),
        f32 softmax, probabilities in the compute dtype, times V."""
        Dh = q.shape[-1]
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(Dh)
        logits = torch.where(allowed[:, None], logits,
                             torch.full((), NEG_INF, device=q.device))
        w = torch.softmax(logits, dim=-1).to(self.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", w, v.to(self.dtype))


class WhisperStyleEncoder(nn.Module):
    """HF Whisper encoder topology (JAX wavllm.py:247-287): conv1 (k 3, pad
    1) and conv2 (k 3, pad 1, stride 2) with GELU, the learned positions,
    pre-LN layers, the final LayerNorm (flax's epsilon 1e-6)."""

    def __init__(self, cfg: WavLLMConfig, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        d = cfg.whisper_d
        self.conv1 = _Conv1d(cfg.n_mels, d, 3, padding=1, dtype=dtype)
        self.conv2 = _Conv1d(d, d, 3, stride=2, padding=1, dtype=dtype)
        self.embed_positions = nn.Parameter(torch.from_numpy(
            espnet_sinusoidal_table(cfg.max_source_positions, d).copy()))
        lcfg = TransformerConfig(
            d_model=d, ffn_dim=cfg.whisper_ffn, num_heads=cfg.whisper_heads,
            dropout=0.0, attention_dropout=0.0, layer_norm_first=True,
            rel_pos=RelPosConfig(enabled=False), use_rel_pos_bias=False)
        self.layers = nn.ModuleList(EncoderLayer(lcfg, dtype)
                                    for _ in range(cfg.whisper_layers))
        self.layer_norm = LayerNorm32(d, eps=1e-6)

    def forward(self, mel, mel_lengths):
        """mel [B, T, n_mels], mel_lengths [B] -> (x [B, ceil(T / 2), d],
        out_lengths [B])."""
        x = F.gelu(self.conv1(mel))
        x = F.gelu(self.conv2(x))
        T = x.shape[1]
        x = x + self.embed_positions[:T].to(x.dtype)
        out_lengths = (mel_lengths + 1) // 2
        valid = length_mask(out_lengths.to(x.device), T)
        for layer in self.layers:
            x = layer(x, valid)
        return self.layer_norm(x).to(self.dtype), out_lengths


class Conv1dSubsampler(nn.Module):
    """Two stride-2 convs (k 3, padding (1, 1)), each followed by a GLU over
    the channels (reference speechllm_model.py:43-91)."""

    def __init__(self, c_in: int, mid: int, out: int, dtype=torch.float32):
        super().__init__()
        self.conv_0 = _Conv1d(c_in, mid * 2, 3, stride=2, padding=1, dtype=dtype)
        self.conv_1 = _Conv1d(mid, out * 2, 3, stride=2, padding=1, dtype=dtype)

    def forward(self, x, lengths):
        for conv in (self.conv_0, self.conv_1):
            x = F.glu(conv(x), dim=-1)
            lengths = (lengths + 1) // 2
        return x, lengths


def _top_k(x, k: int):
    """Top-k of the last axis, ties to the lower index (``jax.lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class WavLLMModel(nn.Module):
    def __init__(self, cfg: WavLLMConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype
        D = cfg.llama_dim
        self.whisper = WhisperStyleEncoder(cfg, dt)
        self.whisper_adapter = Conv1dSubsampler(cfg.whisper_d, cfg.adapter_mid, D, dt)
        self.audio_proj = Dense(D, D, dt)
        if cfg.use_wavlm:
            self.wavlm = WavLMEncoderModel(cfg.wavlm, dt)
            self.wavlm_adapter = Conv1dSubsampler(cfg.wavlm.hidden_size, cfg.adapter_mid, D, dt)
            self.wavlm_audio_proj = Dense(D, D, dt)
        self.tok_embeddings = nn.Embedding(cfg.vocab_size, D)
        self.llama_layers = nn.ModuleList(LLaMABlock(cfg, dt) for _ in range(cfg.llama_layers))
        self.norm = RMSNorm(D)
        self.output = nn.Linear(D, cfg.vocab_size, bias=False)          # f32
        if cfg.lora_moe:
            self.moe_gate = nn.Linear(D, cfg.n_experts)                  # f32
        self._rope = {}

    def rope(self, device):
        if device not in self._rope:
            cfg = self.cfg
            self._rope[device] = tuple(t.to(device) for t in rope_tables(
                cfg.llama_dim // cfg.llama_heads, cfg.max_seq_len, cfg.rope_theta))
        return self._rope[device]

    def _embed(self, tokens, dtype):
        return self.tok_embeddings(tokens).to(dtype)

    def _check_positions(self, last: int):
        """RoPE reads row ``last`` of a ``max_seq_len`` table: refuse a
        sequence past it (JAX's gather clamps the index, silently)."""
        if last >= self.cfg.max_seq_len:
            raise ValueError(f"RoPE position {last} past the table of max_seq_len="
                             f"{self.cfg.max_seq_len}")

    # --------------------------------------------------------------- audio

    def encode_audio(self, mel, mel_lengths, wav=None, wav_lengths=None):
        """Dual-encoder audio features in LLaMA space (JAX wavllm.py:350-367):
        the Whisper branch plus ``wavlm_output_weight`` x the WavLM branch,
        trimmed to the shorter -> (feats [B, La, D], lengths [B])."""
        cfg = self.cfg
        x, lens = self.whisper(mel, mel_lengths)
        x, lens = self.whisper_adapter(x, lens)
        feats = self.audio_proj(x)
        lens = lens.to(feats.device)
        if cfg.use_wavlm and wav is not None:
            w, _ = self.wavlm(wav, wav_lengths)
            wl = cfg.wavlm.conv.out_length(wav_lengths).to(feats.device)
            w, wl = self.wavlm_adapter(w, wl)
            w = self.wavlm_audio_proj(w)
            T = min(feats.shape[1], w.shape[1])
            feats = feats[:, :T] + cfg.wavlm_output_weight * w[:, :T]
            lens = torch.minimum(lens, wl)
        return feats, torch.clamp(lens, max=feats.shape[1])

    # ----------------------------------------------------------------- SFT

    def _llama(self, x, positions, allowed, *, caches=None, cache_index: int = 0,
               gate=None, cache_rows=None):
        """The LLaMA trunk -> the hidden states [B, T, D] before ``norm``."""
        cos, sin = self.rope(x.device)
        for i, layer in enumerate(self.llama_layers):
            x = layer(x, cos, sin, positions, allowed, gate=gate,
                      cache=None if caches is None else caches[i],
                      cache_index=cache_index, cache_rows=cache_rows)
        return x

    def logits(self, h):
        """Hidden states -> f32 logits (``norm``, then ``output`` in f32)."""
        return F.linear(self.norm(h).float(), self.output.weight.float())

    @staticmethod
    def _causal(valid):
        """bool [B, T, T]: key j visible from slot i iff j <= i and j is valid."""
        T = valid.shape[1]
        slots = torch.arange(T, device=valid.device)
        return (slots[None, :] <= slots[:, None])[None] & valid[:, None, :]

    def _pack_prefix(self, audio, audio_lens, prompt_tokens, left_tokens=None):
        """[left? | audio | prompt] (JAX wavllm.py:387-416) -> (seq, valid,
        first_idx): first_idx[b] is the slot whose logits predict the first
        target token, the last real prompt token, or with an empty prompt
        the last real audio frame."""
        cfg = self.cfg
        segs, valids = [], []
        Ll = 0
        if left_tokens is not None:
            segs.append(self._embed(left_tokens, audio.dtype))
            valids.append(left_tokens != cfg.pad_id)
            Ll = left_tokens.shape[1]
        La = audio.shape[1]
        segs.append(audio)
        valids.append(length_mask(audio_lens, La))
        segs.append(self._embed(prompt_tokens, audio.dtype))
        valids.append(prompt_tokens != cfg.pad_id)
        seq = torch.cat(segs, dim=1)
        valid = torch.cat(valids, dim=1)
        n_prompt = (prompt_tokens != cfg.pad_id).sum(1)
        first_idx = torch.where(n_prompt > 0, Ll + La + n_prompt - 1,
                                Ll + torch.clamp(audio_lens, min=1) - 1)
        return seq, valid, first_idx

    def _moe_gate(self, audio, audio_lens):
        if not self.cfg.lora_moe:
            return None
        m = length_mask(audio_lens, audio.shape[1])[..., None]
        pooled = (audio * m).sum(1) / torch.clamp(audio_lens, min=1)[:, None].to(audio.dtype)
        return torch.softmax(F.linear(pooled.float(), self.moe_gate.weight.float(),
                                      self.moe_gate.bias.float()), dim=-1)

    def forward_sft(self, mel, mel_lengths, prompt_tokens, target_tokens, wav=None,
                    wav_lengths=None, left_tokens=None):
        """The packed [left? | audio | prompt | target] SFT forward (JAX
        wavllm.py:428-468) -> (f32 logits [B, Lt, V] predicting
        ``target_tokens``, the MoE gate or None).  Dropout follows
        ``self.training``."""
        cfg = self.cfg
        audio, audio_lens = self.encode_audio(mel, mel_lengths, wav, wav_lengths)
        prefix, prefix_valid, first_idx = self._pack_prefix(audio, audio_lens, prompt_tokens,
                                                            left_tokens)
        L0, Lt = prefix.shape[1], target_tokens.shape[1]
        seq = torch.cat([prefix, self._embed(target_tokens, audio.dtype)], dim=1)
        valid = torch.cat([prefix_valid, target_tokens != cfg.pad_id], dim=1)
        positions = torch.clamp(torch.cumsum(valid.long(), dim=1) - 1, min=0)
        self._check_positions(int(positions.max()))
        gate = self._moe_gate(audio, audio_lens)
        h = self._llama(seq, positions, self._causal(valid), gate=gate)
        # target token 0 from the last real prompt slot, tokens 1.. from the
        # target embeddings; the head runs on these rows only (it is
        # per-token)
        rows = torch.arange(seq.shape[0], device=seq.device)
        sel = torch.cat([h[rows, first_idx][:, None], h[:, L0 : L0 + Lt - 1]], dim=1)
        return self.logits(sel), gate

    # ------------------------------------------------------------ generate

    def _prefill(self, mel, mel_lengths, prompt_tokens, left_tokens, wav, wav_lengths,
                 max_new: int):
        """Encode, pack, run the prefix through the trunk writing the caches
        (max_new free slots each) -> (first_logits [B, V], caches, valid
        [B, L0 + max_new], n_real [B], gate, L0)."""
        cfg = self.cfg
        audio, audio_lens = self.encode_audio(mel, mel_lengths, wav, wav_lengths)
        B = audio.shape[0]
        seq, prefix_valid, first_idx = self._pack_prefix(audio, audio_lens, prompt_tokens,
                                                         left_tokens)
        L0 = seq.shape[1]
        gate = self._moe_gate(audio, audio_lens)
        H, Dh = cfg.llama_heads, cfg.llama_dim // cfg.llama_heads
        caches = [{"k": seq.new_zeros(B, L0 + max_new, H, Dh),
                   "v": seq.new_zeros(B, L0 + max_new, H, Dh)} for _ in self.llama_layers]
        valid = torch.cat([prefix_valid, prefix_valid.new_zeros(B, max_new)], dim=1)
        positions = torch.clamp(torch.cumsum(prefix_valid.long(), dim=1) - 1, min=0)
        # the last step's position: the real tokens plus max_new - 2
        self._check_positions(int(positions[:, -1].max()) + max_new - 1)
        h = self._llama(seq, positions, self._causal(prefix_valid), caches=caches,
                        cache_index=0, gate=gate)
        first_logits = self.logits(h[torch.arange(B, device=h.device), first_idx])
        return first_logits, caches, valid, prefix_valid.sum(1), gate, L0

    def _decode_step(self, tok, caches, valid, pos, cache_index: int, gate, cache_rows=None):
        """One decode step: tokens [B] at slot ``cache_index``, RoPE
        position ``pos`` [B] -> f32 logits [B, V].  The key mask is valid
        and causal at the slot."""
        x = self._embed(tok, self.cfg.compute_dtype)[:, None]
        slots = torch.arange(valid.shape[1], device=valid.device)
        allowed = (valid & (slots <= cache_index)[None]).contiguous()
        h = self._llama(x, pos[:, None], allowed, caches=caches, cache_index=cache_index,
                        gate=gate, cache_rows=cache_rows)
        return self.logits(h[:, -1])

    @torch.no_grad()
    def generate(self, mel, mel_lengths, prompt_tokens, *, max_new: int = 16, wav=None,
                 wav_lengths=None, left_tokens=None):
        """Greedy decode with the KV cache (JAX wavllm.py:512-544): prefill,
        then ``max_new`` - 1 steps -> tokens int64 [B, max_new]."""
        first_logits, caches, valid, n_real, gate, L0 = self._prefill(
            mel, mel_lengths, prompt_tokens, left_tokens, wav, wav_lengths, max_new)
        tok = first_logits.argmax(-1)
        out = tok.new_zeros(tok.shape[0], max_new)
        out[:, 0] = tok
        for t in range(max_new - 1):
            valid[:, L0 + t] = True
            tok = self._decode_step(tok, caches, valid, n_real + t, L0 + t, gate).argmax(-1)
            out[:, t + 1] = tok
        return out

    @torch.no_grad()
    def generate_beam(self, mel, mel_lengths, prompt_tokens, *, beam_size: int = 4,
                      max_new: int = 16, length_penalty: float = 1.0, wav=None,
                      wav_lengths=None, left_tokens=None):
        """Beam search over the LLaMA decoder (JAX wavllm.py:546-639): the
        prefill at batch B, B x beam cached lanes, the top K of beam x V each
        step (finished lanes extend with EOS at no cost), GNMT
        normalisation over the generated length -> (tokens int64 [B,
        max_new] of the best hypothesis, its f32 normalised score [B])."""
        cfg = self.cfg
        K = beam_size
        first_logits, caches, valid, n_real, gate, L0 = self._prefill(
            mel, mel_lengths, prompt_tokens, left_tokens, wav, wav_lengths, max_new)
        B, V = first_logits.shape
        dev = first_logits.device
        scores, tok = _top_k(torch.log_softmax(first_logits.float(), dim=-1), K)
        out = tok.new_zeros(B, K, max_new)
        out[:, :, 0] = tok
        finished = tok == cfg.eos_id
        tile = lambda t: t.repeat_interleave(K, dim=0)
        caches = [{"k": tile(c["k"]), "v": tile(c["v"])} for c in caches]
        valid, n_real = tile(valid), tile(n_real)
        gate = None if gate is None else tile(gate)
        N, Lmax = B * K, valid.shape[1]
        # the ancestry map: position j of lane r lives in physical row rows[r, j]
        own = torch.arange(N, device=dev)
        rows = own[:, None].expand(N, Lmax).contiguous()
        cols = torch.arange(Lmax, device=dev)[None, :]
        eos_only = torch.full((V,), NEG_INF, device=dev)
        eos_only[cfg.eos_id] = 0.0
        for t in range(1, max_new):
            p = L0 + t - 1          # consumes the token emitted at step t - 1
            valid[:, p] = True
            logits = self._decode_step(tok.reshape(N), caches, valid, n_real + t - 1, p,
                                       gate, cache_rows=rows)
            lp = torch.log_softmax(logits.float(), dim=-1).view(B, K, V)
            lp = torch.where(finished[:, :, None], eos_only, lp)
            scores, flat = _top_k((scores[:, :, None] + lp).view(B, K * V), K)
            origin, tok = flat // V, flat % V
            out = torch.gather(out, 1, origin[:, :, None].expand(B, K, max_new))
            out[:, :, t] = tok
            finished = torch.gather(finished, 1, origin) | (tok == cfg.eos_id)
            parent = (torch.arange(B, device=dev)[:, None] * K + origin).reshape(N)
            # a lane inherits its parent's map; its next writes are its own
            rows = torch.where(cols > p, own[:, None], rows[parent]).contiguous()
            valid = valid[parent]
        is_eos = out == cfg.eos_id
        first_eos = torch.argmax(is_eos.int(), dim=-1)
        length = torch.where(is_eos.any(-1), first_eos + 1, torch.full_like(first_eos, max_new))
        norm = scores / length.float() ** length_penalty
        best = torch.argmax(norm, dim=1)
        idx = torch.arange(B, device=dev)
        return out[idx, best], norm[idx, best]


def lora_param_filter(name: str) -> bool:
    """True for the parameters SFT trains (LoRA A/B, the MoE gate, the
    adapters and the audio projections; JAX wavllm.py:642-651): the
    reference freezes the LLaMA trunk and the audio encoders
    (speechllm_model.py:131-136)."""
    if "lora_A" in name or "lora_B" in name or "moe_gate" in name:
        return True
    return any(k in name for k in ("whisper_adapter", "wavlm_adapter", "audio_proj",
                                   "wavlm_audio_proj"))


def init_wavllm_weights(model: WavLLMModel, generator: torch.Generator, *,
                        lora_b_std: float = 0.0) -> WavLLMModel:
    """Random weights in place, drawn from ``generator`` (on the weights'
    device) in parameter order, after the JAX initialisers: he-uniform
    ``lora_A``, zero ``lora_B`` (normal(lora_b_std) when > 0: adapters as
    after fine-tuning), normal(fan_in^-0.5) matrices and conv kernels,
    zero biases, unit norm scales and gate constants, normal(0.02) bucket
    embeddings and weight-norm directions with unit magnitudes, Whisper's
    position table from the espnet sinusoids."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "lora_A":
                bound = math.sqrt(6.0 / p.shape[-2])
                p.uniform_(-bound, bound, generator=generator)
            elif leaf == "lora_B":
                if lora_b_std > 0:
                    p.normal_(0.0, lora_b_std, generator=generator)
                else:
                    p.zero_()
            elif leaf == "embed_positions":
                p.copy_(torch.from_numpy(espnet_sinusoidal_table(*p.shape)))
            elif leaf in ("rel_attn_embed", "weight_v"):
                p.normal_(0.0, 0.02, generator=generator)
            elif leaf in ("gru_rel_pos_const", "weight_g"):
                p.fill_(1.0)
            elif leaf == "bias":
                p.zero_()
            elif p.dim() == 1:
                p.fill_(1.0)
            else:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
    return model


def init_wavllm(cfg: WavLLMConfig, generator: torch.Generator = None, device="cuda", *,
                param_dtype=torch.float32, lora_b_std: float = 0.0) -> WavLLMModel:
    """A ``WavLLMModel`` with random weights from ``generator`` (made on
    ``device`` and seeded 0 when None), built in place on ``device`` (no
    host copy of the weights), in eval mode.  ``param_dtype`` stores the
    matrices and kernels of the frozen parts in that dtype (bf16: the
    released model's 6.7 B LLaMA parameters in 13.5 GB); the vectors and
    the parameters SFT trains (``lora_param_filter``) stay f32."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = WavLLMModel(cfg)
    if param_dtype != torch.float32:
        for name, p in model.named_parameters():
            if p.dim() >= 2 and not lora_param_filter(name):
                p.data = p.data.to(param_dtype)
    model.to_empty(device=dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return init_wavllm_weights(model, generator, lora_b_std=lora_b_std).eval()
