"""WavLM speech encoder at the released checkpoints' topology (gated,
bucketed relative positions).

Port of ``speecht5_tpu/models/wavlm.py`` (reference WavLLM/wavllm/models/
wavlm.py, used at speechllm_model.py:183; HF ``modeling_wavlm``): the
wav2vec2 conv feature extractor (``models/prenets.ConvFeatureExtractor``,
with a conv bias at Large), the feature projection, the weight-normed conv
positional embedding (``WeightNormConv1d``, k 128, groups 16) and
transformer layers whose self-attention adds a T5-style bucketed relative
position bias, gated per query position by the layer's own
``gru_rel_pos_linear`` and ``gru_rel_pos_const``.  Only layer 0 owns the
bucket embedding ``rel_attn_embed``; the ungated ``[H, T, T]`` bias goes
down the stack.  Base is post-LN ("group" feature norm), Large pre-LN
("stable layer norm", a LayerNorm after every conv, conv bias).

The attention's two routes: with ``cfg.use_pallas_attn`` on a pass that is
not training, ``cuda_kernels.flash_attention_bias`` (softmax(q.k + bias)
v, the keys masked, q scaled by the caller: the contract of the TPU
kernel ``flash_attention_bias``) on ``[B * H, T, Dh]`` rows, the f32 gated
bias ``[B * H, T, T]`` and one ``[B, T]`` mask row for each sample's H
heads; otherwise the plain einsum of the JAX module, probability dropout
on training passes (the kernel is forward-only).  Submodule names follow
the JAX tree, so ``utils/convert.wavllm_from_jax_params`` carries its
weights.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import ConvFeatureConfig
from ..ops import cuda_kernels
from ..utils.masks import length_mask
from .common import Dense, LayerNorm32
from .prenets import ConvFeatureExtractor, WeightNormConv1d

NEG_INF = -1e9


@dataclass(frozen=True)
class WavLMConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    conv: ConvFeatureConfig = field(default_factory=ConvFeatureConfig)
    num_buckets: int = 320
    max_bucket_distance: int = 800
    stable_layer_norm: bool = False     # True for Large (pre-LN)
    conv_pos: int = 128
    conv_pos_groups: int = 16
    layer_norm_eps: float = 1e-5
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.0
    dtype: str = "float32"
    # the port's route flag: inference self-attention through the CUDA
    # kernel ``flash_attention_bias`` (the JAX module always runs XLA)
    use_pallas_attn: bool = False

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def wavlm_base(**kw) -> WavLMConfig:
    return dataclasses.replace(WavLMConfig(), **kw)


def wavlm_large(**kw) -> WavLMConfig:
    cfg = WavLMConfig(
        hidden_size=1024, num_layers=24, num_heads=16, ffn_dim=4096,
        conv=ConvFeatureConfig(mode="layer_norm", bias=True),
        stable_layer_norm=True,
    )
    return dataclasses.replace(cfg, **kw)


def wavlm_tiny(**kw) -> WavLMConfig:
    cfg = WavLMConfig(
        hidden_size=32, num_layers=2, num_heads=4, ffn_dim=48,
        conv=ConvFeatureConfig(layers=((16, 10, 5), (16, 3, 2), (16, 2, 2))),
        num_buckets=16, max_bucket_distance=40,
        conv_pos=16, conv_pos_groups=4,
        dropout=0.0, attention_dropout=0.0,
    )
    return dataclasses.replace(cfg, **kw)


@functools.lru_cache(maxsize=16)
def _buckets_numpy(T: int, num_buckets: int, max_distance: int) -> np.ndarray:
    ctx = np.arange(T)[:, None]
    mem = np.arange(T)[None, :]
    rel = mem - ctx
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    is_small = rel < max_exact
    # float64, as the JAX package's numpy: a float32 log moves the bucket
    # boundaries
    with np.errstate(divide="ignore"):
        large = np.log(np.maximum(rel, 1).astype(np.float64) / max_exact)
    large = large / np.log(max_distance / max_exact) * (nb - max_exact)
    large = (max_exact + large).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return buckets + np.where(is_small, rel, large)


def relative_position_buckets(T: int, num_buckets: int, max_distance: int,
                              device=None) -> torch.Tensor:
    """T5-style log bucketing of the relative positions (HF WavLMAttention.
    _relative_positions_bucket; JAX wavlm.py:84-101) -> int64 [T, T]."""
    b = torch.from_numpy(_buckets_numpy(T, num_buckets, max_distance))
    return b if device is None else b.to(device)


class WavLMAttention(nn.Module):
    """Self-attention with the GRU-gated bucketed relative position bias
    (JAX wavlm.py:104-166)."""

    def __init__(self, cfg: WavLMConfig, has_relative_position_bias: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        D, H = cfg.hidden_size, cfg.num_heads
        if has_relative_position_bias:
            self.rel_attn_embed = nn.Parameter(torch.empty(cfg.num_buckets, H))
        self.gru_rel_pos_linear = nn.Linear(D // H, 8)          # f32, shared by the heads
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, H, 1, 1))
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            Dense(D, D, dtype) for _ in range(4))

    def kernel_route(self) -> bool:
        return self.cfg.use_pallas_attn and not self.training

    def forward(self, x, key_valid=None, position_bias=None):
        """x [B, T, D]; key_valid bool [B, T] or None; position_bias the
        ungated f32 [H, T, T] of layer 0 (None: this layer builds it) ->
        (out [B, T, D], position_bias)."""
        cfg = self.cfg
        B, T, D = x.shape
        H = cfg.num_heads
        Dh = D // H
        if position_bias is None:
            buckets = relative_position_buckets(T, cfg.num_buckets, cfg.max_bucket_distance,
                                                x.device)
            position_bias = self.rel_attn_embed.float()[buckets].permute(2, 0, 1)   # [H, T, T]
        # the gate: one scalar per (b, h, t) from the pre-projection input
        gated = x.reshape(B, T, H, Dh).transpose(1, 2).float()
        proj = F.linear(gated, self.gru_rel_pos_linear.weight.float(),
                        self.gru_rel_pos_linear.bias.float())
        gate_a, gate_b = torch.sigmoid(proj.view(B, H, T, 2, 4).sum(-1)).chunk(2, dim=-1)
        gate = gate_a * (gate_b * self.gru_rel_pos_const.float() - 1.0) + 2.0   # [B, H, T, 1]
        gated_bias = gate * position_bias[None].float()                        # [B, H, T, T]

        q = self.q_proj(x).view(B, T, H, Dh) * (Dh ** -0.5)
        k = self.k_proj(x).view(B, T, H, Dh)
        v = self.v_proj(x).view(B, T, H, Dh)
        if self.kernel_route():
            rows = lambda t: t.transpose(1, 2).reshape(B * H, T, Dh).contiguous()
            mask = None if key_valid is None else key_valid.contiguous()
            o = cuda_kernels.flash_attention_bias(rows(q), rows(k), rows(v),
                                                  gated_bias.reshape(B * H, T, T), mask)
            o = o.view(B, H, T, Dh).transpose(1, 2)
        else:
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() + gated_bias
            if key_valid is not None:
                logits = torch.where(key_valid[:, None, None, :], logits,
                                     torch.full((), NEG_INF, device=x.device))
            probs = torch.softmax(logits, dim=-1).to(self.dtype)
            probs = F.dropout(probs, cfg.attention_dropout, self.training)
            o = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(self.dtype))
        return self.out_proj(o.reshape(B, T, D)), position_bias


class WavLMFeedForward(nn.Module):
    def __init__(self, cfg: WavLMConfig, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.intermediate_dense = Dense(cfg.hidden_size, cfg.ffn_dim, dtype)
        self.output_dense = Dense(cfg.ffn_dim, cfg.hidden_size, dtype)

    def forward(self, x):
        x = F.gelu(self.intermediate_dense(x))      # exact (erf) GELU
        x = F.dropout(x, self.cfg.activation_dropout, self.training)
        return F.dropout(self.output_dense(x), self.cfg.dropout, self.training)


class WavLMEncoderLayer(nn.Module):
    """Post-LN (Base) or pre-LN (Large, ``stable_layer_norm``), JAX
    wavlm.py:184-221."""

    def __init__(self, cfg: WavLMConfig, has_relative_position_bias: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.attention = WavLMAttention(cfg, has_relative_position_bias, dtype)
        self.layer_norm = LayerNorm32(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.final_layer_norm = LayerNorm32(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.feed_forward = WavLMFeedForward(cfg, dtype)

    def forward(self, x, key_valid=None, position_bias=None):
        drop = lambda y: F.dropout(y, self.cfg.dropout, self.training)
        dt = self.dtype
        if self.cfg.stable_layer_norm:
            y, position_bias = self.attention(self.layer_norm(x).to(dt), key_valid,
                                              position_bias)
            x = x + drop(y)
            x = x + self.feed_forward(self.final_layer_norm(x).to(dt))
        else:
            y, position_bias = self.attention(x, key_valid, position_bias)
            x = self.layer_norm(x + drop(y)).to(dt)
            x = x + self.feed_forward(x)
            x = self.final_layer_norm(x).to(dt)
        return x, position_bias


class WavLMEncoderModel(nn.Module):
    """waveform -> frame representations [B, T', hidden] (HF WavLMModel;
    JAX wavlm.py:224-291)."""

    def __init__(self, cfg: WavLMConfig, dtype=None):
        super().__init__()
        self.cfg = cfg
        dt = dtype or cfg.compute_dtype
        self.dtype = dt
        c_out = cfg.conv.out_dim
        self.feature_extractor = ConvFeatureExtractor(cfg.conv, dt)
        self.fp_layer_norm = LayerNorm32(c_out, eps=cfg.layer_norm_eps)
        self.fp_projection = Dense(c_out, cfg.hidden_size, dt)
        self.pos_conv = WeightNormConv1d(cfg.hidden_size, cfg.conv_pos, cfg.conv_pos_groups, dt)
        self.encoder_layer_norm = LayerNorm32(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(
            WavLMEncoderLayer(cfg, has_relative_position_bias=(i == 0), dtype=dt)
            for i in range(cfg.num_layers))

    def forward(self, wav, wav_lengths=None):
        """wav [B, T] raw 16 kHz; wav_lengths [B] or None -> (features [B,
        T', hidden] in the compute dtype, valid bool [B, T'])."""
        cfg = self.cfg
        dt = self.dtype
        feats = self.feature_extractor(wav)
        T = feats.shape[1]
        if wav_lengths is not None:
            valid = length_mask(cfg.conv.out_length(wav_lengths).to(feats.device), T)
        else:
            valid = torch.ones(wav.shape[0], T, dtype=torch.bool, device=feats.device)
        x = self.fp_projection(self.fp_layer_norm(feats).to(dt))
        x = F.dropout(x, cfg.dropout, self.training)
        # padded frames are zeroed before the positional conv (HF WavLMEncoder)
        x = torch.where(valid[:, :, None], x, torch.zeros((), dtype=x.dtype, device=x.device))
        x = x + F.gelu(self.pos_conv(x))
        if not cfg.stable_layer_norm:
            x = self.encoder_layer_norm(x).to(dt)
        x = F.dropout(x, cfg.dropout, self.training)
        position_bias = None
        for layer in self.layers:
            x, position_bias = layer(x, valid, position_bias)
        if cfg.stable_layer_norm:
            x = self.encoder_layer_norm(x).to(dt)
        return x, valid
