"""Multi-head attention with the SpeechT5 relative-position bias.

Port of ``speecht5_tpu/models/attention.py`` (reference
modules/multihead_attention.py:24-522): q is scaled by head_dim**-0.5
before use; the relative-position bias is the first-order term
B[b,h,i,j] = q_scaled[b,h,i,:] . pe_k[clip(i-j)] (reference :343-353);
masks use -1e9, not -inf, so a fully masked row gives a uniform softmax.
Self-attention (encoder, causal decoder) and cross-attention against the
encoder output are ported with probability dropout on the training path,
and the attention weights (the f32 softmax before dropout, JAX
attention.py:305-316) on request; the KV cache, ``cache_rows`` and
``precompute_kv`` arrive with the beam slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import cuda_kernels
from .common import Dense

NEG_INF = -1e9
# the fused kernels keep a whole score row on chip; longer sequences take
# the plain path, the JAX module's own routing rule (attention.py:236)
MAX_FUSED_KEYS = 1024


def rel_position_index(q_pos, k_pos, max_dist: int):
    """clip(i - j, -max_dist, max_dist - 1) + max_dist -> index into the pe table."""
    rel = q_pos[..., :, None] - k_pos[..., None, :]
    return torch.clamp(rel, -max_dist, max_dist - 1) + max_dist


def band_from_table(pos_table, T: int, max_dist: int):
    """pe_band[d, i, j] = pos_table[clip(i-j, -M, M-1) + M, d] -> [Dh, T, T].

    Built once per encoder forward and shared by every layer and head of the
    post-LN stack (the reference applies norm_k to the table only on the
    pre-LN path, transformer_layer.py:90-93).  The JAX package realises the
    same band with a gather-free skew (``_skew_band``); here it is one
    gather."""
    pos = torch.arange(T, device=pos_table.device)
    idx = rel_position_index(pos, pos, max_dist)          # [T, T]
    return pos_table.t()[:, idx]                           # [Dh, T, T]


def relative_bias_banded(q, pos_band):
    """q: [B, Tq, H, Dh] (scaled); pos_band: [Dh, T, T] -> bias [B, H, Tq, Tk]."""
    return torch.einsum("bqhd,dqk->bhqk", q, pos_band.to(q.dtype))


class MultiheadAttention(nn.Module):
    """Projections + attention.  ``use_pallas`` routes inference passes of
    full self-attention with a band to the CUDA inference kernel and
    ``use_pallas_train`` training passes to the differentiable train kernel,
    as ``config.use_pallas_attn`` / ``use_pallas_attn_train`` do in the JAX
    package; everything else takes the plain path."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0, *,
                 dtype=torch.float32, use_pallas: bool = False,
                 use_pallas_train: bool = False, scores_f32: bool = True):
        super().__init__()
        self.d_model = d_model
        self.num_heads = num_heads
        self.dropout = dropout
        self.dtype = dtype
        self.use_pallas = use_pallas
        self.use_pallas_train = use_pallas_train
        self.scores_f32 = scores_f32
        self.q_proj = Dense(d_model, d_model, dtype)
        self.k_proj = Dense(d_model, d_model, dtype)
        self.v_proj = Dense(d_model, d_model, dtype)
        self.out_proj = Dense(d_model, d_model, dtype)

    @property
    def head_dim(self):
        return self.d_model // self.num_heads

    def forward(self, x, key_valid=None, pos_band=None, *, x_kv=None,
                causal: bool = False, generator=None,
                return_weights: bool = False):
        """x: [B, Tq, D]; key_valid: bool [B, Tk] (True = attend, a
        contiguous prefix); pos_band: [Dh, T, T] or None; x_kv: [B, Tk, D]
        for cross-attention (None = self-attention); causal: mask keys after
        the query.  ``generator``: CPU ``torch.Generator`` for the train
        kernel's dropout seed (the default CPU generator when None), so the
        seed costs no device sync.  -> [B, Tq, D], or with
        ``return_weights`` (out, f32 weights [B, H, Tq, Tk]), which the
        fused kernels do not give (JAX routes such calls to the plain path
        too)."""
        B, Tq, _ = x.shape
        H, Dh = self.num_heads, self.head_dim
        src = x if x_kv is None else x_kv
        q = self.q_proj(x).view(B, Tq, H, Dh) * (Dh ** -0.5)
        k = self.k_proj(src).view(B, -1, H, Dh)
        v = self.v_proj(src).view(B, -1, H, Dh)
        Tk = k.shape[1]

        # the JAX routing (models/attention.py:225-236): full, non-causal
        # self-attention with a band, up to 1024 keys; the inference kernel
        # when not training, the train kernel when training and asked for
        fused = (pos_band is not None and x_kv is None and not causal
                 and Tk <= MAX_FUSED_KEYS and not return_weights
                 and (self.use_pallas_train if self.training else self.use_pallas))
        if fused:
            # [B, T, H, Dh] -> [B*H, T, Dh] rows; contiguous() matters at
            # B == 1, where reshape returns a strided view
            N = B * H
            qf, kf, vf = (t.transpose(1, 2).reshape(N, Tq, Dh).contiguous()
                          for t in (q, k, v))
            band = pos_band.to(qf.dtype).contiguous()
            lengths = None
            if key_valid is not None:
                lengths = torch.repeat_interleave(
                    key_valid.sum(-1, dtype=torch.int32), H)
            if self.training:
                seed = 0
                if self.dropout > 0.0:
                    # an int32 draw, as jax.random.randint(.., 0, 2**31-1)
                    seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=generator))
                o = cuda_kernels.banded_attention_train(
                    qf, kf, vf, band, lengths,
                    dropout_rate=self.dropout, seed=seed)
            else:
                o = cuda_kernels.banded_flash_attention(qf, kf, vf, band, lengths)
            o = o.view(B, H, Tq, Dh).transpose(1, 2).reshape(B, Tq, self.d_model)
            return self.out_proj(o)

        score_dtype = torch.float32 if self.scores_f32 else self.dtype
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(score_dtype)
        if pos_band is not None:
            logits = logits + relative_bias_banded(q, pos_band).to(score_dtype)
        mask = None
        if key_valid is not None:
            mask = key_valid[:, None, None, :]
        if causal:
            cm = torch.ones(Tq, Tk, dtype=torch.bool, device=x.device).tril()
            mask = cm if mask is None else mask & cm
        if mask is not None:
            logits = torch.where(mask, logits,
                                 torch.full((), NEG_INF, dtype=score_dtype,
                                            device=logits.device))
        weights = torch.softmax(logits.float(), dim=-1)
        probs = F.dropout(weights.to(self.dtype), self.dropout, self.training)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(self.dtype))
        out = self.out_proj(out.reshape(B, Tq, self.d_model))
        return (out, weights) if return_weights else out
