"""Multi-head self-attention with the SpeechT5 relative-position bias.

Port of ``speecht5_tpu/models/attention.py`` for the encoder's full,
non-causal self-attention (reference modules/multihead_attention.py:24-522):
q is scaled by head_dim**-0.5 before use, and the relative-position bias is
the first-order term B[b,h,i,j] = q_scaled[b,h,i,:] . pe_k[clip(i-j)]
(reference :343-353).  The KV cache, cross-attention and the ancestry view
(``cache_rows``) arrive with the beam slice.

The port is inference-only so far: no dropout is applied.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import cuda_kernels
from .common import Dense

NEG_INF = -1e9


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
    """Projections + full self-attention (``use_pallas`` routes to the CUDA
    kernel, as ``config.use_pallas_attn`` does in the JAX package)."""

    def __init__(self, d_model: int, num_heads: int, *,
                 dtype=torch.float32, use_pallas: bool = False,
                 scores_f32: bool = True):
        super().__init__()
        self.d_model = d_model
        self.num_heads = num_heads
        self.dtype = dtype
        self.use_pallas = use_pallas
        self.scores_f32 = scores_f32
        self.q_proj = Dense(d_model, d_model, dtype)
        self.k_proj = Dense(d_model, d_model, dtype)
        self.v_proj = Dense(d_model, d_model, dtype)
        self.out_proj = Dense(d_model, d_model, dtype)

    @property
    def head_dim(self):
        return self.d_model // self.num_heads

    def forward(self, x, key_valid=None, pos_band=None):
        """x: [B, T, D]; key_valid: bool [B, T] (True = attend, a contiguous
        prefix); pos_band: [Dh, T, T] or None -> [B, T, D]."""
        B, T, _ = x.shape
        H, Dh = self.num_heads, self.head_dim
        q = self.q_proj(x).view(B, T, H, Dh) * (Dh ** -0.5)
        k = self.k_proj(x).view(B, T, H, Dh)
        v = self.v_proj(x).view(B, T, H, Dh)

        # the JAX routing (models/attention.py:225-236) with the port's kernel:
        # full self-attention with a band, up to 1024 keys
        if pos_band is not None and self.use_pallas and T <= 1024:
            # [B, T, H, Dh] -> [B*H, T, Dh] rows; contiguous() matters at
            # B == 1, where reshape returns a strided view
            N = B * H
            qf, kf, vf = (t.transpose(1, 2).reshape(N, T, Dh).contiguous()
                          for t in (q, k, v))
            lengths = None
            if key_valid is not None:
                lengths = torch.repeat_interleave(
                    key_valid.sum(-1, dtype=torch.int32), H)
            o = cuda_kernels.banded_flash_attention(
                qf, kf, vf, pos_band.to(qf.dtype).contiguous(), lengths)
            o = o.view(B, H, T, Dh).transpose(1, 2).reshape(B, T, self.d_model)
            return self.out_proj(o)

        score_dtype = torch.float32 if self.scores_f32 else self.dtype
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(score_dtype)
        if pos_band is not None:
            logits = logits + relative_bias_banded(q, pos_band).to(score_dtype)
        if key_valid is not None:
            logits = torch.where(key_valid[:, None, None, :], logits,
                                 torch.full((), NEG_INF, dtype=score_dtype,
                                            device=logits.device))
        probs = torch.softmax(logits.float(), dim=-1).to(self.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(self.dtype))
        return self.out_proj(out.reshape(B, T, self.d_model))
