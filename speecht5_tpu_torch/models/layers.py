"""Transformer encoder layer (post-LN) and its feed-forward block.

Port of ``speecht5_tpu/models/layers.py`` :33-130 (reference
modules/transformer_layer.py:23-134): BERT-style post-LN layer with the
rel-pos band passed through to self-attention; activation is the exact
(erf) GELU.  The post-LN path never applies ``norm_k`` to the pos table
(reference transformer_layer.py:112-119), so the JAX tree holds no
``norm_k`` parameters for it and neither does the port.  The pre-LN layer
(Large) and the decoder layer arrive with their slices.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import TransformerConfig
from .attention import MultiheadAttention
from .common import Dense, LayerNorm32


class FeedForward(nn.Module):
    def __init__(self, cfg: TransformerConfig, dtype=torch.float32):
        super().__init__()
        if cfg.activation != "gelu":
            raise ValueError(f"activation {cfg.activation!r} is not ported")
        self.fc1 = Dense(cfg.d_model, cfg.ffn_dim, dtype)
        self.fc2 = Dense(cfg.ffn_dim, cfg.d_model, dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))  # exact (erf) GELU


class EncoderLayer(nn.Module):
    """reference transformer_layer.py:23-134 (TransformerSentenceEncoderLayer),
    post-LN only."""

    def __init__(self, cfg: TransformerConfig, dtype=torch.float32):
        super().__init__()
        if cfg.layer_norm_first:
            raise NotImplementedError(
                "pre-LN encoder layers arrive with the Large slice")
        self.cfg = cfg
        self.dtype = dtype
        self.self_attn = MultiheadAttention(
            cfg.d_model, cfg.num_heads, dtype=dtype,
            use_pallas=cfg.use_pallas_attn, scores_f32=cfg.attn_scores_f32,
        )
        self.self_attn_layer_norm = LayerNorm32(cfg.d_model, eps=cfg.layer_norm_eps)
        self.final_layer_norm = LayerNorm32(cfg.d_model, eps=cfg.layer_norm_eps)
        self.ffn = FeedForward(cfg, dtype)

    def forward(self, x, key_valid=None, pos_band=None):
        residual = x
        y = self.self_attn(x, key_valid=key_valid, pos_band=pos_band)
        x = self.self_attn_layer_norm(residual + y).to(self.dtype)
        residual = x
        x = residual + self.ffn(x)
        return self.final_layer_norm(x).to(self.dtype)
