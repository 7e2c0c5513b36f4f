"""Shared transformer encoder stack (post-LN) with the CTC head.

Port of ``speecht5_tpu/models/encoder.py`` (reference modules/encoder.py
:61-380): one clipped-distance relative position table shared by all layers
(``pos_emb``: Embedding(2*max_dist, head_dim)); the post-LN stack applies
the top-level LayerNorm to its *input* (encoder.py:226-227); the band is
built once per forward and shared by every layer (JAX encoder.py:94-105);
the CTC projection reads the encoder output (encoder.py:138-142; dropout is
off at inference, so the dropped-out and plain outputs agree).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import TransformerConfig
from .attention import band_from_table
from .common import LayerNorm32
from .layers import EncoderLayer


class RelPosTable(nn.Module):
    """Embedding table for clipped relative distances (reference encoder.py:40-59)."""

    def __init__(self, max_dist: int, head_dim: int):
        super().__init__()
        self.pe_k = nn.Embedding(2 * max_dist, head_dim)

    def forward(self):
        return self.pe_k.weight


class TransformerEncoder(nn.Module):
    def __init__(self, cfg: TransformerConfig, ctc_vocab_size: Optional[int] = None,
                 dtype=torch.float32):
        super().__init__()
        if cfg.layer_norm_first:
            raise NotImplementedError(
                "pre-LN encoder stacks arrive with the Large slice")
        self.cfg = cfg
        self.dtype = dtype
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, dtype) for _ in range(cfg.num_layers))
        self.layer_norm = LayerNorm32(cfg.d_model, eps=cfg.layer_norm_eps)
        self.pos_emb = (RelPosTable(cfg.rel_pos.max_distance, cfg.head_dim)
                        if cfg.rel_pos.enabled else None)
        self.proj = (nn.Linear(cfg.d_model, ctc_vocab_size)
                     if ctc_vocab_size is not None else None)

    def forward(self, x, valid_mask=None, *, with_ctc: bool = False):
        """x: [B, T, D]; valid_mask: bool [B, T] True=valid.

        Returns dict(encoder_out, valid_mask[, ctc_logits])."""
        x = self.layer_norm(x).to(self.dtype)
        pos_band = None
        if self.pos_emb is not None:
            # at T == 1 the band is the single entry pe_k[M], the value the
            # JAX package gathers on that path
            pos_band = band_from_table(
                self.pos_emb().to(self.dtype), x.shape[1],
                self.cfg.rel_pos.max_distance)
        for layer in self.layers:
            x = layer(x, valid_mask, pos_band)
        out = {"encoder_out": x, "valid_mask": valid_mask}
        if with_ctc and self.proj is not None:
            out["ctc_logits"] = self.ctc_head(x)
        return out

    def ctc_head(self, encoder_out):
        """f32 CTC logits [B, T, V]."""
        return self.proj(encoder_out.float())
