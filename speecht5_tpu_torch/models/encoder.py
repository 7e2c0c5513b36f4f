"""Shared transformer encoder stack (post-LN or pre-LN) with the CTC head.

Port of ``speecht5_tpu/models/encoder.py`` (reference modules/encoder.py
:61-380): one clipped-distance relative position table shared by all layers
(``pos_emb``: Embedding(2*max_dist, head_dim)); the post-LN stack applies
the top-level LayerNorm to its *input* (encoder.py:226-227) and builds the
band once per forward, shared by every layer (JAX encoder.py:94-105); the
pre-LN stack (Large) applies it to its *output* (:275-276) and hands the
table to every layer, which norms it with its own ``norm_k`` (no shared
band: on the kernel route each layer builds its own); the CTC projection
reads the dropped-out encoder output (encoder.py :138-142: a second
dropout draw on training passes -- the contract, not a slip).  Layerdrop (training only, JAX encoder.py:114-124) skips a layer
with probability ``layerdrop``; the JAX package runs the layer and selects,
which gives the same output and gradient for the same draw.  ``remat``
(JAX encoder.py:51-56, ``nn.remat``) recomputes each layer in the backward
pass of a training forward (``torch.utils.checkpoint``): the layer's draws
from the CPU generator (the train kernel's dropout seed) are made before
the checkpointed call and handed in, and the checkpoint restores the global
RNG states of the layer's dropout, so the recompute repeats the forward bit
for bit.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import TransformerConfig
from .attention import BAND_ROW_MULTIPLE, band_from_table
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
        self.cfg = cfg
        self.dtype = dtype
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, dtype) for _ in range(cfg.num_layers))
        self.layer_norm = LayerNorm32(cfg.d_model, eps=cfg.layer_norm_eps)
        self.pos_emb = (RelPosTable(cfg.rel_pos.max_distance, cfg.head_dim)
                        if cfg.rel_pos.enabled else None)
        self.proj = (nn.Linear(cfg.d_model, ctc_vocab_size)
                     if ctc_vocab_size is not None else None)

    def forward(self, x, valid_mask=None, *, with_ctc: bool = False,
                generator=None):
        """x: [B, T, D]; valid_mask: bool [B, T] True=valid.  ``generator``:
        CPU ``torch.Generator`` for the layerdrop draws and the train
        kernel's dropout seeds (the default CPU generator when None).

        Returns dict(encoder_out, valid_mask[, ctc_logits])."""
        cfg = self.cfg
        pre_ln = cfg.layer_norm_first
        if not pre_ln:
            x = self.layer_norm(x).to(self.dtype)
        x = F.dropout(x, cfg.dropout, self.training)
        pos_band = pos_table = None
        if self.pos_emb is not None and pre_ln:
            pos_table = self.pos_emb().float()
        elif self.pos_emb is not None:
            # built from the f32 table and then cast, so the gather's
            # backward sums in f32; at T == 1 the band is the single entry
            # pe_k[M], the value the JAX package gathers on that path.  Its
            # rows are padded once here, so no attention call copies it.
            pos_band = band_from_table(
                self.pos_emb().float(), x.shape[1], cfg.rel_pos.max_distance,
                dtype=self.dtype, row_multiple=BAND_ROW_MULTIPLE)
        for layer in self.layers:
            if self.training and cfg.layerdrop > 0.0:
                if torch.rand((), generator=generator) < cfg.layerdrop:
                    continue
            seed = layer.self_attn.train_seed(
                pos_band if pos_table is None else pos_table, x.shape[1], generator)
            if cfg.remat and self.training:
                x = checkpoint(layer, x, valid_mask, pos_band, pos_table=pos_table,
                               dropout_seed=seed, use_reentrant=False)
            else:
                x = layer(x, valid_mask, pos_band, pos_table=pos_table, dropout_seed=seed)
        if pre_ln:
            x = self.layer_norm(x).to(self.dtype)
        out = {"encoder_out": x, "valid_mask": valid_mask}
        if with_ctc and self.proj is not None:
            out["ctc_logits"] = self.ctc_head(
                F.dropout(x, cfg.dropout, self.training))
        return out

    def ctc_head(self, encoder_out):
        """f32 CTC logits [B, T, V]."""
        return self.proj(encoder_out.float())
