"""Shared transformer decoder stack, teacher-forced.

Port of ``speecht5_tpu/models/decoder.py`` :30-100 (reference
modules/decoder.py:33-324): causal self-attention + cross-attention layers,
post-LN, so no final LayerNorm (decoder.py:76-81).  The reference builds a
rel-pos table for the decoder but never adds its bias
(``use_rel_pos_bias=False``), so the JAX tree holds no parameters for it
and neither does the port.  The cross-attention weights of every layer are
returned on request (decoder.py:60-99), for the TTS guided-attention loss.
The JAX decoder applies no layerdrop (only the encoder does,
encoder.py:114), whatever ``layerdrop`` says, and neither does the port.
The KV cache (``init_cache``, ``decode_step``, ``reorder_cache``) arrives
with the beam slice.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import TransformerConfig
from .layers import DecoderLayer


class TransformerDecoder(nn.Module):
    def __init__(self, cfg: TransformerConfig, dtype=torch.float32):
        super().__init__()
        if cfg.layer_norm_first:
            raise NotImplementedError("pre-LN decoder stacks arrive with the Large slice")
        self.cfg = cfg
        self.dtype = dtype
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, dtype) for _ in range(cfg.num_layers))

    def forward(self, x, enc=None, *, enc_valid=None, self_valid=None,
                causal: bool = True, need_cross_weights: bool = False):
        """Teacher-forced forward.  x: [B, Ttgt, D] (from a decoder prenet);
        enc: [B, Tsrc, D]; enc_valid / self_valid: bool masks, True = valid.
        -> features [B, Ttgt, D]; with ``need_cross_weights`` (features,
        every layer's f32 cross weights [L, B, H, Ttgt, Tsrc]), JAX's
        ``alignment_layer=-1``."""
        all_w = []
        for layer in self.layers:
            x = layer(x, enc, enc_valid, self_valid, causal,
                      need_cross_weights=need_cross_weights)
            if need_cross_weights:
                x, w = x
                all_w.append(w)
        if not need_cross_weights:
            return x
        return x, torch.stack(all_w)
