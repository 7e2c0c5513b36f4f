"""Shared transformer decoder stack, teacher-forced.

Port of ``speecht5_tpu/models/decoder.py`` :30-100 (reference
modules/decoder.py:33-324): causal self-attention + cross-attention layers,
post-LN with no final LayerNorm, or pre-LN (``layer_norm_first``) with a
final ``layer_norm`` after the last layer (decoder.py:76-81, JAX
decoder.py:46-48, :91-92, :152-153); ``cross_attention=False`` builds a
decoder-only stack (the fusion LM's trunk).  The reference builds a
rel-pos table for the decoder but never adds its bias
(``use_rel_pos_bias=False``), so the JAX tree holds no parameters for it
and neither does the port.  The cross-attention weights of every layer are
returned on request (decoder.py:60-99), for the TTS guided-attention loss.
The JAX decoder applies no layerdrop (only the encoder does,
encoder.py:114), whatever ``layerdrop`` says, and neither does the port.
``remat`` (JAX decoder.py:37-40) recomputes each teacher-forced layer in the
backward pass of a training forward (``torch.utils.checkpoint``, which
restores the global RNG states of the layer's dropout); decode steps never
checkpoint.

Incremental decoding (JAX decoder.py:101-170) keeps the cache as a plain
dict of tensors, ``{"index": 0-d int64, "layers": [{"k", "v"}], "cross":
[{"k", "v"} or None]}``, with fixed [B, max_len, H, Dh] self-attention
buffers that each step writes in place at ``index``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import TransformerConfig
from .common import LayerNorm32
from .layers import DecoderLayer


class TransformerDecoder(nn.Module):
    def __init__(self, cfg: TransformerConfig, dtype=torch.float32,
                 cross_attention: bool = True):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, dtype, cross_attention) for _ in range(cfg.num_layers))
        if cfg.layer_norm_first:
            self.layer_norm = LayerNorm32(cfg.d_model, eps=cfg.layer_norm_eps)

    def _final_norm(self, x):
        return self.layer_norm(x).to(self.dtype) if self.cfg.layer_norm_first else x

    def forward(self, x, enc=None, *, enc_valid=None, self_valid=None,
                causal: bool = True, need_cross_weights: bool = False):
        """Teacher-forced forward.  x: [B, Ttgt, D] (from a decoder prenet);
        enc: [B, Tsrc, D]; enc_valid / self_valid: bool masks, True = valid.
        -> features [B, Ttgt, D]; with ``need_cross_weights`` (features,
        every layer's f32 cross weights [L, B, H, Ttgt, Tsrc]), JAX's
        ``alignment_layer=-1``."""
        all_w = []
        remat = self.cfg.remat and self.training
        for layer in self.layers:
            args = (x, enc, enc_valid, self_valid, causal)
            if remat:
                x = checkpoint(layer, *args, need_cross_weights=need_cross_weights,
                               use_reentrant=False)
            else:
                x = layer(*args, need_cross_weights=need_cross_weights)
            if need_cross_weights:
                x, w = x
                all_w.append(w)
        x = self._final_norm(x)
        if not need_cross_weights:
            return x
        return x, torch.stack(all_w)

    def init_cache(self, enc, batch_size: int, max_len: int, cache_dtype=None):
        """Zeroed self-attention buffers (one pair per layer) and the
        precomputed cross K/V of ``enc`` [B_enc, Tsrc, D] (None: a
        decoder-only cache)."""
        cfg = self.cfg
        dev = next(self.parameters()).device
        shape = (batch_size, max_len, cfg.num_heads, cfg.head_dim)
        dt = cache_dtype or self.dtype
        layers = [{"k": torch.zeros(shape, dtype=dt, device=dev),
                   "v": torch.zeros(shape, dtype=dt, device=dev)}
                  for _ in self.layers]
        cross = [None if enc is None else layer.init_cross_kv(enc)
                 for layer in self.layers]
        return {"index": torch.zeros((), dtype=torch.int64, device=dev),
                "layers": layers, "cross": cross}

    def decode_step(self, x, cache, *, enc_valid=None, cache_rows=None,
                    need_cross_max: bool = False):
        """One AR step.  x: [B, Tq, D] prenet output at positions
        ``cache["index"]`` + i (the causal mask hides the unwritten cache
        positions); ``cache_rows`` int [B, max_len] ancestry map.  ->
        (features [B, Tq, D], new cache), and with ``need_cross_max`` every
        layer's largest cross-attention probability [L, B, H, Tq] f32: all
        that JAX's ``need_cross_weights`` weights feed (the TTS focus rate,
        JAX decode/tts.py:157-160), without the dense weights."""
        idx = cache["index"]
        layers, maxps = [], []
        for layer, c, kv in zip(self.layers, cache["layers"], cache["cross"]):
            out = layer.step(x, c, kv, idx, enc_valid=enc_valid, cache_rows=cache_rows,
                             need_cross_max=need_cross_max)
            x, c = out[:2]
            layers.append(c)
            if need_cross_max:
                maxps.append(out[2])
        x = self._final_norm(x)
        new = {"index": idx + x.shape[1], "layers": layers, "cross": cache["cross"]}
        if need_cross_max:
            return x, new, torch.stack(maxps)
        return x, new


def reorder_cache(cache, order):
    """Gather every batch-major cache tensor by ``order`` (the beam
    reorder of the "gather" mode)."""
    gather = lambda d: None if d is None else {k: v[order] for k, v in d.items()}
    return {"index": cache["index"],
            "layers": [gather(c) for c in cache["layers"]],
            "cross": [gather(c) for c in cache["cross"]]}
