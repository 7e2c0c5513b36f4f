"""Transformer encoder and decoder layers and their feed-forward block.

Port of ``speecht5_tpu/models/layers.py`` :33-250 (reference
modules/transformer_layer.py:23-404): the encoder layer is BERT-style
post-LN and passes the rel-pos band through to self-attention; the
decoder layer runs causal self-attention without the rel-pos bias (the
reference never passes the bias hook, transformer_layer.py:229-242),
cross-attention against the encoder output and the FFN, teacher-forced or
one cached decode step at a time, post-LN or, with ``layer_norm_first``,
pre-LN (each sub-block's LayerNorm on its input, JAX layers.py:131-230:
the fusion LM's trunk).  Activation is the exact (erf) GELU; dropout
follows each sub-block and activation dropout the GELU, on training passes
only.  The post-LN path never applies ``norm_k`` (reference
transformer_layer.py:112-119), so the JAX tree holds no ``norm_k``
parameters for it and neither does the port.  The pre-LN encoder layer
(Large, with ``norm_k`` on the table) arrives with its slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import TransformerConfig
from .attention import MultiheadAttention
from .common import Dense, LayerNorm32


def _post_ln_only(cfg: TransformerConfig):
    if cfg.layer_norm_first:
        raise NotImplementedError("pre-LN encoder layers arrive with the Large slice")


class FeedForward(nn.Module):
    def __init__(self, cfg: TransformerConfig, dtype=torch.float32):
        super().__init__()
        if cfg.activation != "gelu":
            raise ValueError(f"activation {cfg.activation!r} is not ported")
        self.activation_dropout = cfg.activation_dropout
        self.fc1 = Dense(cfg.d_model, cfg.ffn_dim, dtype)
        self.fc2 = Dense(cfg.ffn_dim, cfg.d_model, dtype)

    def forward(self, x):
        x = F.gelu(self.fc1(x))  # exact (erf) GELU
        x = F.dropout(x, self.activation_dropout, self.training)
        return self.fc2(x)


class EncoderLayer(nn.Module):
    """reference transformer_layer.py:23-134 (TransformerSentenceEncoderLayer),
    post-LN only."""

    def __init__(self, cfg: TransformerConfig, dtype=torch.float32):
        super().__init__()
        _post_ln_only(cfg)
        self.cfg = cfg
        self.dtype = dtype
        self.self_attn = MultiheadAttention(
            cfg.d_model, cfg.num_heads, cfg.attention_dropout, dtype=dtype,
            use_pallas=cfg.use_pallas_attn,
            use_pallas_train=cfg.use_pallas_attn_train,
            scores_f32=cfg.attn_scores_f32,
        )
        self.self_attn_layer_norm = LayerNorm32(cfg.d_model, eps=cfg.layer_norm_eps)
        self.final_layer_norm = LayerNorm32(cfg.d_model, eps=cfg.layer_norm_eps)
        self.ffn = FeedForward(cfg, dtype)

    def _drop(self, x):
        return F.dropout(x, self.cfg.dropout, self.training)

    def forward(self, x, key_valid=None, pos_band=None, *, dropout_seed=None):
        residual = x
        y = self.self_attn(x, key_valid, pos_band, dropout_seed=dropout_seed)
        x = self.self_attn_layer_norm(residual + self._drop(y)).to(self.dtype)
        residual = x
        x = residual + self._drop(self.ffn(x))
        return self.final_layer_norm(x).to(self.dtype)


class DecoderLayer(nn.Module):
    """reference transformer_layer.py:137-404 (TransformerDecoderLayer),
    post-LN or pre-LN (``layer_norm_first``): teacher-forced (``forward``)
    and one cached decode step (``step``, JAX layers.py:160-230).
    ``cross_attention=False`` builds no cross-attention sub-block (a
    decoder-only stack: the fusion LM, whose JAX tree has no such
    parameters).  ``use_pallas_attn`` sends the decode steps' attention to
    the ``flash_attention_bias`` kernel."""

    def __init__(self, cfg: TransformerConfig, dtype=torch.float32,
                 cross_attention: bool = True):
        super().__init__()
        if cfg.use_rel_pos_bias:
            raise NotImplementedError(
                "decoder self-attention with the rel-pos bias is not ported "
                "(SpeechT5 decoders run without it)")
        self.cfg = cfg
        self.dtype = dtype
        self.pre_ln = cfg.layer_norm_first
        attn = lambda: MultiheadAttention(
            cfg.d_model, cfg.num_heads, cfg.attention_dropout, dtype=dtype,
            use_pallas=cfg.use_pallas_attn, scores_f32=cfg.attn_scores_f32)
        ln = lambda: LayerNorm32(cfg.d_model, eps=cfg.layer_norm_eps)
        self.self_attn = attn()
        self.self_attn_layer_norm = ln()
        if cross_attention:
            self.encoder_attn = attn()
            self.encoder_attn_layer_norm = ln()
        self.final_layer_norm = ln()
        self.ffn = FeedForward(cfg, dtype)

    def _drop(self, x):
        return F.dropout(x, self.cfg.dropout, self.training)

    def _block(self, x, norm, fn):
        """x + dropout(fn(...)): pre-LN normalises fn's input, post-LN the
        sum; ``fn`` returns the sub-block's output and any extra results."""
        if self.pre_ln:
            y, *extra = fn(norm(x).to(self.dtype))
            return (x + self._drop(y), *extra)
        y, *extra = fn(x)
        return (norm(x + self._drop(y)).to(self.dtype), *extra)

    def forward(self, x, enc=None, enc_valid=None, self_valid=None,
                causal: bool = True, need_cross_weights: bool = False):
        """-> x [B, Ttgt, D], or with ``need_cross_weights`` (x, the cross
        attention's f32 weights [B, H, Ttgt, Tsrc], None without ``enc``)."""
        x, = self._block(x, self.self_attn_layer_norm,
                         lambda h: (self.self_attn(h, self_valid, causal=causal),))
        cross_w = None
        if enc is not None:
            def cross(h):
                y = self.encoder_attn(h, enc_valid, x_kv=enc,
                                      return_weights=need_cross_weights)
                return y if need_cross_weights else (y, None)

            x, cross_w = self._block(x, self.encoder_attn_layer_norm, cross)
        x, = self._block(x, self.final_layer_norm, lambda h: (self.ffn(h),))
        return (x, cross_w) if need_cross_weights else x

    def step(self, x, cache, cross_kv, cache_index, *, enc_valid=None,
             cache_rows=None, need_cross_max: bool = False):
        """One decode step: x [B, Tq, D] at positions ``cache_index`` + i;
        ``cache`` this layer's {"k", "v"} buffers (written in place);
        ``cross_kv`` from ``init_cross_kv`` or None (no cross-attention).
        -> (x, cache), or with ``need_cross_max`` (x, cache, the cross
        attention's largest probability [B, H, Tq] f32)."""
        x, cache = self._block(
            x, self.self_attn_layer_norm,
            lambda h: self.self_attn(h, causal=True, cache=cache,
                                     cache_index=cache_index, cache_rows=cache_rows))
        maxp = None
        if cross_kv is not None:
            def cross(h):
                y = self.encoder_attn(h, enc_valid, cross_kv=cross_kv,
                                      return_max_prob=need_cross_max)
                return y if need_cross_max else (y, None)

            x, maxp = self._block(x, self.encoder_attn_layer_norm, cross)
        x, = self._block(x, self.final_layer_norm, lambda h: (self.ffn(h),))
        return (x, cache, maxp) if need_cross_max else (x, cache)

    def init_cross_kv(self, enc):
        return self.encoder_attn.precompute_kv(enc)
