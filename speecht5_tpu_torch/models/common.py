"""Building blocks that mirror flax's dtype semantics.

Parameters live in f32 (``param_dtype``); a Dense layer casts its input,
kernel and bias to the compute dtype, as ``flax.linen.Dense(dtype=...)``
does, and LayerNorm always computes in f32, as the JAX package's
``nn.LayerNorm(dtype=jnp.float32)`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Linear):
    """``nn.Linear`` that computes in ``dtype`` (weights kept in f32)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype=torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm32(nn.LayerNorm):
    """LayerNorm computed in f32; returns f32 (callers cast)."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)



def init_weights(model: nn.Module, generator: torch.Generator = None) -> nn.Module:
    """Random weights for the sibling families' models (SpeechLM, SpeechUT,
    FastText2Unit), drawn from ``generator`` (a CPU ``torch.Generator``,
    seeded 0 when None) in module order, after the JAX initialisers:
    lecun-normal dense and conv kernels, zero biases, unit norm scales,
    embeddings of std dim^-0.5, normal(0.02) for a weight-normed conv's
    direction with unit magnitudes, and uniform [0, 1) for the mask
    embedding and the label embeddings (any parameter named ``mask_emb`` or
    ``label_embs*``)."""
    from .prenets import WeightNormConv1d, _ConvKernel, _PerChannelGroupNorm

    if generator is None:
        generator = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.normal_(0.0, mod.in_features ** -0.5, generator=generator)
            elif isinstance(mod, (nn.Conv1d, _ConvKernel)):
                _, c_in, k = mod.weight.shape
                mod.weight.normal_(0.0, (c_in * k) ** -0.5, generator=generator)
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, mod.embedding_dim ** -0.5, generator=generator)
            elif isinstance(mod, WeightNormConv1d):
                mod.weight_v.normal_(0.0, 0.02, generator=generator)
                mod.weight_g.fill_(1.0)
            elif isinstance(mod, (nn.LayerNorm, _PerChannelGroupNorm)):
                mod.weight.fill_(1.0)
            if getattr(mod, "bias", None) is not None and isinstance(mod.bias, nn.Parameter):
                mod.bias.zero_()
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "mask_emb" or leaf.startswith("label_embs"):
                p.uniform_(0.0, 1.0, generator=generator)
    return model
