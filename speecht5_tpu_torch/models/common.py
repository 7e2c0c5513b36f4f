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

