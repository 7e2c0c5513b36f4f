"""Building blocks that mirror flax's dtype semantics.

Parameters live in f32 (``param_dtype``); a Dense layer casts its input,
kernel and bias to the compute dtype, as ``flax.linen.Dense(dtype=...)``
does, and LayerNorm always computes in f32, as the JAX package's
``nn.LayerNorm(dtype=jnp.float32)`` does.
"""

from __future__ import annotations

import math
from typing import Tuple

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


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax / XLA "SAME" padding of one axis: (left, right)."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class SameConvNd(nn.Module):
    """flax ``nn.Conv(padding="SAME", use_bias=False)`` over channels-last
    [N, *spatial, C_in] (2-D or 3-D), computed in ``dtype``; ``weight``
    [C_out, C_in, *kernel]."""

    def __init__(self, c_in: int, c_out: int, kernel, stride, dtype=torch.float32):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(c_out, c_in, *self.kernel))

    def forward(self, x):
        nd = len(self.kernel)
        x = x.to(self.compute_dtype).movedim(-1, 1)          # channels-last storage
        pads = []
        for n, k, s in reversed(list(zip(x.shape[2:], self.kernel, self.stride))):
            pads += same_pads(n, k, s)
        conv = F.conv3d if nd == 3 else F.conv2d
        y = conv(F.pad(x, pads), self.weight.to(self.compute_dtype), stride=self.stride)
        return y.movedim(1, -1)


def init_weights(model: nn.Module, generator: torch.Generator = None) -> nn.Module:
    """Random weights for the sibling families' models (SpeechLM, SpeechUT,
    FastText2Unit, YiTrans, VATLM), drawn from ``generator`` (a CPU
    ``torch.Generator``, seeded 0 when None) in module order, after the JAX
    initialisers: lecun-normal dense and conv kernels (1-D, 2-D and 3-D),
    zero biases, unit norm scales,
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
            elif isinstance(mod, (nn.Conv1d, _ConvKernel, SameConvNd)):
                fan_in = mod.weight[0].numel()
                mod.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
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
