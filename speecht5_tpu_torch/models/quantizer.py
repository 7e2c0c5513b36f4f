"""Gumbel-softmax vector quantizer (wav2vec2-style), port of
``speecht5_tpu/models/quantizer.py`` (fairseq GumbelVectorQuantizer, as the
reference mixes codebook entries into the encoder output,
models/speecht5.py:93-107, :858-882): grouped codebooks, the hard
Gumbel-softmax with a straight-through gradient on training passes, the
argmax codes at eval, and the perplexities of the diversity loss.

The Gumbel noise is drawn from an explicit ``torch.Generator`` as
-log(-log(u)), u uniform in [1e-9, 1) (the JAX draw's range), or taken as
given (``gumbel``), so a test can hand both packages the same noise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def gumbel_noise(shape, generator=None, device=None):
    """-log(-log(u)), u ~ U[1e-9, 1) in f32, drawn on the generator's device
    (the default CPU generator when None), then moved to ``device``."""
    dev = generator.device if generator is not None else torch.device("cpu")
    u = torch.rand(shape, generator=generator, device=dev) * (1.0 - 1e-9) + 1e-9
    return (-torch.log(-torch.log(u))).to(device)


class GumbelVectorQuantizer(nn.Module):
    """``vars`` [1, G * V, vq_dim / G] and ``weight_proj`` (dim -> G * V),
    both f32 (JAX quantizer.py:18-98)."""

    def __init__(self, dim: int, num_vars: int, groups: int, vq_dim: int,
                 temp=(2.0, 0.5, 0.999995), dtype=torch.float32):
        super().__init__()
        if vq_dim % groups:
            raise ValueError(f"vq_dim {vq_dim} is not a multiple of groups {groups}")
        self.num_vars, self.groups, self.vq_dim = num_vars, groups, vq_dim
        self.temp = tuple(temp)
        self.dtype = dtype
        self.vars = nn.Parameter(torch.empty(1, num_vars * groups, vq_dim // groups))
        self.weight_proj = nn.Linear(dim, groups * num_vars)

    def current_temp(self, num_updates: int) -> float:
        start, end, decay = self.temp
        return max(start * decay ** num_updates, end)

    def forward(self, x, *, num_updates: int = 0, generator=None, gumbel=None):
        """x: [B, T, dim] -> {"x": [B, T, vq_dim] in the compute dtype,
        "prob_perplexity", "code_perplexity" (0-d f32), "num_vars": G * V,
        "temp"}.  Training passes: the hard Gumbel-softmax at the
        temperature of ``num_updates``, the noise [B * T * G, V] from
        ``generator`` or ``gumbel``; eval: the argmax codes."""
        B, T, _ = x.shape
        G, V = self.groups, self.num_vars
        logits = self.weight_proj(x.float()).reshape(B * T * G, V)
        avg_probs = torch.softmax(logits, dim=-1).reshape(B * T, G, V).mean(0)
        prob_ppl = torch.exp(-(avg_probs * torch.log(avg_probs + 1e-7)).sum(-1)).sum()
        temp = self.current_temp(num_updates)
        if self.training:
            if gumbel is None:
                gumbel = gumbel_noise(logits.shape, generator, logits.device)
            y_soft = torch.softmax((logits + gumbel.to(logits)) / temp, dim=-1)
            idx = y_soft.argmax(-1)
            y_hard = F.one_hot(idx, V).float()
            onehot = y_hard + y_soft - y_soft.detach()      # straight-through
        else:
            idx = logits.argmax(-1)
            onehot = F.one_hot(idx, V).float()
        hard_probs = F.one_hot(idx, V).float().reshape(B * T, G, V).mean(0)
        code_ppl = torch.exp(-(hard_probs * torch.log(hard_probs + 1e-7)).sum(-1)).sum()
        sel = torch.einsum("ngv,gvd->ngd", onehot.reshape(B * T, G, V),
                           self.vars.reshape(G, V, -1))
        return {"x": sel.reshape(B, T, self.vq_dim).to(self.dtype),
                "prob_perplexity": prob_ppl, "code_perplexity": code_ppl,
                "num_vars": float(G * V), "temp": temp}
