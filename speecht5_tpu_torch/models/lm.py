"""Decoder-only transformer language model for shallow fusion in the beam.

Port of ``speecht5_tpu/models/lm.py`` (:24-124).  The reference registers a
20-layer fairseq transformer_lm (d 1280, FFN 6144, 16 heads; reference
models/t5_transformer_lm.py:16-25) and adds ``lm_weight * lm_lprobs`` to
the beam scores each step (reference sequence_generator.py:425-432).  The
trunk is the port's ``TransformerDecoder``, pre-LN and without
cross-attention; the input is the token embedding scaled by sqrt(d) plus
the fairseq sinusoidal positions; the output projection is the tied
embedding in f32.  Decode steps write a KV cache of [B, max_len, H, Dh]
buffers in place and read it through the cached ``MultiheadAttention``
path, optionally through the beam's ancestry row map: with
``trunk.use_pallas_attn`` every layer's step launches the decode-step
kernel (``flash_attention_bias_cached``), at Dh 80 for the default
geometry.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
from torch import nn

from ..config import RelPosConfig, TransformerConfig
from ..ops.positional import fairseq_sinusoidal_table
from .decoder import TransformerDecoder


@dataclass(frozen=True)
class TransformerLMConfig:
    vocab_size: int = 81
    pad_id: int = 1
    max_positions: int = 1024
    scale_embedding: bool = True
    share_embed: bool = True  # tie the input and output embeddings
    trunk: TransformerConfig = field(
        default_factory=lambda: TransformerConfig(
            d_model=1280, ffn_dim=6144, num_layers=20, num_heads=16,
            layer_norm_first=True, rel_pos=RelPosConfig(enabled=False),
            use_rel_pos_bias=False,
        )
    )


def lm_tiny() -> TransformerLMConfig:
    return TransformerLMConfig(
        vocab_size=32,
        max_positions=64,
        trunk=TransformerConfig(
            d_model=64, ffn_dim=128, num_layers=2, num_heads=4,
            layer_norm_first=True, rel_pos=RelPosConfig(enabled=False),
            use_rel_pos_bias=False, dropout=0.0, attention_dropout=0.0,
        ),
    )


class TransformerLM(nn.Module):
    """Parameters in f32, compute in ``dtype`` (as the JAX module's
    ``dtype``); state-dict keys ``embed_tokens.weight``, ``decoder.*`` and,
    untied, ``output_projection.weight`` (the JAX tree's names, carried by
    ``utils/convert.lm_from_jax_params``)."""

    def __init__(self, cfg: TransformerLMConfig, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.trunk.d_model
        self.embed_tokens = nn.Embedding(cfg.vocab_size, d)
        self.decoder = TransformerDecoder(cfg.trunk, dtype, cross_attention=False)
        if not cfg.share_embed:
            self.output_projection = nn.Linear(d, cfg.vocab_size, bias=False)
        table = fairseq_sinusoidal_table(cfg.pad_id + 2 + cfg.max_positions, d,
                                         cfg.pad_id)
        self.register_buffer("positions", torch.from_numpy(table), persistent=False)

    def _embed(self, tokens, positions):
        scale = math.sqrt(self.cfg.trunk.d_model) if self.cfg.scale_embedding else 1.0
        x = self.embed_tokens(tokens).to(self.dtype) * scale
        return x + self.positions[positions].to(self.dtype)

    def _logits(self, feats):
        w = (self.embed_tokens.weight if self.cfg.share_embed
             else self.output_projection.weight)
        return feats.float() @ w.float().t()

    def forward(self, tokens):
        """[B, T] (pad_id-padded) -> f32 logits [B, T, V]; T at most
        ``max_positions`` (JAX clamps the positions past the table)."""
        if tokens.shape[1] > self.cfg.max_positions:
            raise ValueError(f"{tokens.shape[1]} tokens; the LM has "
                             f"{self.cfg.max_positions} positions")
        valid = tokens != self.cfg.pad_id
        pos = self.cfg.pad_id + torch.cumsum(valid.long(), dim=-1) * valid
        feats = self.decoder(self._embed(tokens, pos), None, self_valid=valid,
                             causal=True)
        return self._logits(feats)

    def init_cache(self, batch_size: int, max_len: int):
        """Zeroed [batch_size, max_len, H, Dh] K/V buffers per layer:
        {"index": 0-d int64, "layers": [{"k", "v"}]}."""
        cache = self.decoder.init_cache(None, batch_size, max_len)
        return {"index": cache["index"], "layers": cache["layers"]}

    def decode_step(self, tokens_t, cache, cache_rows=None):
        """tokens_t: [B, 1] at position ``cache["index"]`` (under
        ``max_positions``; the index stays on the device, unchecked) ->
        (f32 logits [B, V], new cache); ``cache_rows`` int64 [B, max_len]:
        the beam's ancestry map (position j of row b lives in physical row
        cache_rows[b, j]), or None for buffers already in row order."""
        idx = cache["index"]
        pos = torch.zeros_like(tokens_t) + (self.cfg.pad_id + 1 + idx)
        x = self._embed(tokens_t, pos)
        layers = []
        for layer, c in zip(self.decoder.layers, cache["layers"]):
            x, c = layer.step(x, c, None, idx, cache_rows=cache_rows)
            layers.append(c)
        x = self.decoder._final_norm(x)
        return self._logits(x)[:, 0], {"index": idx + 1, "layers": layers}


def init_lm(cfg: TransformerLMConfig, generator: torch.Generator = None,
            device="cuda", dtype=torch.float32) -> TransformerLM:
    """A ``TransformerLM`` with its parameters drawn from ``generator`` (a
    CPU generator: the same weights on every device), moved to ``device``
    in eval mode.  Random weights serve the tests and the chip smoke; real
    ones come from a checkpoint."""
    from ..utils.device import resolve_device

    device = resolve_device(device)
    lm = TransformerLM(cfg, dtype)
    with torch.no_grad():
        for name, p in lm.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.dim() == 1:       # LayerNorm scales
                p.fill_(1.0)
            else:
                p.normal_(0.0, p.shape[-1] ** -0.5, generator=generator)
    return lm.to(device).eval()
