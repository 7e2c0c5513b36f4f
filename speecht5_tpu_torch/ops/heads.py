"""Shared prediction-head math of the HuBERT-style heads (port of
``speecht5_tpu/ops/heads.py``): the cosine-similarity codebook logits
(reference speech_encoder_postnet.py:56-68 compute_nce, as plain CE over
the codebook)."""

from __future__ import annotations

import torch


def cosine_logits(x, embs, temp: float, eps: float = 1e-8):
    """x: [..., D] projected features; embs: [C, D] label embeddings ->
    [..., C] cosine similarities scaled by 1 / ``temp`` (each norm
    clamped at ``eps``)."""
    xn = x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), eps)
    en = embs / torch.clamp_min(torch.linalg.vector_norm(embs, dim=-1, keepdim=True), eps)
    return torch.einsum("...d,cd->...c", xn, en) / temp
