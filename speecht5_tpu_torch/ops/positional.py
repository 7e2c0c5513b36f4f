"""Positional encodings (port of ``speecht5_tpu/ops/positional.py``).

- fairseq convention (speech encoder and text decoder prenets, reference
  speech_encoder_prenet.py:122-125): half-sin/half-cos *concatenated*,
  positions offset by ``padding_idx + 1``, pad positions get position
  ``padding_idx`` (whose row is zero);
- espnet convention (text encoder and speech decoder prenets, reference
  espnet ScaledPositionalEncoding): sin/cos *interleaved* from position 0,
  scaled by the prenet's learned ``alpha``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def fairseq_sinusoidal_table(num_embeddings: int, dim: int,
                             padding_idx: int = 1) -> np.ndarray:
    """fairseq-convention sinusoidal table [num_embeddings, dim] (numpy)."""
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    freq = np.exp(np.arange(half, dtype=np.float64) * -emb)
    pos = np.arange(num_embeddings, dtype=np.float64)[:, None] * freq[None, :]
    table = np.concatenate([np.sin(pos), np.cos(pos)], axis=1)
    if dim % 2 == 1:
        table = np.concatenate([table, np.zeros((num_embeddings, 1))], axis=1)
    if padding_idx is not None:
        table[padding_idx, :] = 0.0
    return table.astype(np.float32)


def fairseq_positions_from_mask(valid_mask: torch.Tensor,
                                padding_idx: int = 1) -> torch.Tensor:
    """Position ids fairseq-style: pad -> padding_idx, else padding_idx + cumsum."""
    valid = valid_mask.to(torch.int64)
    return padding_idx + torch.cumsum(valid, dim=-1) * valid


def fairseq_sinusoidal(valid_mask: torch.Tensor, dim: int,
                       padding_idx: int = 1) -> torch.Tensor:
    """[B, T] valid mask -> [B, T, dim] f32 fairseq sinusoidal positions."""
    T = valid_mask.shape[-1]
    table = torch.from_numpy(
        fairseq_sinusoidal_table(padding_idx + 1 + T, dim, padding_idx)
    ).to(valid_mask.device)
    return table[fairseq_positions_from_mask(valid_mask, padding_idx)]


@functools.lru_cache(maxsize=16)
def espnet_sinusoidal_table(max_len: int, dim: int) -> np.ndarray:
    """espnet-convention table [max_len, dim] (numpy f32): interleaved sin/cos
    from position 0.  Cached: treat the result as read-only."""
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float64) * -(math.log(10000.0) / dim))
    table = np.zeros((max_len, dim))
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div)
    return table.astype(np.float32)


def espnet_sinusoidal(T: int, dim: int, offset: int = 0,
                      device=None) -> torch.Tensor:
    """[T, dim] f32 espnet positions starting at ``offset`` (row p is the
    same whatever the table's length, so a slice of the table the JAX
    prenets build, ``max_speech_positions + 8`` rows, gives the same rows)."""
    rows = torch.from_numpy(espnet_sinusoidal_table(offset + T, dim)[offset:])
    return rows if device is None else rows.to(device)
