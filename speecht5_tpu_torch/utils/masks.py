"""Length/mask utilities (port of ``speecht5_tpu/utils/masks.py``).

Boolean masks use True = valid frame (the reference's fairseq convention is
the opposite, True = padding).
"""

from __future__ import annotations

import torch


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> bool[B, max_len], True where position < length."""
    pos = torch.arange(max_len, device=lengths.device, dtype=lengths.dtype)
    return pos[None, :] < lengths[:, None]


def mask_lengths(mask: torch.Tensor) -> torch.Tensor:
    """bool[B, T] (True=valid) -> int32[B]."""
    return mask.to(torch.int32).sum(dim=-1, dtype=torch.int32)
