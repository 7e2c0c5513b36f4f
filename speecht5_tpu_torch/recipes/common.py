"""What the recipes share: the optimizer."""

from __future__ import annotations

import torch

#: optax ``adamw``'s defaults (torch's weight decay is 1e-2)
ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def adamw(model, lr: float):
    return torch.optim.AdamW(model.parameters(), lr=lr, **ADAMW)

