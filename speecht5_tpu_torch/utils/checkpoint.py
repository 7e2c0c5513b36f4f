"""Save and resume the s2t train state in the port's own ``torch.save``
format: model and optimizer state, the update count, the data position and
the host generator's state, one file per saved update.

    <save_dir>/checkpoint_<step>.pt

A file is written under a temporary name and renamed into place, so a
half-written checkpoint is never resumed; the newest ``keep_last`` stay.
Reading a JAX (orbax) checkpoint needs conversion and is not ported yet.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import torch

_NAME = re.compile(r"^checkpoint_(\d+)\.pt$")


def checkpoints(save_dir) -> list:
    """[(step, path)] of the checkpoints in ``save_dir``, oldest first."""
    d = Path(save_dir)
    if not d.is_dir():
        return []
    found = [(int(m.group(1)), d / f) for f in os.listdir(d)
             if (m := _NAME.match(f))]
    return sorted(found)


def save_checkpoint(save_dir, trainer, *, data_state=None,
                    keep_last: int = 10) -> Path:
    """Write the trainer's state at its current step; prune old files."""
    d = Path(save_dir)
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"checkpoint_{trainer.step}.pt"
    tmp = d / f".{path.name}.{os.getpid()}.tmp"
    torch.save({
        "step": trainer.step,
        "model": trainer.model.state_dict(),
        "optimizer": trainer.optimizer.state_dict(),
        "generator": trainer.generator.get_state(),
        "data_state": dict(data_state or {}),
    }, tmp)
    os.replace(tmp, path)
    for _, old in checkpoints(d)[:-max(keep_last, 1)]:
        old.unlink()
    return path


def restore_latest(save_dir, trainer):
    """Load the newest checkpoint of ``save_dir`` into the trainer; returns
    its data state (dict), or None when there is none."""
    found = checkpoints(save_dir)
    if not found:
        return None
    step, path = found[-1]
    state = torch.load(path, map_location="cpu", weights_only=True)
    trainer.model.load_state_dict(state["model"])
    trainer.optimizer.load_state_dict(state["optimizer"])
    trainer.generator.set_state(state["generator"])
    trainer.step = int(state["step"])
    return state["data_state"]
