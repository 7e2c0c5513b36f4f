"""Checkpoints in the port's own ``torch.save`` format, and the state-dict
operations of fine-tuning (port of ``speecht5_tpu/utils/checkpoint.py``).

    <save_dir>/checkpoint_<step>.pt

A train checkpoint holds the model and optimizer state, the update count,
the data position and the host generator's state; a model-only one
(``save_model_only``, the converters' output, JAX :166) holds the update
count and the model state alone.  Either restores into a model through
``restore_model`` (JAX :173).  A file is written under a temporary name and
renamed into place, so a half-written checkpoint is never read; the newest
``keep_last`` stay.  ``partial_load`` (the non-strict, module-filtered warm
start of ``--finetune-from``), ``prune_for_task`` and
``average_checkpoints`` work on state dicts (JAX :193, :246, :258).  A JAX
(orbax) checkpoint converts to this format with the top-level
``convert_jax_checkpoint.py``, which runs where JAX does.
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


def _write(save_dir, step: int, state: dict, keep_last: int) -> Path:
    d = Path(save_dir)
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"checkpoint_{step}.pt"
    tmp = d / f".{path.name}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    for _, old in checkpoints(d)[:-max(keep_last, 1)]:
        old.unlink()
    return path


def save_checkpoint(save_dir, trainer, *, data_state=None,
                    keep_last: int = 10) -> Path:
    """Write the trainer's state at its current step; prune old files."""
    return _write(save_dir, trainer.step, {
        "step": trainer.step,
        "model": trainer.model.state_dict(),
        "optimizer": trainer.optimizer.state_dict(),
        "generator": trainer.generator.get_state(),
        "data_state": dict(data_state or {}),
    }, keep_last)


def save_model_only(save_dir, state_dict: dict, step: int = 0,
                    keep_last: int = 10) -> Path:
    """Write a model-only checkpoint (weights, no train state): what the
    converters write and ``--finetune-from`` and serving read."""
    return _write(save_dir, step, {"step": step, "model": dict(state_dict)}, keep_last)


def restore_model(save_dir, step=None):
    """The model state of the checkpoint at ``step`` (the newest when None)
    in ``save_dir``, train or model-only -> (state_dict, step), or (None,
    None) when there is none."""
    found = dict(checkpoints(save_dir))
    if not found:
        return None, None
    step = max(found) if step is None else step
    state = torch.load(found[step], map_location="cpu", weights_only=True)
    return state["model"], step


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


def partial_load(target: dict, source: dict, include_modules=None,
                 exclude_modules=None, strict_shapes: bool = False) -> dict:
    """Merge ``source`` into ``target`` (state dicts), key by key, filtered
    by top-level module (``include_modules`` / ``exclude_modules``, the
    reference's --finetune-from-modules / --finetune-out-of-modules); a key
    that ``source`` lacks keeps the target's value, and so does one whose
    shape differs (the reference's pruning of a dictionary-size mismatch),
    unless ``strict_shapes``, which raises (JAX :193)."""
    out = {}
    for key, tgt in target.items():
        top = key.split(".")[0]
        src = source.get(key)
        if (src is None or (include_modules and top not in include_modules)
                or (exclude_modules and top in exclude_modules)):
            out[key] = tgt
        elif tuple(src.shape) != tuple(tgt.shape):
            if strict_shapes:
                raise ValueError(f"shape mismatch at {key}: {tuple(src.shape)} "
                                 f"vs {tuple(tgt.shape)}")
            out[key] = tgt
        else:
            out[key] = src
    return out


# per fine-tune task, the top-level modules it uses (reference
# models/speecht5.py:1060-1120 prune_modules); the others are dropped
TASK_MODULES = {
    "s2t": ("speech_encoder_prenet", "encoder", "decoder",
            "text_decoder_prenet", "text_decoder_postnet"),
    "t2s": ("text_encoder_prenet", "encoder", "decoder",
            "speech_decoder_prenet", "speech_decoder_postnet"),
    "s2s": ("speech_encoder_prenet", "encoder", "decoder",
            "speech_decoder_prenet", "speech_decoder_postnet"),
    "s2c": ("speech_encoder_prenet", "encoder", "decoder",
            "text_decoder_prenet", "speaker_decoder_postnet"),
}


def prune_for_task(state_dict: dict, task: str) -> dict:
    """Drop the top-level modules the fine-tune task never uses (JAX :246)."""
    keep = TASK_MODULES[task]
    return {k: v for k, v in state_dict.items() if k.split(".")[0] in keep}


def average_checkpoints(state_dicts: list) -> dict:
    """Uniform average of state dicts with the same keys (JAX :258): each
    sum in float64, cast back to the first's dtype, then divided by their
    count in that dtype, as the JAX function computes it."""
    n = len(state_dicts)
    out = {}
    for key, first in state_dicts[0].items():
        total = sum(sd[key].double() for sd in state_dicts)
        out[key] = (total.to(first.dtype) / n).to(first.dtype)
    return out
