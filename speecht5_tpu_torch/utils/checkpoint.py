"""Checkpoints in the port's own ``torch.save`` format, and the state-dict
operations of fine-tuning (port of ``speecht5_tpu/utils/checkpoint.py``).

    <save_dir>/checkpoint_<step>.pt

A train checkpoint holds the model and optimizer state, the update count,
the data position and the host generators' states (one per data rank);
a model-only one
(``save_model_only``, the converters' output, JAX :166) holds the update
count and the model state alone.  Either restores into a model through
``restore_model`` (JAX :173).  A file is written under a temporary name and
renamed into place, so a half-written checkpoint is never read; the newest
``keep_last`` stay.  ``partial_load`` (the non-strict, module-filtered warm
start of ``--finetune-from``), ``prune_for_task`` and
``average_checkpoints`` work on state dicts (JAX :193, :246, :258).

Across processes (a data-, FSDP- or tensor-parallel trainer) every rank
calls ``save_checkpoint``: the split parameters and AdamW moments are
gathered whole (``full_tensor``), the optimizer state keyed by parameter
name, and rank 0 alone writes.  ``restore_latest`` loads such a file into
any topology, one process included, each rank taking its own part of
every split tensor, as JAX's checkpoints are topology-free.  A JAX
(orbax) checkpoint converts to this format with the top-level
``convert_jax_checkpoint.py``, which runs where JAX does.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import torch

from ..parallel import distributed as D

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
    path = d / f"checkpoint_{step}.pt"
    if not D.is_primary():
        return path
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / f".{path.name}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    for _, old in checkpoints(d)[:-max(keep_last, 1)]:
        old.unlink()
    return path


def _full(t):
    """A whole CPU copy of ``t``: a split tensor's parts all-gathered over
    each mesh dim it is split on, on the card over NCCL and through the
    host over gloo (chunks padded to one size, as ``torch.chunk`` cuts
    them)."""
    if not hasattr(t, "device_mesh"):
        return t.detach().cpu()
    import torch.distributed as dist

    mesh, out = t.device_mesh, t.to_local().detach()
    for i, pl in enumerate(t.placements):
        if not pl.is_shard():
            continue
        group, n, dim = mesh.get_group(i), mesh.size(i), pl.dim
        local = out if dist.get_backend(group) == "nccl" else out.cpu()
        size, chunk = t.shape[dim], -(-t.shape[dim] // n)
        if local.shape[dim] < chunk:
            pad = list(local.shape)
            pad[dim] = chunk - local.shape[dim]
            local = torch.cat([local, local.new_zeros(pad)], dim)
        parts = [torch.empty_like(local) for _ in range(n)]
        dist.all_gather(parts, local.contiguous(), group=group)
        out = torch.cat(parts, dim).narrow(dim, 0, size)
    return out.cpu()


def _names(trainer) -> dict:
    return {id(p): n for n, p in trainer.named}


def _opt_params(optimizer) -> list:
    return [p for g in optimizer.param_groups for p in g["params"]]


def model_state(model) -> dict:
    """The model's state dict, every tensor whole, on the CPU."""
    return {k: _full(v) for k, v in model.state_dict().items()}


def optimizer_state(trainer) -> dict:
    """The optimizer's state keyed by parameter name, every tensor whole."""
    names, params = _names(trainer), _opt_params(trainer.optimizer)
    sd = trainer.optimizer.state_dict()
    return {
        "state": {names[id(params[i])]: {k: _full(v) for k, v in st.items()}
                  for i, st in sd["state"].items()},
        "param_groups": [{**{k: v for k, v in g.items() if k != "params"},
                          "params": [names[id(params[i])] for i in g["params"]]}
                         for g in sd["param_groups"]],
    }


def save_checkpoint(save_dir, trainer, *, data_state=None,
                    keep_last: int = 10) -> Path:
    """Write the trainer's state at its current step; prune old files.
    Every rank calls it; rank 0 writes."""
    state = {
        "step": trainer.step,
        "model": model_state(trainer.model),
        "optimizer": optimizer_state(trainer),
        "generator": trainer.generator.get_state(),
        "generators": D.gather_data_objects(trainer.generator.get_state(),
                                            trainer.mesh),
        "data_state": dict(data_state or {}),
    }
    return _write(save_dir, trainer.step, state, keep_last)


def _local_part(full, like):
    """This rank's part of ``full`` where ``like`` is split (the chunks
    ``torch.chunk`` gives along each split dim), as a tensor of ``like``'s
    kind; ``full`` itself where it is whole."""
    if not hasattr(like, "device_mesh"):
        return full
    from torch.distributed.tensor import DTensor

    mesh, t = like.device_mesh, full
    coords = mesh.get_coordinate()
    for i, pl in enumerate(like.placements):
        if pl.is_shard():
            chunks = torch.chunk(t, mesh.size(i), dim=pl.dim)
            t = (chunks[coords[i]] if coords[i] < len(chunks)
                 else t.narrow(pl.dim, 0, 0))
    return DTensor.from_local(t.to(like.to_local().device).contiguous(), mesh,
                              like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def load_model_state(model, state: dict) -> None:
    """Copy a whole state dict into ``model``, split or not."""
    own = model.state_dict()
    missing = set(own) ^ set(state)
    if missing:
        raise KeyError(f"state dict keys differ: {sorted(missing)[:8]}")
    with torch.no_grad():
        for k, t in own.items():
            src = state[k]
            if hasattr(t, "device_mesh"):
                t.to_local().copy_(_local_part(src, t).to_local())
            else:
                t.copy_(src)


def load_optimizer_state(trainer, state: dict) -> None:
    """Load a name-keyed optimizer state (or an index-keyed one from
    ``optimizer.state_dict()``) into the trainer's optimizer."""
    if not state["state"] or isinstance(next(iter(state["state"])), int):
        trainer.optimizer.load_state_dict(state)
        return
    names, params = _names(trainer), _opt_params(trainer.optimizer)
    index = {names[id(p)]: i for i, p in enumerate(params)}
    hyper = {k: v for k, v in state["param_groups"][0].items()
             if k not in ("params", "foreach")}
    sd = {
        "state": {index[n]: {k: (v if k == "step" else _local_part(v, params[index[n]]))
                             for k, v in st.items()}
                  for n, st in state["state"].items()},
        "param_groups": [{**g, **hyper, "params": [index[names[id(p)]] for p in g["params"]]}
                         for g in trainer.optimizer.param_groups],
    }
    trainer.optimizer.load_state_dict(sd)


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
    load_model_state(trainer.model, state["model"])
    load_optimizer_state(trainer, state["optimizer"])
    index, n = D.data_coords(trainer.mesh)
    saved = state.get("generators") or [state["generator"]]
    if len(saved) == n:
        trainer.generator.set_state(saved[index])
    else:
        # another number of data ranks: each rank's stream from rank 0's
        # state and its index
        g = torch.Generator()
        g.set_state(saved[0])
        trainer.generator.manual_seed(int(torch.randint(2 ** 62, (), generator=g)) + index)
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
