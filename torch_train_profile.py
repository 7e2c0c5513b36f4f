#!/usr/bin/env python3
"""Where an s2t train update's time goes on the card, for the PyTorch port.

    python3 torch_train_profile.py

Builds the train step of ``chip_smoke.py``'s train phase (SpeechT5-Base ASR
at full width, random weights from a seed, bf16, the recipe's loss weights,
accum 2 x batch 16 of 8-16 s utterances) once with the train-attention and
conv kernels on and once with the flags off (the plain PyTorch path), times
one update (median of 3, after one warm-up update), then profiles one more
with ``torch.profiler``.  Prints one JSON line per path: update wall time
(host clock, ending in a synchronize), the card's busy time (the union of
the kernels' intervals in the trace) and idle share, launches of the port's
kernels and the kernels that take the most device time.  Prints the card's
name and power limit first.  Needs a card.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as S
from speecht5_tpu_torch import config as C
from speecht5_tpu_torch.models.speecht5 import init_model
from speecht5_tpu_torch.ops import cuda_kernels as K
from speecht5_tpu_torch.train.trainer import Trainer, TrainConfig

REPS = 3


def busy_ms(prof) -> float:
    """Union of the device kernels' intervals (overlaps counted once)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    total, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def profile_path(kernels: bool, seed: int = 0):
    cfg = C.replace(C.speecht5_base_asr(), dtype="bfloat16", **S.DICT_CFG)
    if kernels:
        cfg = C.apply_overrides(cfg, S.TRAIN_OVERRIDES)
    torch.manual_seed(seed)
    model = init_model(cfg, torch.Generator().manual_seed(seed), "cuda")
    trainer = Trainer(model, "s2t", TrainConfig(ctc_weight=0.5, accum_steps=2),
                      generator=torch.Generator().manual_seed(seed + 7))
    mbs = [S.synthetic_batch(cfg, 16, seed=seed + 100 * m) for m in range(2)]
    trainer.train_step(mbs)
    walls = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_step(mbs)
        float(m["loss"])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    K.reset_launch_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(mbs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name][0] += evt.time_range.elapsed_us() / 1e3
            by_name[evt.name][1] += 1
    busy = busy_ms(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]
    return {
        "path": "kernels" if kernels else "plain", "accum": 2, "batch": 16,
        "update_wall_ms_median": float(np.median(walls)), "update_wall_ms_reps": walls,
        "profiled_wall_ms": wall_ms, "device_busy_ms": busy,
        "device_idle_share": (1.0 - busy / wall_ms) if busy else None,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": K.launch_counts(),
        "top_kernels": [{"name": n[:90], "ms": v[0], "count": v[1]} for n, v in top],
    }


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_train_profile: needs an NVIDIA card")
    print(S.card_line(), flush=True)
    for kernels in (True, False):
        torch.cuda.reset_peak_memory_stats()
        print(json.dumps(profile_path(kernels)), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
