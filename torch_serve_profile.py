#!/usr/bin/env python3
"""Where a served request's time goes on the card, for the PyTorch port.

    python3 torch_serve_profile.py

Builds the same Service as ``chip_smoke.py``'s serve phase (SpeechT5-Base
ASR, ctc_greedy, batch 1, random weights from a seed, buckets 4/8/16 s) once
with both CUDA kernels on (bf16) and once with the flags off (the plain
PyTorch path, bf16), times ``Service.transcribe`` on one 16 s request
(median of 3), then profiles one more with ``torch.profiler``.  Prints one
JSON line per path: request wall time (host clock, ending in a
synchronize), the card's busy time (sum of kernel times in the trace) and
idle share, and the kernels that take the most device time.  Prints the
card's name and power limit first.  Needs a card.
"""

from __future__ import annotations

import json
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as S
from speecht5_tpu_torch import config as C
from speecht5_tpu_torch.models.speecht5 import init_model
from speecht5_tpu_torch.ops import cuda_kernels as K

REQUEST_S = 16.0   # the largest bucket: one full chunk
REPS = 3


def profile_path(kernels: bool, seconds: float, reps: int, seed: int = 0):
    cfg = S.serve_config(C.speecht5_base_asr(), "bfloat16", kernels=kernels)
    model = init_model(cfg, torch.Generator().manual_seed(seed), "cuda")
    with tempfile.TemporaryDirectory() as d:
        svc = S.make_service(cfg, model, S.write_dictionary(d), "cuda", "4,8,16")
    wav = S.synth_audio(seconds, seed=300)
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.transcribe(wav)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    K.reset_launch_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.transcribe(wav)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name][0] += evt.time_range.elapsed_us() / 1e3
            by_name[evt.name][1] += 1
    busy_ms = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "path": "kernels" if kernels else "plain", "request_s": seconds,
        "wall_ms_median": float(np.median(walls)), "wall_ms_reps": walls,
        "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
        "launches": K.launch_counts(),
        "top_kernels": [{"name": n[:90], "ms": v[0], "count": v[1]} for n, v in top],
    }


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_serve_profile: needs an NVIDIA card")
    print(S.card_line(), flush=True)
    for kernels in (True, False):
        print(json.dumps(profile_path(kernels, REQUEST_S, REPS)), flush=True)


if __name__ == "__main__":
    main()
