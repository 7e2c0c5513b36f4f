#!/usr/bin/env python3
"""Where a served request's time goes on the card, for the PyTorch port.

    python3 torch_serve_profile.py [--decoder ctc_greedy|beam]
    python3 torch_serve_profile.py --decode-step-kernel

Builds the same Service as ``chip_smoke.py``'s serve phases (SpeechT5-Base
ASR, batch 1, random weights from a seed, buckets 4/8/16 s; ``beam``: beam
5, max_len 200, CTC weight 0.3) once with every CUDA kernel of the path on
(bf16; the beam adds ``decoder.use_pallas_attn``) and once with the flags
off (the plain PyTorch path, bf16), times ``Service.transcribe`` on one
16 s request (median of 3), then profiles one more with ``torch.profiler``.
Prints one JSON line per path: request wall time (host clock, ending in a
synchronize), decode steps (beam), the card's busy time (the union of the
device kernels' intervals in the trace, as ``torch_train_profile.py``
counts it) and idle share, the launches of each kernel, every device
launch of the profiled request (kernels, copies, fills) and their number
per decode step, the device time of the attention forward's kernels, of
the decode-step attention's and of the copies, and the kernels that take
the most device time.  Prints the card's name and power limit first.
With ``--decode-step-kernel`` it prints instead ``chip_smoke.py``'s record
of the decode-step attention at the beam's shapes in bf16 (kernel against
twin; stream and CUDA-graph times of the kernel and of its SDPA yardstick):
cross and self through ``flash_attention_bias``, and cross_cached and
self_cache through ``flash_attention_bias_cached`` where the tree has it.
Needs a card.  The kernel names it matches are those of this tree and of
the trees before the decode-step kernel's cluster design, so a copy of this
script profiles an archive of an earlier commit in the same call.
"""

from __future__ import annotations

import argparse
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
from torch_train_profile import ATTN_FWD_KERNELS, busy_ms, copies, device_events, kernel_ms

REQUEST_S = 16.0   # the largest bucket: one full chunk
REPS = 3
DECODE_STEP_KERNELS = {"cluster_split": "::flash_split_kernel<",
                       "single_block": "::flash_bias_kernel<"}


def profile_path(decoder: str, kernels: bool, seconds: float, reps: int,
                 seed: int = 0):
    overrides = S.BEAM_OVERRIDES if decoder == "beam" else S.KERNEL_OVERRIDES
    cfg = S.serve_config(C.speecht5_base_asr(), "bfloat16", kernels=kernels,
                         overrides=overrides)
    model = init_model(cfg, torch.Generator().manual_seed(seed), "cuda")
    with tempfile.TemporaryDirectory() as d:
        svc = S.make_service(cfg, model, S.write_dictionary(d), "cuda", "4,8,16",
                             decoder=decoder)
    wav = S.synth_audio(seconds, seed=300)
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.transcribe(wav)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    K.reset_launch_counts()
    steps0 = getattr(svc.asr, "steps_run", 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.transcribe(wav)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = defaultdict(lambda: [0.0, 0])
    events = device_events(prof)
    for evt in events:
        by_name[evt.name][0] += evt.time_range.elapsed_us() / 1e3
        by_name[evt.name][1] += 1
    busy = busy_ms(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    steps = getattr(svc.asr, "steps_run", 0) - steps0
    return {
        "decoder": decoder, "path": "kernels" if kernels else "plain",
        "request_s": seconds, "wall_ms_median": float(np.median(walls)),
        "wall_ms_reps": walls, "profiled_wall_ms": wall_ms,
        "decode_steps": steps,
        "device_busy_ms": busy,
        "device_launches": len(events),
        "device_launches_per_step": len(events) / steps if steps else None,
        "device_idle_share": (1.0 - busy / wall_ms) if busy else None,
        "launches": K.launch_counts(),
        "attention_forward_ms": kernel_ms(by_name, ATTN_FWD_KERNELS),
        "decode_step_attention_ms": kernel_ms(by_name, DECODE_STEP_KERNELS),
        "copies": copies(by_name),
        "top_kernels": [{"name": n[:90], "ms": v[0], "count": v[1]} for n, v in top],
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--decoder", default="ctc_greedy", choices=("ctc_greedy", "beam"))
    p.add_argument("--decode-step-kernel", action="store_true",
                   help="time the decode-step attention at the beam's shapes")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_serve_profile: needs an NVIDIA card")
    print(S.card_line(), flush=True)
    if args.decode_step_kernel:
        cases = ["cross", "self"]
        if hasattr(K, "flash_attention_bias_cached"):
            cases += ["cross_cached", "self_cache"]
        for case in cases:
            ok, rec = S._flash_bias_record(case, torch.bfloat16)
            print(json.dumps({"decode_step_kernel": case, "ok": ok, **rec}), flush=True)
        return
    for kernels in (True, False):
        print(json.dumps(profile_path(args.decoder, kernels, REQUEST_S, REPS)),
              flush=True)


if __name__ == "__main__":
    main()
