#!/usr/bin/env python3
"""Where a train update's time goes on the card, for the PyTorch port.

    python3 torch_train_profile.py [--task s2t|t2s|s2s|s2c|all]

s2t (the default) builds the train step of ``chip_smoke.py``'s train phase
(SpeechT5-Base ASR at full width, random weights from a seed, bf16, the
recipe's loss weights, accum 2 x batch 16 of 8-16 s utterances); t2s that of
its t2s phase (SpeechT5-Base at full width, bf16, guided attention, batch 16
of 2-10 s utterances with x-vectors, 768 mel frames and 192 token slots);
s2s that of its s2s phase (SpeechT5-Base, bf16, guided attention, batch 8
of 2-6 s source / target pairs with x-vectors); s2c that of its s2c phase
(speecht5_base_sid, 8 classes, bf16, accum 2 x batch 8 of 4-10 s
utterances cropped to 8 s).  Each is built once with the kernels on (s2t,
s2s, s2c: train attention and conv stack, the conv's backward the twin's
vjp; t2s and s2s: the log-mel kernel making the targets from the waveform
inside the update) and once with the flags off (the plain PyTorch path;
for t2s and s2s the log-mel twin makes the targets on the card inside the
update, in the kernel's place, with TF32 off),
times one update (median of 3, after one warm-up update), then profiles one
more with ``torch.profiler``.  Prints one JSON line per path: update wall time
(host clock, ending in a synchronize), the card's busy time (the union of
the kernels' intervals in the trace) and idle share, launches of the port's
kernels, the device time of the train attention's forward and backward
kernels (by kernel and in all), of the device copies (kernels and memcpys
named copy: the band copies show there) and the kernels that take the most
device time.  Prints the card's name and power limit first.  Needs a card.
The kernel names are matched as both this tree and the one before the
attention forwards moved to wgmma name them, so one copy of this script
profiles either.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from collections import defaultdict
from unittest import mock

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as S
from speecht5_tpu_torch import config as C
from speecht5_tpu_torch.models.speecht5 import init_model
from speecht5_tpu_torch.ops import cuda_kernels as K
from speecht5_tpu_torch.train import trainer as T
from speecht5_tpu_torch.train.trainer import Trainer, TrainConfig

REPS = 3
# the attention kernels, by a piece of the name the trace gives them.
# Forward: bf16 the bias pass and main loop of csrc/banded_attention_fwd.cu,
# f32 (and bf16 before it) the CUDA-core kernels of csrc/banded_attention.cu
# and csrc/banded_attention_train.cu.  Backward: bf16 the four launches of
# csrc/banded_attention_train_bwd.cu (its bias pass untemplated before the
# forward shared it), f32 the two CUDA-core kernels.
ATTN_FWD_KERNELS = {"bias_pass": "::bias_kernel<false>(", "main_loop": "::main_kernel<",
                    "cuda_core_train": "::fwd_kernel<",
                    "cuda_core_inference": "::banded_attn_kernel<"}
ATTN_BWD_KERNELS = {"bias_pass": "::bias_kernel<true>(", "bias_pass_untemplated": "::bias_kernel(",
                    "dq_main": "::dq_kernel(", "band_pass": "::band_kernel(",
                    "dkv_main": "::dkv_kernel(", "cuda_core_dq": "::bwd_dq_kernel<",
                    "cuda_core_dkv": "::bwd_dkv_kernel<"}


def kernel_ms(by_name, patterns: dict) -> dict:
    """Device ms of the kernels whose names hold each pattern, in all and
    by label (labels with no time left out)."""
    ms = {label: sum(v[0] for n, v in by_name.items() if pat in n)
          for label, pat in patterns.items()}
    return {"total": sum(ms.values()), **{k: v for k, v in ms.items() if v}}


def copies(by_name) -> dict:
    """Device ms and count of the copies: kernels and memcpys named copy."""
    hits = [v for n, v in by_name.items() if "copy" in n.lower()]
    return {"ms": sum(v[0] for v in hits), "count": sum(v[1] for v in hits)}


def device_events(prof):
    """The device's kernels and copies in the trace; user annotations that
    PyTorch also puts on the device timeline (e.g. "Optimizer.step#AdamW.step",
    a span around many kernels) are not device work and are left out."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def busy_ms(prof) -> float:
    """Union of the device kernels' intervals (overlaps counted once)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in device_events(prof))
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


def _step_inputs(task: str, kernels: bool, seed: int):
    """(cfg, TrainConfig, micro-batches) of the task's chip_smoke phase."""
    if task == "s2t":
        cfg = C.replace(C.speecht5_base_asr(), dtype="bfloat16", **S.DICT_CFG)
        if kernels:
            cfg = C.apply_overrides(cfg, S.TRAIN_OVERRIDES)
        mbs = [S.synthetic_batch(cfg, 16, seed=seed + 100 * m) for m in range(2)]
        return cfg, TrainConfig(ctc_weight=0.5, accum_steps=2), mbs
    if task == "s2s":
        cfg = C.replace(C.speecht5_base(), dtype="bfloat16")
        if kernels:
            cfg = C.apply_overrides(cfg, S.TRAIN_OVERRIDES)
        b = S._on(S.synthetic_s2s_batch(cfg, 8, seed=seed), "cuda")
        return cfg, TrainConfig(use_guided_attn=True, warmup_steps=6000), [b]
    if task == "s2c":
        cfg = C.speecht5_base_sid(num_classes=S.SID_SPEAKERS, dtype="bfloat16")
        if kernels:
            cfg = C.apply_overrides(cfg, S.TRAIN_OVERRIDES)
        mbs = [S._on(S.synthetic_s2c_batch(8, seed=seed + 100 * m), "cuda") for m in range(2)]
        return cfg, TrainConfig(lr=2e-4, warmup_steps=2000, accum_steps=2), mbs
    cfg = C.replace(C.speecht5_base(), dtype="bfloat16", **S.DICT_CFG)
    if kernels:
        cfg = C.apply_overrides(cfg, S.T2S_OVERRIDES)
    b = S.synthetic_t2s_batch(cfg, 16, seed=seed)
    return cfg, TrainConfig(use_guided_attn=True, warmup_steps=10000), [b]


def profile_path(task: str, kernels: bool, seed: int = 0):
    """One path's record; the plain t2s and s2s paths run with the log-mel
    twin in the kernel's place inside the update."""
    with (contextlib.nullcontext() if kernels or task not in ("t2s", "s2s") else
          mock.patch.object(T, "fused_log_mel", K.fused_log_mel_plain)):
        return _profile_path(task, kernels, seed)


def _profile_path(task: str, kernels: bool, seed: int):
    torch.manual_seed(seed)
    cfg, tcfg, mbs = _step_inputs(task, kernels, seed)
    model = init_model(cfg, torch.Generator().manual_seed(seed), "cuda")
    trainer = Trainer(model, task, tcfg,
                      generator=torch.Generator().manual_seed(seed + 7))
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
    for evt in device_events(prof):
        by_name[evt.name][0] += evt.time_range.elapsed_us() / 1e3
        by_name[evt.name][1] += 1
    busy = busy_ms(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]
    return {
        "task": task, "path": "kernels" if kernels else "plain",
        "accum": tcfg.accum_steps, "batch": next(iter(mbs[0].values())).shape[0],
        "update_wall_ms_median": float(np.median(walls)), "update_wall_ms_reps": walls,
        "profiled_wall_ms": wall_ms, "device_busy_ms": busy,
        "device_idle_share": (1.0 - busy / wall_ms) if busy else None,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": K.launch_counts(),
        "attention_forward_ms": kernel_ms(by_name, ATTN_FWD_KERNELS),
        "attention_backward_ms": kernel_ms(by_name, ATTN_BWD_KERNELS),
        "copies": copies(by_name),
        "top_kernels": [{"name": n[:90], "ms": v[0], "count": v[1]} for n, v in top],
    }


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--task", default="s2t", choices=("s2t", "t2s", "s2s", "s2c", "all"))
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_train_profile: needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(S.card_line(), flush=True)
    for task in (("s2t", "t2s", "s2s", "s2c") if args.task == "all" else (args.task,)):
        for kernels in (True, False):
            torch.cuda.reset_peak_memory_stats()
            print(json.dumps(profile_path(task, kernels)), flush=True)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
