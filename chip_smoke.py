#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``speecht5_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each timed; any failure raises and the exit code is non-zero:

1. build    -- compile both CUDA kernels with nvcc for sm_90a from the
               sources in this checkout (ops/cuda_kernels.build_all).
2. kernels  -- hold each kernel against its plain PyTorch twin on the card at
               SpeechT5-Base shapes (batch 1, as a served 16 s chunk gives
               them, and batch 2), in f32 and bf16; time kernel, twin and
               one PyTorch library call that computes the same function.
3. serve    -- the main path: the port's ASR Service (ctc_greedy, bf16, both
               kernels on) at full speecht5_base_asr width with random
               weights, warming the 4/8/16 s buckets and answering 3 s, 11 s
               and 21 s requests in process (the 21 s one is chunked).  The
               kernels' launch counts are zeroed just before the requests and
               read just after; a kernel that was never launched fails.
4. parity   -- the same f32 weights through the Service path with the
               kernels and with the flags off: the CTC frame ids must agree
               (a differing frame is tolerated only where the top-2 logit gap
               is < 1e-4, and on under 0.1% of frames).

Output: an early line with the card's name and power limit as nvidia-smi
gives them, one ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.  A watchdog ends a hung run with a
traceback after 600 s.  The script opens no socket and starts no thread.
"""

from __future__ import annotations

import faulthandler
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from speecht5_tpu_torch import config as C
from speecht5_tpu_torch.cli.serve import SR, Service, build_parser
from speecht5_tpu_torch.models.attention import band_from_table
from speecht5_tpu_torch.models.speecht5 import init_model
from speecht5_tpu_torch.ops import cuda_kernels as K

WATCHDOG_S = 600
# published peaks of one H100 SXM (dense): bf16 tensor cores, f32 outside
# the tensor cores, and HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
KERNELS = {
    "banded_flash_attention": {
        "source": "speecht5_tpu_torch/csrc/banded_attention.cu",
        "replaces": "speecht5_tpu/ops/pallas_kernels.py:253",
    },
    "conv_stack": {
        "source": "speecht5_tpu_torch/csrc/conv_stack.cu",
        "replaces": "speecht5_tpu/ops/pallas_kernels.py:753",
    },
}
KERNEL_OVERRIDES = ["encoder.use_pallas_attn=True", "conv_features.impl='pallas'"]
# letter dictionary: 4 specials + 75 symbols + <mask> + <ctc_blank> = 81
DICT_SYMBOLS = (["|", "'"] + [chr(ord("A") + i) for i in range(26)]
                + [f"x{i}" for i in range(47)])
DICT_CFG = {"vocab_size": 81, "blank_id": 80}
TOL_F32 = 1e-4          # absolute
TOL_BF16_REL = 3e-2     # max |diff| / max |ref|


def log(msg):
    print(msg, flush=True)


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, timeout=60)


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card."""
    out = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def environment_line() -> str:
    drv = _run(["nvidia-smi", "--query-gpu=driver_version",
                "--format=csv,noheader"]).stdout.strip().splitlines()[0]
    try:
        nvcc = K.find_nvcc()
        nvcc_ver = _run([nvcc, "--version"]).stdout.strip().splitlines()[-1]
    except RuntimeError as e:
        nvcc, nvcc_ver = None, str(e)
    return json.dumps({
        "torch": torch.__version__, "torch_cuda": torch.version.cuda,
        "driver": drv, "nvcc": nvcc, "nvcc_version": nvcc_ver,
        "python": sys.version.split()[0],
    })


def write_dictionary(directory: str) -> str:
    path = os.path.join(directory, "dict.ltr.txt")
    with open(path, "w", encoding="utf-8") as f:
        for i, sym in enumerate(DICT_SYMBOLS):
            f.write(f"{sym} {1000 - i}\n")
    return path


def serve_config(base: C.SpeechT5Config, dtype: str, kernels: bool):
    cfg = C.replace(base, dtype=dtype, **DICT_CFG)
    return C.apply_overrides(cfg, KERNEL_OVERRIDES) if kernels else cfg


def make_service(cfg, model, dict_path, device, buckets):
    args = build_parser().parse_args([
        "--ckpt", "random-init", "--dict", dict_path,
        "--decoder", "ctc_greedy", "--max-batch", "1",
        "--asr-buckets", buckets, "--dtype", cfg.dtype,
    ])
    return Service(args, model=model, cfg=cfg, device=device)


def synth_audio(seconds: float, seed: int) -> np.ndarray:
    """Deterministic speech-like test signal: a few gliding tones + noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    wav = 0.02 * rng.standard_normal(t.shape)
    for _ in range(4):
        f0, f1 = rng.uniform(100, 3000, size=2)
        wav += 0.1 * np.sin(2 * np.pi * (f0 * t + (f1 - f0) * t * t / (2 * t[-1])))
    return wav.astype(np.float32)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ------------------------------------------------------------------ build


def phase_build():
    t0 = time.perf_counter()
    libs = K.build_all()
    secs = time.perf_counter() - t0
    log(json.dumps({"phase": "build", "seconds": secs,
                    "libraries": {n: str(p) for n, p in libs.items()}}))
    return secs


# ---------------------------------------------------------------- kernels


def time_ms(fn, reps: int = 20) -> float:
    """Median of ``reps`` single-call CUDA-event timings after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _bound(nbytes: float, flops: float, dtype):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _check(dtype, got, ref):
    err = (got.float() - ref.float()).abs().max().item()
    if dtype == torch.float32:
        ok, tol = err <= TOL_F32, f"atol {TOL_F32}"
    else:
        scale = ref.float().abs().max().item()
        ok, tol = err <= TOL_BF16_REL * scale, f"{TOL_BF16_REL} x max|ref| = {TOL_BF16_REL * scale:.4g}"
    if not torch.isfinite(got.float()).all():
        ok = False
    return err, tol, ok


def attention_case(batch, dtype, device="cuda", seed=0):
    """Base encoder shapes: batch x 12 heads, T=799 (16 s bucket), Dh=64,
    max distance 160, ragged lengths including a row of length 0."""
    g = torch.Generator().manual_seed(seed)
    N, T, Dh, M = 12 * batch, 799, 64, 160
    q = (torch.randn(N, T, Dh, generator=g) * Dh ** -0.5).to(dtype)
    k = torch.randn(N, T, Dh, generator=g).to(dtype)
    v = torch.randn(N, T, Dh, generator=g).to(dtype)
    table = (torch.randn(2 * M, Dh, generator=g) * 0.125).to(dtype)
    band = band_from_table(table, T, M).contiguous()
    lengths = torch.randint(1, T + 1, (N,), generator=g, dtype=torch.int32)
    lengths[0], lengths[1], lengths[5] = 0, T, 613
    return [t.to(device) for t in (q, k, v, band, lengths)]


def conv_case(batch, dtype, device="cuda", seed=1):
    """Base feature-extractor layers 1-6 on the 16 s bucket after conv 0:
    x [batch, 51199, 512], (k, s) = (3, 2) x 4, (2, 2) x 2."""
    g = torch.Generator().manual_seed(seed)
    specs = ((3, 2),) * 4 + ((2, 2),) * 2
    x = torch.randn(batch, 51199, 512, generator=g).to(dtype)
    ws = [(torch.randn(k, 512, 512, generator=g) / (k * 512) ** 0.5).to(dtype)
          for k, _ in specs]
    return x.to(device), [w.to(device) for w in ws], specs


def _attention_record(batch, dtype):
    q, k, v, band, lengths = attention_case(batch, dtype)
    N, T, Dh = q.shape
    got = K.banded_flash_attention(q, k, v, band, lengths)
    ref = K.banded_flash_attention_plain(q, k, v, band, lengths)
    torch.cuda.synchronize()
    err, tol, ok = _check(dtype, got, ref)
    keep = torch.arange(T, device=q.device)[None, None, :] < lengths[:, None, None]
    bias = torch.einsum("nqd,dqk->nqk", q.float(), band.float())
    mask = torch.where(keep, bias, torch.full((), K.NEG_INF, device=q.device)).to(dtype)
    # bytes: q, k, v, out and the band once; flops: q.k, q.band and p.v
    # over the valid keys
    nbytes = (4 * N * T * Dh + Dh * T * T) * q.element_size() + 4 * N
    flops = 6.0 * T * Dh * lengths.double().sum().item()
    bound_ms, bound_by = _bound(nbytes, flops, dtype)
    return ok, {
        "max_abs_err": err, "tolerance": tol,
        "ms": time_ms(lambda: K.banded_flash_attention(q, k, v, band, lengths)),
        "plain_ms": time_ms(lambda: K.banded_flash_attention_plain(q, k, v, band, lengths)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=1.0)),
        "library_call": "F.scaled_dot_product_attention(attn_mask=bias+mask)",
        "bound_ms": bound_ms, "bound_by": bound_by,
        "shape": {"N": N, "T": T, "Dh": Dh},
    }


def _conv_record(batch, dtype):
    x, ws, specs = conv_case(batch, dtype)
    got = K.conv_stack(x, ws, specs)
    ref = K.conv_stack_plain(x, ws, specs)
    torch.cuda.synchronize()
    err, tol, ok = _check(dtype, got, ref)
    B, t, _ = x.shape
    flops = 0.0
    for (k, s), w in zip(specs, ws):
        t = (t - k) // s + 1
        flops += 2.0 * B * t * k * w.shape[1] * w.shape[2]
    # bytes: x, the weights and the final output once (not the intermediates)
    nbytes = (x.numel() + sum(w.numel() for w in ws) + got.numel()) * x.element_size()
    bound_ms, bound_by = _bound(nbytes, flops, dtype)
    xt = x.transpose(1, 2).contiguous()
    wt = [w.permute(2, 1, 0).contiguous() for w in ws]

    def library():
        y = xt
        for (_, s), w in zip(specs, wt):
            y = F.gelu(F.conv1d(y, w, stride=s))
        return y

    return ok, {
        "max_abs_err": err, "tolerance": tol,
        "ms": time_ms(lambda: K.conv_stack(x, ws, specs)),
        "plain_ms": time_ms(lambda: K.conv_stack_plain(x, ws, specs)),
        "library_ms": time_ms(library),
        "library_call": "F.conv1d + F.gelu per layer",
        "bound_ms": bound_ms, "bound_by": bound_by,
        "shape": {"B": B, "T_in": x.shape[1], "C": x.shape[2], "T_out": got.shape[1]},
    }


def phase_kernels():
    """Each kernel against its twin at batch 1 (what a served 16 s chunk
    gives it) and batch 2, in f32 and bf16.  Records are keyed
    "<dtype>/b<batch>"."""
    records = {name: {} for name in KERNELS}
    failures = []
    for batch in (1, 2):
        for dtype in (torch.float32, torch.bfloat16):
            key = f"{str(dtype).split('.')[-1]}/b{batch}"
            for name, fn in (("banded_flash_attention", _attention_record),
                             ("conv_stack", _conv_record)):
                ok, rec = fn(batch, dtype)
                records[name][key] = rec
                if not ok:
                    failures.append(f"{name} {key}: max|diff| {rec['max_abs_err']} "
                                    f"> {rec['tolerance']}")
                torch.cuda.empty_cache()
    log(json.dumps({"phase": "kernels", "records": records}))
    if failures:
        raise AssertionError("kernel disagrees with its twin: " + "; ".join(failures))
    return records


# ------------------------------------------------------------------ serve


def phase_serve(base_cfg, device="cuda", dtype="bfloat16",
                requests_s=(3, 11, 21), buckets="4,8,16", seed=0):
    """The main path: Service(ctc_greedy) with both kernels on.  Returns the
    launch counts of the request window and the per-request times."""
    cfg = serve_config(base_cfg, dtype, kernels=True)
    model = init_model(cfg, torch.Generator().manual_seed(seed), device)
    with tempfile.TemporaryDirectory() as d:
        svc = make_service(cfg, model, write_dictionary(d), device, buckets)
    wavs = [synth_audio(s, seed=100 + i) for i, s in enumerate(requests_s)]
    card = card_line() if torch.device(device).type == "cuda" else "cpu"
    _sync(device)
    K.reset_launch_counts()
    results = []
    for secs, wav in zip(requests_s, wavs):
        t0 = time.perf_counter()
        text = svc.transcribe(wav)
        _sync(device)
        results.append({"request_s": secs, "chunks": len(svc._chunk(wav)),
                        "wall_ms": (time.perf_counter() - t0) * 1e3,
                        "chars": len(text), "card": card})
    counts = K.launch_counts()
    for r in results:
        log(json.dumps({"served": r}))
    n_chunks = sum(r["chunks"] for r in results)
    if svc.asr_requests != n_chunks or max(r["chunks"] for r in results) < 2:
        raise AssertionError(f"expected {n_chunks} chunks incl. one chunked "
                             f"request, Service counted {svc.asr_requests}")
    # the served output is well formed: finite CTC logits of the right shape
    wav = np.zeros((1, svc.buckets()[0] * SR), np.float32)
    wav[0, : len(wavs[0])] = wavs[0][: wav.shape[1]]
    logits, frames = svc.asr.dec.logits(wav, [min(len(wavs[0]), wav.shape[1])])
    want = (1, cfg.conv_features.out_length(wav.shape[1]), cfg.vocab_size)
    if tuple(logits.shape) != want or not torch.isfinite(logits).all():
        raise AssertionError(f"CTC logits {tuple(logits.shape)} (want {want}) "
                             "or not finite")
    return {"counts": counts, "requests": results}


# ----------------------------------------------------------------- parity


def phase_parity(base_cfg, device="cuda", requests_s=(3, 11, 21),
                 buckets="4,8,16", seed=0, gap_tol=1e-4, max_frac=1e-3):
    """f32 weights through the Service path with the kernels and with the
    flags off; CTC frame ids must agree (see module docstring)."""
    cfg_k = serve_config(base_cfg, "float32", kernels=True)
    cfg_t = serve_config(base_cfg, "float32", kernels=False)
    model_k = init_model(cfg_k, torch.Generator().manual_seed(seed), device)
    model_t = init_model(cfg_t, torch.Generator().manual_seed(seed + 1), device)
    model_t.load_state_dict(model_k.state_dict())
    with tempfile.TemporaryDirectory() as d:
        path = write_dictionary(d)
        svc_k = make_service(cfg_k, model_k, path, device, buckets)
        svc_t = make_service(cfg_t, model_t, path, device, buckets)
    frames = differ = 0
    worst_gap = 0.0
    for i, secs in enumerate(requests_s):
        wav = synth_audio(secs, seed=200 + i)
        for chunk in svc_k._chunk(wav):
            T = svc_k._bucket_for(len(chunk))
            padded = np.zeros((1, T), np.float32)
            padded[0, : len(chunk)] = chunk
            n = [len(chunk)]
            ids_k, len_k = svc_k.asr.dec.frame_ids(padded, n)
            logits_t, len_t = svc_t.asr.dec.logits(padded, n)
            ids_t = torch.argmax(logits_t, -1).to(torch.int32).cpu().numpy()
            L = int(len_t[0])
            if int(len_k[0]) != L:
                raise AssertionError(f"frame lengths differ: {len_k} vs {L}")
            bad = np.nonzero(ids_k[0, :L] != ids_t[0, :L])[0]
            frames += L
            differ += len(bad)
            if len(bad):
                top2 = torch.topk(logits_t[0, bad], 2, dim=-1).values
                worst_gap = max(worst_gap, (top2[:, 0] - top2[:, 1]).max().item())
        if svc_k.transcribe(wav) != svc_t.transcribe(wav) and differ == 0:
            raise AssertionError("transcripts differ with equal frame ids")
    result = {"frames": frames, "differing_frames": differ,
              "max_top2_gap_at_differing": worst_gap}
    log(json.dumps({"phase": "parity", **result}))
    if differ > max_frac * frames or worst_gap >= gap_tol:
        raise AssertionError(f"CTC ids of the kernel path differ: {result}")
    return result


# ------------------------------------------------------------------- main


def kernels_line(records, counts):
    """The contract line: the served path's dtype and batch (bf16, batch 1)
    in the named keys, the other cases under "other"."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "tolerance")
    out = []
    for name, meta in KERNELS.items():
        main = records[name]["bfloat16/b1"]
        out.append({
            "name": name, "route": "cuda", "impl": "cuda", **meta,
            "launches": counts[name], **{k: main[k] for k in keys},
            "dtype": "bfloat16", "shape": main["shape"],
            "other": {case: {k: rec[k] for k in keys + ("shape",)}
                      for case, rec in records[name].items()
                      if case != "bfloat16/b1"},
        })
    return {"kernels": out}


def main():
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(card_line())
    log(environment_line())

    walls = {}
    t0 = time.perf_counter()
    phase_build()
    walls["build"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    records = phase_kernels()
    walls["kernels"] = time.perf_counter() - t0

    base = C.speecht5_base_asr()
    t0 = time.perf_counter()
    served = phase_serve(base)
    walls["serve"] = time.perf_counter() - t0
    log(json.dumps({"phase": "serve", "launches": served["counts"]}))
    missing = [n for n in KERNELS if served["counts"][n] == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")

    t0 = time.perf_counter()
    phase_parity(base)
    walls["parity"] = time.perf_counter() - t0

    walls["total"] = time.perf_counter() - t_start
    log(json.dumps({"phase_seconds": walls, "card": card_line()}))
    log(json.dumps(kernels_line(records, served["counts"])))
    torch.cuda.synchronize()
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
