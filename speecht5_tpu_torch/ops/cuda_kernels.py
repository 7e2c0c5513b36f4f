"""Hand-written CUDA kernels of the port, their plain PyTorch twins, and the
loader that builds them.

``speecht5_tpu/ops/pallas_kernels.py`` holds the TPU kernels they replace:

- ``banded_flash_attention`` (``csrc/banded_attention_fwd.cu``, f32
  ``csrc/banded_attention.cu``): inference encoder self-attention with the
  clipped relative-position bias from the shared ``[Dh, T, T]`` band;
  replaces ``banded_flash_attention`` (pallas_kernels.py:215).  bf16 runs on
  wgmma tensor cores fed by TMA (two launches: the bias pass q.band per
  query row as a GEMM over the batch-heads, then a FlashAttention-style
  main loop), f32 on one CUDA-core launch.  Inference only: it raises when
  asked to carry a gradient.
- ``conv_stack`` (``csrc/conv_stack.cu``): feature-extractor layers 1..n,
  each a VALID strided Conv1d without bias followed by the exact GELU;
  replaces ``conv_stack_pallas`` / ``conv_stack_fused`` (pallas_kernels.py
  :714, :783).  One launch per layer: bf16 an implicit GEMM on wgmma tensor
  cores fed by TMA, f32 the CUDA-core kernel; an autograd function whose
  backward is the vjp of the library conv (``conv_stack_library``, cuDNN
  on the card), as ``conv_stack_fused``'s is the vjp of XLA's conv in
  ``_conv_stack_ref``.
- ``banded_attention_train`` (``csrc/banded_attention_train.cu``,
  ``csrc/banded_attention_train_bwd.cu``): the differentiable form of the
  attention with in-kernel counter-hash probability dropout; replaces
  ``banded_flash_attention_train`` (pallas_kernels.py:411, ``pallas_call``
  sites :427, :446, :456) with three wrappers:
  ``banded_attention_train_fwd``, ``banded_attention_train_bwd_dq`` (dq and
  dband) and ``banded_attention_train_bwd_dkv``.  Each routes by dtype:
  bf16 on wgmma tensor cores fed by TMA (the forward in
  ``csrc/banded_attention_fwd.cu``: the bias pass and the main loop; the
  backward a bias pass, each wrapper's main loop, and dq's band pass: the
  band terms as GEMMs over the batch-heads; forward and backward share one
  bias pass code, so their scores are the same bits), f32 on one CUDA-core
  launch each.
- ``fused_log_mel`` (``csrc/log_mel.cu``): waveform -> log10-mel in one
  pass, an f32 four-step FFT in registers and warp shuffles and a sparse
  filterbank, the spectrum kept on chip; replaces ``fused_log_mel`` (pallas_kernels.py:97, kernel
  ``_mel_kernel`` :57, ``pallas_call`` :154).  No gradient: the TPU kernel
  has none and the mel targets need none.
- ``flash_attention_bias`` (``csrc/flash_attention_bias.cu``): attention
  with an additive f32 bias and a key mask, the beam search's decode-step
  attention (grouped cross-attention, cached self-attention); replaces
  ``flash_attention_bias`` (pallas_kernels.py:592, kernel ``_flash_kernel``
  :553, ``pallas_call`` :624).  The keys split over a thread-block cluster
  whose partials are combined in distributed shared memory, one launch.
  Two entries: ``flash_attention_bias`` on ``[N, T, D]`` rows (the JAX
  contract) and ``flash_attention_bias_cached``, which reads ``[B, T, H,
  D]`` K/V in place through strides and the beam's ancestry row map.
  The cached entry also returns, on request, the largest softmax
  probability of each row and query from the same launch (the TTS
  decoder's focus rate).  Long queries (WavLM's self-attention) take a
  second kernel, ``csrc/flash_attention_bias_tiled.cu``: one block a 64-query
  tile on wgmma tensor cores fed by TMA, each row's K and V read once a
  tile; ``flash_bias_path`` picks the kernel of a call.
  Forward only, as in JAX.

The attention wrappers take the band contiguous or as the encoder builds it,
a ``[Dh, T, T]`` view of storage with rows of Tp = T rounded up to 8
(strides ``(T * Tp, Tp, 1)``, ``band_row_stride``), so that TMA's 16-byte
strides need no copy of it per call.

Each wrapper takes its kernel's plain twin only because the tensors it was
given lie on the CPU; on CUDA tensors it launches the kernel or raises.
There is no fallback from a failed build or launch to a twin.  Each wrapper
counts its launches in ``<wrapper>.launches`` (one per kernel launch, and
nowhere else) so that a run can show that its main path went through the
kernels.

The kernels are plain-C-interface CUDA sources compiled by ``nvcc`` at first
use into ``build/torch_kernels/<hash of sources and flags>/`` and bound with
``ctypes``: no ninja, no PyTorch headers, no pybind11.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .mel import hann_window, log_mel_spectrogram, mel_filterbank

NEG_INF = -1e9

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_ROOT = _PKG_DIR.parent / "build" / "torch_kernels"
SOURCES = {
    "banded_attention": "banded_attention.cu",
    "banded_attention_fwd": "banded_attention_fwd.cu",
    "banded_attention_train": "banded_attention_train.cu",
    "banded_attention_train_bwd": "banded_attention_train_bwd.cu",
    "conv_stack": "conv_stack.cu",
    "flash_attention_bias": "flash_attention_bias.cu",
    "flash_attention_bias_tiled": "flash_attention_bias_tiled.cu",
    "log_mel": "log_mel.cu",
}
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-Xcompiler", "-fPIC", "-shared",
)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LIBS: dict = {}

# ------------------------------------------------------------------ loader


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``/usr/local/cuda/bin/nvcc``, then PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built"
        )
    return found


def build_dir() -> Path:
    """``build/torch_kernels/<hash>``: the hash covers every source, every
    header of ``csrc/`` and the flags, so an edited file never loads a
    stale library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(SOURCES):
        h.update(name.encode())
        h.update((CSRC_DIR / SOURCES[name]).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def nvcc_command(nvcc: str, source: Path, output: Path) -> list:
    return [nvcc, *NVCC_FLAGS, "-o", str(output), str(source)]


def build_all(names=None) -> dict:
    """Compile the named kernels (all by default) that are not built yet,
    one ``nvcc`` process per source, all started together.  Each library is
    written under a temporary name and renamed into place, so a half-written
    library is never loaded.  Returns {name: library path}; raises with the
    compiler's stderr if a build fails."""
    names = sorted(SOURCES) if names is None else list(names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {n: out_dir / f"lib{n}.so" for n in names}
    todo = [n for n in names if not libs[n].exists()]
    if todo:
        nvcc = find_nvcc()
        procs = {}
        for n in todo:
            tmp = out_dir / f".lib{n}.{os.getpid()}.tmp.so"
            cmd = nvcc_command(nvcc, CSRC_DIR / SOURCES[n], tmp)
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        errors = []
        for n, (tmp, proc) in procs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {SOURCES[n]} "
                              f"(exit {proc.returncode}):\n{err}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, libs[n])
        if errors:
            raise RuntimeError("\n".join(errors))
    return libs


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        vp, i = ctypes.c_void_p, ctypes.c_int
        u, f = ctypes.c_uint, ctypes.c_float
        if name == "banded_attention":
            # q, k, v, band, lengths, out, then N, T, Dh, the band's row
            # stride, dtype, stream
            lib.banded_attention_launch.argtypes = [vp] * 6 + [i] * 5 + [vp]
            lib.banded_attention_launch.restype = i
        elif name == "banded_attention_fwd":
            # bias pass: q, band, bias, then N, T, Dh, stream; main loop: q,
            # k, v, lengths, bias, out, stats, then N, T, Dh, train, dropout
            # on, seed, keep threshold, keep scale, stream
            lib.baf_bias_launch.argtypes = [vp] * 3 + [i] * 3 + [vp]
            lib.baf_main_launch.argtypes = [vp] * 7 + [i] * 5 + [u, u, f, vp]
            lib.baf_bias_launch.restype = lib.baf_main_launch.restype = i
        elif name == "banded_attention_train":
            # q, k, v, band, lengths, then the outputs / saved tensors, then
            # N, T, Dh, the band's row stride, dtype, dropout on, seed, keep
            # threshold, keep scale, stream
            tail = [i] * 6 + [u, u, f, vp]
            lib.bat_fwd_launch.argtypes = [vp] * 7 + tail
            lib.bat_bwd_dq_launch.argtypes = [vp] * 10 + tail
            lib.bat_bwd_dkv_launch.argtypes = [vp] * 10 + tail
            for fn in (lib.bat_fwd_launch, lib.bat_bwd_dq_launch,
                       lib.bat_bwd_dkv_launch):
                fn.restype = i
        elif name == "banded_attention_train_bwd":
            # pointers, then N, T, Dh (and for the main loops dropout on,
            # seed, keep threshold, keep scale), stream
            lib.batb_bias_launch.argtypes = [vp] * 6 + [i] * 3 + [vp]
            lib.batb_band_launch.argtypes = [vp] * 6 + [i] * 3 + [vp]
            for fn in (lib.batb_dq_launch, lib.batb_dkv_launch):
                fn.argtypes = [vp] * 10 + [i] * 4 + [u, u, f, vp]
            for fn in (lib.batb_bias_launch, lib.batb_dq_launch, lib.batb_band_launch,
                       lib.batb_dkv_launch):
                fn.restype = i
        elif name == "conv_stack":
            # x, w [k, Cin, Cout], y, then B, T_in, Cin, T_out, Cout, k, s,
            # stream
            for fn in (lib.conv_gelu_f32_launch, lib.conv_gelu_bf16_launch):
                fn.argtypes = [vp] * 3 + [i] * 7 + [vp]
                fn.restype = i
        elif name == "flash_attention_bias":
            # q, k, v, bias, key_valid, rows (each may be NULL but q, k, v),
            # out, the max-probability output (or NULL), 12 element strides
            # (int64, host), then B, H, Tq, Tk, D, rows per mask row, dtype,
            # stream
            lib.flash_bias_launch.argtypes = [vp] * 9 + [i] * 7 + [vp]
            lib.flash_bias_launch.restype = i
        elif name == "flash_attention_bias_tiled":
            # q, k, v, bias, key_valid (each may be NULL but q, k, v), out,
            # then N, Tq, Tk, D, rows per mask row, stream
            lib.flash_tiled_launch.argtypes = [vp] * 6 + [i] * 5 + [vp]
            lib.flash_tiled_launch.restype = i
        else:
            # wav, window, twiddles, filterbank weights [max len, n_mels],
            # their [n_mels, 2] index, out, then B, T, frames, n_fft, hop,
            # n_mels, center, eps, stream
            lib.log_mel_launch.argtypes = [vp] * 6 + [i] * 7 + [f, vp]
            lib.log_mel_launch.restype = i
        _LIBS[name] = lib
    return lib


def _check_rc(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def _dtype_code(*tensors) -> int:
    dt = tensors[0].dtype
    if dt not in _DTYPE_CODES or any(t.dtype != dt for t in tensors):
        raise TypeError(
            "expected one dtype in {float32, bfloat16} for all inputs, got "
            f"{[t.dtype for t in tensors]}"
        )
    return _DTYPE_CODES[dt]


def _check_cuda(*tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(
                f"expected all tensors on one CUDA device, got "
                f"{[str(t.device) for t in tensors]}"
            )
        if not t.is_contiguous():
            raise ValueError("expected contiguous tensors")


# ============================================ banded-bias fused attention


def banded_flash_attention_plain(q, k, v, pe_band, lengths=None):
    """Plain PyTorch twin of the attention kernel (same arithmetic, f32).

    q/k/v: [N, T, Dh] (q pre-scaled); pe_band: [Dh, T, T]; lengths: [N]
    valid key counts (contiguous prefixes).  Keys at or beyond a row's length
    get -1e9, so a row of length 0 returns the mean of V.  The unnormalised
    probabilities are rounded to V's dtype before P.V, as in the kernel.
    """
    N, T, _ = q.shape
    qf = q.float()
    s = qf @ k.float().transpose(1, 2)
    s = s + torch.einsum("nqd,dqk->nqk", qf, pe_band.float())
    if lengths is not None:
        ok = (torch.arange(T, device=q.device)[None, None, :]
              < lengths.to(q.device)[:, None, None])
        s = torch.where(ok, s, torch.full((), NEG_INF, device=q.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = p.to(v.dtype).float() @ v.float()
    return (o / l.clamp_min(1e-30)).to(q.dtype)


def band_row_stride(pe_band) -> int:
    """The row stride, in elements, of a ``[Dh, T, T]`` band the attention
    kernels take: T for a contiguous band, Tp = T rounded up to 8 for the
    encoder's row-padded band (a view of ``[Dh, T, Tp]`` storage, strides
    ``(T * Tp, Tp, 1)``).  Raises ValueError on any other layout."""
    if pe_band.dim() != 3 or pe_band.shape[1] != pe_band.shape[2]:
        raise ValueError(f"pe_band must be [Dh, T, T], got {tuple(pe_band.shape)}")
    T = pe_band.shape[1]
    if pe_band.is_contiguous():
        return T
    Tp = -(-T // 8) * 8
    if pe_band.stride() == (T * Tp, Tp, 1):
        return Tp
    raise ValueError(
        f"pe_band strides {pe_band.stride()}: the kernels take a contiguous band or "
        f"a [Dh, T, T] view of rows of Tp = {Tp}, strides {(T * Tp, Tp, 1)}")


def _check_band(pe_band, q) -> int:
    """The band against q [N, T, Dh]: its shape, device and layout; returns
    its row stride."""
    N, T, Dh = q.shape
    if pe_band.shape != (Dh, T, T):
        raise ValueError(f"pe_band shape {tuple(pe_band.shape)} != {(Dh, T, T)}")
    if pe_band.device != q.device:
        raise ValueError(f"pe_band on {pe_band.device}, q on {q.device}")
    return band_row_stride(pe_band)


def _tma_band(pe_band):
    """The band as the wgmma kernels' TMA maps read it, with rows of Tp = T
    rounded up to 8 (16-byte strides): the encoder's row-padded band as it
    is; a contiguous band with T % 8 copied into such rows (the columns
    past T are never read)."""
    Dh, T, _ = pe_band.shape
    Tp = -(-T // 8) * 8
    if band_row_stride(pe_band) == Tp:
        return pe_band
    band = torch.empty((Dh, T, Tp), dtype=pe_band.dtype, device=pe_band.device)
    band[..., :T].copy_(pe_band)
    return band[..., :T]


def _check_wgmma(q, *tensors, what: str):
    """Raise, before any launch, on a bf16 call that the wgmma kernels do
    not take: Dh a multiple of 16 up to 64, T <= 1024, 16-byte aligned
    tensors."""
    N, T, Dh = q.shape
    if Dh % 16 or not 16 <= Dh <= 64 or T > 1024:
        raise ValueError(f"the bf16 {what} (wgmma) needs Dh a multiple of 16 up to 64 "
                         f"and T <= 1024; got Dh={Dh}, T={T}")
    if any(t.data_ptr() % 16 for t in (q, *tensors)):
        raise ValueError("the wgmma kernels need 16-byte aligned tensors")


def fwd_launches(dtype) -> int:
    """Launches of one call of either attention forward on the card: bf16
    the bias pass and the main loop, f32 one CUDA-core kernel."""
    return 2 if dtype == torch.bfloat16 else 1


def fwd_bias(q, pe_band, count):
    """The forward's bias pass: bias = q.band per query row, f32 [N, T,
    Tp], the same kernel (and so the same bits) as the backward's bias pass
    without delta.  One launch, counted on ``count``."""
    N, T, Dh = q.shape
    band = _tma_band(pe_band)
    bias = torch.empty((N, T, -(-T // 8) * 8), dtype=torch.float32, device=q.device)
    rc = _lib("banded_attention_fwd").baf_bias_launch(
        q.data_ptr(), band.data_ptr(), bias.data_ptr(), N, T, Dh,
        torch.cuda.current_stream(q.device).cuda_stream)
    _check_rc(rc, "attention forward bias pass")
    count.launches += 1
    return bias


def fwd_main(q, k, v, lengths, bias, count, train=False, rate=0.0, seed=0):
    """The forward's main loop on the bias pass's bias: out bf16 [N, T, Dh]
    and, with ``train``, stats f32 [2, N, T] (dropout at ``rate`` from
    ``seed``), else None.  One launch, counted on ``count``."""
    N, T, Dh = q.shape
    out = torch.empty_like(q)
    stats = (torch.empty((2, N, T), dtype=torch.float32, device=q.device)
             if train else None)
    rc = _lib("banded_attention_fwd").baf_main_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), bias.data_ptr(),
        out.data_ptr(), None if stats is None else stats.data_ptr(), N, T, Dh,
        int(train), *_dropout_args(rate, seed),
        torch.cuda.current_stream(q.device).cuda_stream)
    _check_rc(rc, "attention forward main loop")
    count.launches += 1
    return out, stats


def banded_flash_attention(q, k, v, pe_band, lengths=None):
    """Fused self-attention with the SpeechT5 rel-pos bias computed from the
    shared band.  Same contract as the JAX package's
    ``banded_flash_attention``: q/k/v [N, T, Dh] (q pre-scaled), pe_band
    [Dh, T, T] (contiguous or row-padded, ``band_row_stride``), lengths [N]
    -> [N, T, Dh] in q's dtype.  On the card T <= 1024; bf16 takes the
    wgmma kernels (two launches; Dh a multiple of 16 up to 64), f32 the
    CUDA-core kernel (one launch; Dh <= 128).  Inference only: raises under
    grad mode when an input requires grad (training passes take
    ``banded_attention_train``)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, pe_band)):
        raise RuntimeError(
            "banded_flash_attention is inference-only and would drop the "
            "gradient; use banded_attention_train or torch.no_grad()")
    if q.device.type == "cpu":
        return banded_flash_attention_plain(q, k, v, pe_band, lengths)
    N, T, Dh = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if lengths is None:
        lengths = torch.full((N,), T, dtype=torch.int32, device=q.device)
    if lengths.dtype != torch.int32 or lengths.shape != (N,):
        raise TypeError("lengths must be int32 [N]")
    _check_cuda(q, k, v, lengths)
    ldb = _check_band(pe_band, q)
    code = _dtype_code(q, k, v, pe_band)
    if T > 1024 or Dh > 128:
        raise ValueError(f"kernel limits T <= 1024, Dh <= 128; got T={T} Dh={Dh}")
    if q.dtype == torch.bfloat16:
        _check_wgmma(q, k, v, pe_band, what="attention")
        bias = fwd_bias(q, pe_band, banded_flash_attention)
        return fwd_main(q, k, v, lengths, bias, banded_flash_attention)[0]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib("banded_attention").banded_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pe_band.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), N, T, Dh, ldb, code, stream)
    _check_rc(rc, "banded_attention")
    banded_flash_attention.launches += 1
    return out


banded_flash_attention.launches = 0


# ====================================================== conv-FE stack

# the bf16 kernel's limit (csrc/conv_stack.cu): one TMA tensor map per tap
CONV_WGMMA_MAX_TAPS = 8


def conv_stack_plain(x, weights, specs):
    """Plain PyTorch twin of the conv stack: per layer, a VALID strided conv
    as k per-tap matmuls over strided views (f32 products and sums), the
    exact GELU, and a cast back to x's dtype.

    x: [B, T, Cin]; weights: per layer [k, Cin, Cout] (the JAX kernel
    layout); specs: ((k, s), ...) -> [B, T_out, Cout]."""
    dtype = x.dtype
    for (k, s), w in zip(specs, weights):
        T = x.shape[1]
        n_out = (T - k) // s + 1
        w = w.to(dtype).float()
        acc = None
        for j in range(k):
            xj = x[:, j : j + s * (n_out - 1) + 1 : s].float()
            yj = xj @ w[j]
            acc = yj if acc is None else acc + yj
        x = F.gelu(acc).to(dtype)
    return x


def _conv_stack_shapes(x, weights, specs):
    """Check every layer against what its kernel takes before any launch:
    [(k, s, Cin, T_out, Cout), ...]."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, C], got {tuple(x.shape)}")
    _dtype_code(x)
    bf16 = x.dtype == torch.bfloat16
    T, Cin = x.shape[1:]
    layers = []
    for (k, s), w in zip(specs, weights):
        if w.dim() != 3 or w.shape[0] != k or w.shape[1] != Cin:
            raise ValueError(f"weight {tuple(w.shape)} does not match k={k}, Cin={Cin}")
        n_out = (T - k) // s + 1
        if n_out <= 0:
            raise ValueError(f"input of {T} frames is shorter than kernel {k}")
        Cout = w.shape[2]
        if bf16 and (Cin % 8 or Cout % 8 or k > CONV_WGMMA_MAX_TAPS):
            raise ValueError(
                "the bf16 (wgmma/TMA) conv kernel needs Cin % 8 == 0, Cout % 8 == 0 "
                f"and k <= {CONV_WGMMA_MAX_TAPS}; got Cin={Cin}, Cout={Cout}, k={k}")
        layers.append((k, s, Cin, n_out, Cout))
        T, Cin = n_out, Cout
    return layers


def _conv_stack_forward(x, weights, specs):
    """The kernel on CUDA tensors (one launch per layer: bf16 on the wgmma
    kernel, f32 on the CUDA-core kernel), the twin on CPU ones."""
    if x.device.type == "cpu":
        return conv_stack_plain(x, weights, specs)
    layers = _conv_stack_shapes(x, weights, specs)
    _check_cuda(x)
    if x.data_ptr() % 16:
        raise ValueError("the conv kernel needs x 16-byte aligned")
    lib = _lib("conv_stack")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for (k, s, Cin, n_out, Cout), w in zip(layers, weights):
        if w.device != x.device:
            raise ValueError(f"weight on {w.device}, x on {x.device}")
        B, T = x.shape[:2]
        if w.dtype != x.dtype or not w.is_contiguous():
            # one copy (cast and layout) into the kernels' [k, Cin, Cout]
            w = torch.empty((k, Cin, Cout), dtype=x.dtype, device=x.device).copy_(w)
        if w.data_ptr() % 16:
            raise ValueError("the conv kernel needs w 16-byte aligned")
        launch = (lib.conv_gelu_bf16_launch if x.dtype == torch.bfloat16
                  else lib.conv_gelu_f32_launch)
        y = torch.empty((B, n_out, Cout), dtype=x.dtype, device=x.device)
        rc = launch(x.data_ptr(), w.data_ptr(), y.data_ptr(), B, T, Cin, n_out, Cout,
                    k, s, stream)
        _check_rc(rc, "conv_stack")
        conv_stack.launches += 1
        x = y
    return x


def conv_stack_library(x, weights, specs):
    """The conv stack through the library conv: per layer ``F.conv1d``
    (cuDNN on the card) in x's dtype, then the exact GELU in that dtype,
    as the JAX ``_conv_stack_ref`` runs XLA's conv.  The function whose vjp
    is the stack's backward; same arguments and result as
    ``conv_stack_plain``."""
    dtype = x.dtype
    y = x.transpose(1, 2)
    for (_, s), w in zip(specs, weights):
        y = F.gelu(F.conv1d(y, w.to(dtype).permute(2, 1, 0), stride=s))
    return y.transpose(1, 2)


class _ConvStack(torch.autograd.Function):
    """Forward: the kernel.  Backward: the vjp of ``conv_stack_library``
    (recomputed), as the JAX ``conv_stack_fused`` differentiates through
    ``_conv_stack_ref`` (XLA's conv, outside any Pallas kernel); the TPU
    package has no backward kernel either."""

    @staticmethod
    def forward(ctx, x, specs, *weights):
        ctx.specs = specs
        ctx.save_for_backward(x, *weights)
        return _conv_stack_forward(x, weights, specs)

    @staticmethod
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        with torch.enable_grad():
            xs = x.detach().requires_grad_(ctx.needs_input_grad[0])
            ws = [w.detach().requires_grad_(need)
                  for w, need in zip(weights, ctx.needs_input_grad[2:])]
            y = conv_stack_library(xs, ws, ctx.specs)
            wanted = [t for t in (xs, *ws) if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, g))
        return (next(grads) if xs.requires_grad else None, None,
                *(next(grads) if w.requires_grad else None for w in ws))


def conv_stack(x, weights, specs):
    """Strided conv + exact GELU stack: [B, T, Cin] -> [B, T_out, Cout].

    ``specs``: ((k, s), ...) per layer; ``weights``: matching [k, Cin, Cout]
    tensors, cast to x's dtype as the JAX kernel does.  VALID padding, no
    bias.  On CUDA: one kernel launch per layer; bf16 needs every Cin and
    Cout a multiple of 8 and k <= 8 (it raises otherwise).  Differentiable
    in x and the weights (the backward is ``conv_stack_library``'s vjp)."""
    return _ConvStack.apply(x, tuple(specs), *weights)


conv_stack.launches = 0


# ================================ banded-bias attention: training (VJP)

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2**32 for int64 x in [0, 2**32): split c in 16-bit
    halves so no int64 product overflows (CPU torch has no uint32 mul)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def dropout_threshold(rate: float) -> int:
    """The keep threshold of ``_dropout_keep`` (pallas_kernels.py:285)."""
    return min(int((1.0 - rate) * 4294967296.0), 4294967295)


def dropout_keep_plain(seed: int, rate: float, N: int, Tq: int, Tk: int,
                       device=None, n_offset: int = 0):
    """bool [N, Tq, Tk] keep mask of the lowbias32 counter hash of
    (seed, n, global row, global column), bit for bit the TPU kernel's
    ``_dropout_keep`` (pallas_kernels.py:265-287); row n of the call is
    flat row ``n_offset + n`` of the hash."""
    i64 = dict(dtype=torch.int64, device=device)
    row = torch.arange(Tq, **i64)[None, :, None]
    col = torch.arange(Tk, **i64)[None, None, :]
    n = (torch.arange(N, **i64) + int(n_offset))[:, None, None] & _M32
    x = _mul32(row, 0x9E3779B1) ^ _mul32(col, 0x85EBCA77)
    x = (x + ((int(seed) & _M32) + _mul32(n, 0x27D4EB2F))) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x < dropout_threshold(rate)


def _train_scores(q, k, pe_band, lengths):
    """f32 scores q.k + q.band with keys at or beyond a row's length set to
    -1e9, and the bool key mask [N, 1, T]."""
    T = q.shape[1]
    qf = q.float()
    s = qf @ k.float().transpose(1, 2)
    s = s + torch.einsum("nqd,dqk->nqk", qf, pe_band.float())
    ok = (torch.arange(T, device=q.device)[None, None, :]
          < lengths.to(q.device)[:, None, None])
    return torch.where(ok, s, torch.full((), NEG_INF, device=q.device)), ok


def _train_probs(q, k, pe_band, lengths, stats):
    """Normalised probabilities from the forward's row statistics
    (stats[0] = row max, stats[1] = row sum), and the key mask."""
    s, ok = _train_scores(q, k, pe_band, lengths)
    return torch.exp(s - stats[0][..., None]) / stats[1][..., None], ok


def _keep_scale(q, rate, seed):
    """keep / (1 - rate) as f32 [N, T, T], or None without dropout."""
    if rate <= 0.0:
        return None
    N, T, _ = q.shape
    keep = dropout_keep_plain(seed, rate, N, T, T, q.device)
    return keep.float() * (1.0 / (1.0 - rate))


def banded_attention_train_fwd_plain(q, k, v, pe_band, lengths, rate, seed):
    """Plain twin of the train forward (``_train_attn_fwd_kernel``,
    pallas_kernels.py:310): p = softmax(q.k + q.band, masked) in f32,
    dropout-scaled, cast to V's type, times V.  Returns (out [N, T, Dh] in
    q's dtype, stats [2, N, T] f32: row max and row sum of exp)."""
    s, _ = _train_scores(q, k, pe_band, lengths)
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    l = e.sum(dim=-1).clamp_min(1e-30)
    p = e / l[..., None]
    ks = _keep_scale(q, rate, seed)
    if ks is not None:
        p = p * ks
    o = p.to(v.dtype).float() @ v.float()
    return o.to(q.dtype), torch.stack([m, l])


def _train_ds(q, k, v, pe_band, lengths, o, do, stats, rate, seed):
    """(p, keep_scale, ds): ds = p * (dO.V^T * keep_scale - rowsum(dO*O)),
    zero at masked keys (the dense path's gradient; the Pallas kernel lets a
    row of length 0 leak into dq/dk/dband, see ROADMAP.md C)."""
    p, ok = _train_probs(q, k, pe_band, lengths, stats)
    ks = _keep_scale(q, rate, seed)
    dpn = do.float() @ v.float().transpose(1, 2)
    if ks is not None:
        dpn = dpn * ks
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    return p, ks, p * (dpn - delta) * ok


def banded_attention_train_bwd_dq_plain(q, k, v, pe_band, lengths, o, do,
                                        stats, rate, seed):
    """Plain twin of ``_train_attn_bwd_dq_kernel`` (pallas_kernels.py:342):
    dq [N, T, Dh] in q's dtype and dband [Dh, T, T] f32 summed over N."""
    _, _, ds = _train_ds(q, k, v, pe_band, lengths, o, do, stats, rate, seed)
    dq = ds.to(k.dtype).float() @ k.float()
    dq = dq + torch.einsum("nqk,dqk->nqd", ds, pe_band.float())
    dband = torch.einsum("nqd,nqk->dqk", q.float(), ds)
    return dq.to(q.dtype), dband


def banded_attention_train_bwd_dkv_plain(q, k, v, pe_band, lengths, o, do,
                                         stats, rate, seed):
    """Plain twin of ``_train_attn_bwd_dkv_kernel`` (pallas_kernels.py:374):
    dk, dv [N, T, Dh] in q's dtype."""
    p, ks, ds = _train_ds(q, k, v, pe_band, lengths, o, do, stats, rate, seed)
    pd = p if ks is None else p * ks
    dv = pd.to(do.dtype).float().transpose(1, 2) @ do.float()
    dk = ds.transpose(1, 2) @ q.float()
    return dk.to(q.dtype), dv.to(q.dtype)


def _dropout_args(rate: float, seed: int) -> tuple:
    """(dropout on, seed, keep threshold, keep scale) as the kernels take
    them, computed as the TPU kernel computes them."""
    on = 1 if rate > 0.0 else 0
    return (on, int(seed) & _M32, dropout_threshold(rate) if on else _M32,
            1.0 / (1.0 - rate) if on else 1.0)


def _train_args(q, k, v, pe_band, lengths, rate, seed):
    """Validate the CUDA inputs; returns the f32 launches' scalar tail."""
    N, T, Dh = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if T > 1024 or Dh > 64:
        raise ValueError(f"train kernel limits T <= 1024, Dh <= 64; got T={T} Dh={Dh}")
    if lengths.dtype != torch.int32 or lengths.shape != (N,):
        raise TypeError("lengths must be int32 [N]")
    _check_cuda(q, k, v, lengths)
    ldb = _check_band(pe_band, q)
    code = _dtype_code(q, k, v, pe_band)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return (N, T, Dh, ldb, code, *_dropout_args(rate, seed), stream)


def banded_attention_train_fwd(q, k, v, pe_band, lengths, rate, seed):
    """Train forward: (out [N, T, Dh], stats [2, N, T] f32).  The twin on
    CPU tensors.  On the card bf16 takes the wgmma kernels (two launches:
    the bias pass and the main loop; Dh a multiple of 16) and f32 the
    CUDA-core kernel (one launch)."""
    if q.device.type == "cpu":
        return banded_attention_train_fwd_plain(q, k, v, pe_band, lengths,
                                                rate, seed)
    tail = _train_args(q, k, v, pe_band, lengths, rate, seed)
    if q.dtype == torch.bfloat16:
        _check_wgmma(q, k, v, pe_band, what="train forward")
        bias = fwd_bias(q, pe_band, banded_attention_train_fwd)
        return fwd_main(q, k, v, lengths, bias, banded_attention_train_fwd,
                        train=True, rate=rate, seed=seed)
    out = torch.empty_like(q)
    stats = torch.empty((2,) + q.shape[:2], dtype=torch.float32, device=q.device)
    rc = _lib("banded_attention_train").bat_fwd_launch(
        *(t.data_ptr() for t in (q, k, v, pe_band, lengths, out, stats)), *tail)
    _check_rc(rc, "banded_attention_train_fwd")
    banded_attention_train_fwd.launches += 1
    return out, stats


# ---- the bf16 backward on wgmma tensor cores (csrc/banded_attention_train_bwd.cu)
#
# Four launches, each counted on the wrapper it works for: the bias pass
# (bias = q.band per query row, f32 [N, T, Tp], and delta = rowsum(dO * o)),
# dq's main loop (ds in bf16 [T, N, Tp] and ds.k), dq's band pass (dq and
# dband, the band terms as GEMMs over n) and dk/dv's main loop.  Tp = T
# rounded up to 8.  The autograd function runs the bias pass once for both
# backward wrappers; each wrapper called alone runs its own.


def _check_wgmma_bwd(q, k, v, pe_band, lengths, o, do, stats, rate, seed):
    """Raise, before any launch, on a bf16 backward call the wgmma kernels
    do not take."""
    _train_args(q, k, v, pe_band, lengths, rate, seed)
    _check_cuda(o, do, stats)
    N, T, Dh = q.shape
    _check_wgmma(q, k, v, pe_band, o, do, what="train backward")
    if o.dtype != torch.bfloat16 or do.dtype != torch.bfloat16 or o.shape != q.shape \
            or do.shape != q.shape:
        raise TypeError(f"o and do must be bfloat16 {tuple(q.shape)}, got "
                        f"{o.dtype} {tuple(o.shape)} and {do.dtype} {tuple(do.shape)}")
    if stats.dtype != torch.float32 or stats.shape != (2, N, T):
        raise TypeError(f"stats must be float32 {(2, N, T)}")


def train_bwd_bias(q, pe_band, o, do, count):
    """The bias pass: (band with rows of Tp (``_tma_band``: the encoder's
    row-padded band as it is), bias f32 [N, T, Tp], delta f32 [N, T]).  One
    launch, counted on ``count``."""
    N, T, Dh = q.shape
    band = _tma_band(pe_band)
    bias = torch.empty((N, T, -(-T // 8) * 8), dtype=torch.float32, device=q.device)
    delta = torch.empty((N, T), dtype=torch.float32, device=q.device)
    rc = _lib("banded_attention_train_bwd").batb_bias_launch(
        *(t.data_ptr() for t in (q, band, o, do, bias, delta)), N, T, Dh,
        torch.cuda.current_stream(q.device).cuda_stream)
    _check_rc(rc, "banded_attention_train bias pass")
    count.launches += 1
    return band, bias, delta


def train_bwd_dq_main(q, k, v, do, lengths, stats, bias, delta, rate, seed):
    """dq's main loop: (ds bf16 [T, N, Tp], dq_acc = ds.k f32 [N, T, Dh]).
    One launch."""
    N, T, Dh = q.shape
    ds = torch.empty((T, N, bias.shape[2]), dtype=torch.bfloat16, device=q.device)
    dq_acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    rc = _lib("banded_attention_train_bwd").batb_dq_launch(
        *(t.data_ptr() for t in (q, k, v, do, lengths, stats, bias, delta, ds, dq_acc)),
        N, T, Dh, *_dropout_args(rate, seed),
        torch.cuda.current_stream(q.device).cuda_stream)
    _check_rc(rc, "banded_attention_train_bwd_dq main loop")
    banded_attention_train_bwd_dq.launches += 1
    return ds, dq_acc


def train_bwd_band(q, band, ds, dq_acc):
    """dq's band pass: (dq [N, T, Dh] bf16, dband [Dh, T, T] f32).  ``band``
    is the bias pass's.  One launch."""
    N, T, Dh = q.shape
    dq = torch.empty_like(q)
    dband = torch.empty((Dh, T, T), dtype=torch.float32, device=q.device)
    rc = _lib("banded_attention_train_bwd").batb_band_launch(
        *(t.data_ptr() for t in (q, band, ds, dq_acc, dq, dband)), N, T, Dh,
        torch.cuda.current_stream(q.device).cuda_stream)
    _check_rc(rc, "banded_attention_train_bwd_dq band pass")
    banded_attention_train_bwd_dq.launches += 1
    return dq, dband


def train_bwd_dkv_main(q, k, v, do, lengths, stats, bias, delta, rate, seed):
    """dk/dv's main loop: (dk, dv) [N, T, Dh] bf16.  One launch."""
    N, T, Dh = q.shape
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    rc = _lib("banded_attention_train_bwd").batb_dkv_launch(
        *(t.data_ptr() for t in (q, k, v, do, lengths, stats, bias, delta, dk, dv)),
        N, T, Dh, *_dropout_args(rate, seed),
        torch.cuda.current_stream(q.device).cuda_stream)
    _check_rc(rc, "banded_attention_train_bwd_dkv main loop")
    banded_attention_train_bwd_dkv.launches += 1
    return dk, dv


def _train_bwd_wgmma(q, k, v, pe_band, lengths, o, do, stats, rate, seed,
                     dq=True, dkv=True) -> dict:
    """The bf16 backward: one bias pass (counted on the dq wrapper when dq
    is wanted), then dq's main loop and band pass and/or dk/dv's main loop.
    Returns {"dq", "dband"} and/or {"dk", "dv"}."""
    _check_wgmma_bwd(q, k, v, pe_band, lengths, o, do, stats, rate, seed)
    band, bias, delta = train_bwd_bias(
        q, pe_band, o, do,
        banded_attention_train_bwd_dq if dq else banded_attention_train_bwd_dkv)
    main = (q, k, v, do, lengths, stats, bias, delta, rate, seed)
    out = {}
    if dq:
        ds, dq_acc = train_bwd_dq_main(*main)
    if dkv:
        out["dk"], out["dv"] = train_bwd_dkv_main(*main)
    del main, bias      # free the bias before the band pass
    if dq:
        out["dq"], out["dband"] = train_bwd_band(q, band, ds, dq_acc)
    return out


def banded_attention_train_bwd_dq(q, k, v, pe_band, lengths, o, do, stats,
                                  rate, seed):
    """Train backward K1: (dq [N, T, Dh], dband [Dh, T, T] f32).  The twin on
    CPU tensors.  On the card, bf16 takes the wgmma kernels (three launches:
    the bias pass, the main loop, the band pass; Dh a multiple of 16) and
    f32 the CUDA-core kernel (one launch whose blocks either own a (n,
    16-row query tile) of dq or a 16 x 16 (query, key) tile of dband summed
    over every n in a fixed order)."""
    if q.device.type == "cpu":
        return banded_attention_train_bwd_dq_plain(
            q, k, v, pe_band, lengths, o, do, stats, rate, seed)
    if q.dtype == torch.bfloat16:
        out = _train_bwd_wgmma(q, k, v, pe_band, lengths, o, do, stats, rate, seed,
                               dkv=False)
        return out["dq"], out["dband"]
    tail = _train_args(q, k, v, pe_band, lengths, rate, seed)
    _check_cuda(o, do, stats)
    dq = torch.empty_like(q)
    dband = torch.empty(pe_band.shape, dtype=torch.float32, device=q.device)
    rc = _lib("banded_attention_train").bat_bwd_dq_launch(
        *(t.data_ptr() for t in (q, k, v, pe_band, lengths, o, do, stats, dq,
                                 dband)), *tail)
    _check_rc(rc, "banded_attention_train_bwd_dq")
    banded_attention_train_bwd_dq.launches += 1
    return dq, dband


def banded_attention_train_bwd_dkv(q, k, v, pe_band, lengths, o, do, stats,
                                   rate, seed):
    """Train backward K2: (dk, dv), each [N, T, Dh].  The twin on CPU
    tensors; on the card bf16 takes the wgmma kernels (two launches: the
    bias pass, the main loop) and f32 the CUDA-core kernel (one)."""
    if q.device.type == "cpu":
        return banded_attention_train_bwd_dkv_plain(
            q, k, v, pe_band, lengths, o, do, stats, rate, seed)
    if q.dtype == torch.bfloat16:
        out = _train_bwd_wgmma(q, k, v, pe_band, lengths, o, do, stats, rate, seed,
                               dq=False)
        return out["dk"], out["dv"]
    tail = _train_args(q, k, v, pe_band, lengths, rate, seed)
    _check_cuda(o, do, stats)
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    rc = _lib("banded_attention_train").bat_bwd_dkv_launch(
        *(t.data_ptr() for t in (q, k, v, pe_band, lengths, o, do, stats, dk,
                                 dv)), *tail)
    _check_rc(rc, "banded_attention_train_bwd_dkv")
    banded_attention_train_bwd_dkv.launches += 1
    return dk, dv


banded_attention_train_fwd.launches = 0
banded_attention_train_bwd_dq.launches = 0
banded_attention_train_bwd_dkv.launches = 0


def train_launches_per_layer(dtype) -> dict:
    """Each train wrapper's launches for one attention layer run forward and
    backward through ``banded_attention_train`` on the card: bf16 runs the
    forward's bias pass and main loop, and the backward's bias pass once,
    counted on the dq wrapper with its main loop and band pass."""
    bf16 = dtype == torch.bfloat16
    return {"banded_attention_train_fwd": fwd_launches(dtype),
            "banded_attention_train_bwd_dq": 3 if bf16 else 1,
            "banded_attention_train_bwd_dkv": 1}


def offset_seed(seed: int, n_offset: int) -> int:
    """The seed under which the kernels' hash of row n, seed + n *
    0x27D4EB2F (mod 2**32), is that of row ``n_offset + n`` under ``seed``:
    how a call's rows take their flat (batch x head) place in a larger
    batch, with the kernels' arithmetic unchanged."""
    return (int(seed) + _mul32(torch.tensor(int(n_offset) & _M32), 0x27D4EB2F).item()) & _M32


class _BandedAttentionTrain(torch.autograd.Function):
    """Forward kernel saves the row statistics; the backward kernels
    regenerate p and the dropout mask from them and the seed (bf16 on the
    card: one bias pass shared by dq/dband and dk/dv, whose scores are the
    forward's bits).  The band is saved as given: the encoder's row-padded
    view needs no copy in either direction."""

    @staticmethod
    def forward(ctx, q, k, v, pe_band, lengths, rate, seed):
        o, stats = banded_attention_train_fwd(q, k, v, pe_band, lengths,
                                              rate, seed)
        ctx.rate, ctx.seed = rate, seed
        ctx.save_for_backward(q, k, v, pe_band, lengths, o, stats)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, pe_band, lengths, o, stats = ctx.saved_tensors
        args = (q, k, v, pe_band, lengths, o, g.to(q.dtype).contiguous(),
                stats, ctx.rate, ctx.seed)
        if q.device.type == "cuda" and q.dtype == torch.bfloat16:
            out = _train_bwd_wgmma(*args)       # one bias pass for both
            dq, dband, dk, dv = out["dq"], out["dband"], out["dk"], out["dv"]
        else:
            dq, dband = banded_attention_train_bwd_dq(*args)
            dk, dv = banded_attention_train_bwd_dkv(*args)
        # the cotangent takes the primal's dtype, as in the JAX custom VJP
        return dq, dk, dv, dband.to(pe_band.dtype), None, None, None


def banded_attention_train(q, k, v, pe_band, lengths=None, *,
                           dropout_rate: float = 0.0, seed: int = 0):
    """Differentiable fused self-attention with the banded rel-pos bias,
    prefix-length masking and counter-hash probability dropout; the JAX
    contract of ``banded_attention_train`` (pallas_kernels.py:517).

    q/k/v [N, T, Dh] (q pre-scaled); pe_band [Dh, T, T]; lengths [N] int32
    contiguous valid key counts; seed: a Python int (``offset_seed`` places
    the rows of a data- or tensor-parallel rank in the global batch's
    dropout hash).  Gradients reach q, k,
    v and pe_band (contiguous or row-padded, ``band_row_stride``).  CUDA:
    T <= 1024, Dh <= 64 (bf16: a multiple of 16)."""
    N, T, _ = q.shape
    if lengths is None:
        lengths = torch.full((N,), T, dtype=torch.int32, device=q.device)
    return _BandedAttentionTrain.apply(q, k, v, pe_band, lengths,
                                       float(dropout_rate), int(seed))


# ============================================================ fused log-mel

# the kernel's limits (csrc/log_mel.cu): a power-of-two FFT whose frames
# fit its shared memory, and at most 128 mels
LOG_MEL_N_FFT_RANGE = (256, 2048)
LOG_MEL_MAX_MELS = 128
_MEL_TABLES: dict = {}


# the plain twin: the all-product formulation in f32 (the caller keeps TF32
# off on the card), [B, T] -> [B, frames, n_mels]
fused_log_mel_plain = log_mel_spectrogram


def log_mel_tables(n_fft: int, n_mels: int, sr: int, fmin: float, fmax: float,
                   device) -> tuple:
    """The log-mel kernel's tables on ``device``, built once on the host in
    float64, cast to f32 and cached:

    - window: the periodic Hann window, [n_fft] f32;
    - twiddles: [3 n_fft / 2, 2] f32 (re, im): exp(-2 pi i k / n_fft) for
      k < n_fft (the in-register and cross-lane FFT steps and the split
      into the real transform's bins), then exp(-2 pi i l k1 / M) at row
      n_fft + 32 k1 + l (M = n_fft / 2 = 32 N1, k1 < N1, lane l < 32: the
      four-step FFT's middle twiddles, one row a k1 so that a warp reads
      them in one load);
    - fb_weights: [max len, n_mels] f32, the filterbank's [start, start +
      len) slice of mel m in column m, zero below its len (transposed, so
      that the kernel's threads, one a mel, read a row in one load);
    - fb_index: [n_mels, 2] int32 (start bin, len); a mel with no non-zero
      weight has len 0.
    """
    key = (n_fft, n_mels, sr, float(fmin), float(fmax), str(device))
    tables = _MEL_TABLES.get(key)
    if tables is None:
        M = n_fft // 2
        k1, lane = np.arange(M // 32)[:, None], np.arange(32)[None, :]
        tw = np.concatenate([np.exp(-2j * np.pi * np.arange(n_fft) / n_fft),
                             np.exp(-2j * np.pi * lane * k1 / M).ravel()])
        fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
        index = []
        for row in fb:
            nz = np.flatnonzero(row)
            index.append((int(nz[0]), int(nz[-1] - nz[0] + 1)) if len(nz) else (0, 0))
        weights = np.zeros((max(1, max(n for _, n in index)), n_mels), np.float32)
        for m, (start, n) in enumerate(index):
            weights[:n, m] = fb[m, start : start + n]
        arrays = (hann_window(n_fft), np.stack([tw.real, tw.imag], axis=1), weights)
        tables = tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
                       for a in arrays)
        tables += (torch.tensor(index, dtype=torch.int32, device=device),)
        _MEL_TABLES[key] = tables
    return tables


def fused_log_mel(wav, *, sr: int = 16000, n_fft: int = 1024, hop: int = 256,
                  n_mels: int = 80, fmin: float = 80.0, fmax: float = 7600.0,
                  eps: float = 1e-10, center: bool = True):
    """[B, T] f32 waveform -> [B, frames, n_mels] f32 log10-mel, the contract
    of the JAX package's ``fused_log_mel`` and ``log_mel_spectrogram``:
    frames = 1 + T // hop with ``center`` (reflect pad n_fft // 2), else
    1 + (T - n_fft) // hop (the caller reflect-padded each utterance).  One
    kernel launch on CUDA tensors (n_fft a power of two in [256, 2048],
    hop | n_fft, n_mels <= 128); the twin on CPU ones."""
    if wav.device.type == "cpu":
        return fused_log_mel_plain(wav, sr=sr, n_fft=n_fft, hop=hop, n_mels=n_mels,
                                   fmin=fmin, fmax=fmax, eps=eps, center=center)
    if wav.dim() != 2:
        raise ValueError(f"wav must be [B, T], got {tuple(wav.shape)}")
    if wav.dtype != torch.float32:
        raise TypeError(f"wav must be float32, got {wav.dtype}")
    _check_cuda(wav)
    lo, hi = LOG_MEL_N_FFT_RANGE
    if not lo <= n_fft <= hi or n_fft & (n_fft - 1):
        raise ValueError(f"the kernel needs n_fft a power of two in [{lo}, {hi}]; "
                         f"got {n_fft}")
    if hop <= 0 or n_fft % hop != 0:
        raise ValueError(f"the kernel needs hop | n_fft; got n_fft={n_fft} hop={hop}")
    if not 0 < n_mels <= LOG_MEL_MAX_MELS:
        raise ValueError(f"kernel limit n_mels <= {LOG_MEL_MAX_MELS}; got {n_mels}")
    B, T = wav.shape
    if center and T <= n_fft // 2:
        raise ValueError(f"reflect padding needs T > n_fft // 2; got T={T}")
    if not center and T < n_fft:
        raise ValueError(f"center=False needs T >= n_fft; got T={T}")
    n_frames = 1 + (T // hop if center else (T - n_fft) // hop)
    win, tw, fb_w, fb_idx = log_mel_tables(n_fft, n_mels, sr, fmin, fmax, wav.device)
    out = torch.empty((B, n_frames, n_mels), dtype=torch.float32, device=wav.device)
    stream = torch.cuda.current_stream(wav.device).cuda_stream
    rc = _lib("log_mel").log_mel_launch(
        wav.data_ptr(), win.data_ptr(), tw.data_ptr(), fb_w.data_ptr(), fb_idx.data_ptr(),
        out.data_ptr(), B, T, n_frames, n_fft, hop, n_mels, int(bool(center)),
        float(eps), stream)
    _check_rc(rc, "fused_log_mel")
    fused_log_mel.launches += 1
    return out


fused_log_mel.launches = 0


# ================================================ flash attention + bias

FLASH_BIAS_MAX_D = 128
# the query-tiled kernel (csrc/flash_attention_bias_tiled.cu): the fewest
# queries it takes, set from both kernels' times on the card (PERF.md §6),
# and its key limit (the row's mask and tile list in shared memory)
FLASH_TILED_MIN_TQ = 32
FLASH_TILED_MAX_TK = 16384


def flash_attention_bias_plain(q, k, v, bias=None, key_valid=None, *,
                               return_max_prob=False):
    """Plain PyTorch twin of the kernel, the dense formula of the spec
    (tests/test_pallas_kernels.py:105-112): q.k in f32, plus the f32 bias,
    -1e9 where a key is invalid, f32 softmax, the probabilities cast to V's
    dtype, times V.  q [N, Tq, D] (scaled by the caller), k/v [N, Tk, D],
    bias [N, Tq, Tk] or None (zero), key_valid bool [N / R, Tk] (row n
    reads mask row n // R) or None -> [N, Tq, D] in q's dtype; with
    ``return_max_prob`` (out, the f32 softmax's largest probability [N,
    Tq]).  A row with no valid key returns the mean of V over its Tk keys."""
    s = q.float() @ k.float().transpose(1, 2)
    if bias is not None:
        s = s + bias.float()
    if key_valid is not None:
        key_valid = key_valid.repeat_interleave(q.shape[0] // key_valid.shape[0], 0)
        s = torch.where(key_valid[:, None, :], s,
                        torch.full((), NEG_INF, device=s.device))
    w = torch.softmax(s, dim=-1)
    out = (w.to(v.dtype).float() @ v.float()).to(q.dtype)
    return (out, w.amax(-1)) if return_max_prob else out


def flash_attention_bias_cached_plain(q4, k4, v4, key_valid=None, rows=None, *,
                                      return_max_prob=False):
    """Plain twin of the cached entry: gather the keys through ``rows``
    (key j of sample b from physical row rows[b, j]), lay the heads out as
    ``[B * H, T, D]`` rows and call ``flash_attention_bias_plain`` -> [B, Tq,
    H, D] (and the largest probability [B * H, Tq] with
    ``return_max_prob``)."""
    B, Tq, H, D = q4.shape
    Tk = k4.shape[1]
    if rows is not None:
        idx = (rows, torch.arange(Tk, device=k4.device))
        k4, v4 = k4[idx], v4[idx]
    heads = lambda t: t.transpose(1, 2).reshape(B * H, t.shape[1], D)
    o = flash_attention_bias_plain(heads(q4), heads(k4), heads(v4), None, key_valid,
                                   return_max_prob=return_max_prob)
    o, maxp = o if return_max_prob else (o, None)
    o = o.view(B, H, Tq, D).transpose(1, 2).contiguous()
    return (o, maxp) if return_max_prob else o


def _check_mask(key_valid, N: int, Tk: int) -> int:
    """bool [N / R, Tk] with R | N -> R (the rows that share a mask row)."""
    if (key_valid.dtype != torch.bool or key_valid.dim() != 2
            or key_valid.shape[1] != Tk or not 0 < key_valid.shape[0] <= N
            or N % key_valid.shape[0] != 0):
        raise TypeError(f"key_valid must be bool [N / R, {Tk}] with R | N = {N}, "
                        f"got {key_valid.dtype} {tuple(key_valid.shape)}")
    if not key_valid.is_contiguous():
        raise ValueError("key_valid must be contiguous")
    return N // key_valid.shape[0]


def _check_flash_d(q) -> int:
    """D a multiple of 16 or a power of two, from one 16-byte vector up to
    128 (the fusion LM's 80 included) -> elements a vector."""
    D, per_vec = q.shape[-1], 16 // q.element_size()
    if (D > FLASH_BIAS_MAX_D or D < per_vec or D % per_vec
            or (D & (D - 1) and D % 16)):
        raise ValueError(f"kernel limit: D a multiple of 16 or a power of two in "
                         f"[{per_vec}, {FLASH_BIAS_MAX_D}] for {q.dtype}; got D={D}")
    return per_vec


def flash_bias_path(Tq: int, Tk: int, D: int, dtype) -> str:
    """The kernel that serves a call of ``flash_attention_bias`` on the
    card: "tiled" (``csrc/flash_attention_bias_tiled.cu``, 64-query tiles on
    wgmma) in bf16 with D a multiple of 16 up to 64, at least
    ``FLASH_TILED_MIN_TQ`` queries and at most ``FLASH_TILED_MAX_TK`` keys;
    "split" (``csrc/flash_attention_bias.cu``, the keys split over a
    cluster) for everything else: f32, D 80 / 128, the decode steps' few
    queries.  ``flash_attention_bias_cached`` always takes the split kernel:
    it reads K and V through strides and an ancestry row map and may return
    the max-probability output, none of which the tiled kernel takes."""
    if (dtype != torch.bfloat16 or D % 16 or not 16 <= D <= 64
            or Tq < FLASH_TILED_MIN_TQ or Tk > FLASH_TILED_MAX_TK):
        return "split"
    return "tiled"


def _flash_tiled_launch(q, k, v, bias, key_valid, out, rows_per_mask):
    """One launch of the query-tiled kernel on contiguous [N, T, D] bf16
    rows, counted in ``flash_attention_bias.launches`` and
    ``.tiled_launches``."""
    N, Tq, D = q.shape
    rc = _lib("flash_attention_bias_tiled").flash_tiled_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if key_valid is None else key_valid.data_ptr(), out.data_ptr(),
        N, Tq, k.shape[1], D, rows_per_mask,
        torch.cuda.current_stream(q.device).cuda_stream)
    _check_rc(rc, "flash_attention_bias (tiled)")
    flash_attention_bias.launches += 1
    flash_attention_bias.tiled_launches += 1


def _flash_launch(q, k, v, bias, key_valid, rows, out, maxp, strides, B, H, Tq, Tk,
                  D, rows_per_mask):
    """One launch of the split-key kernel; ``strides`` the batch, token and
    head element strides of q, k, v and out (12 ints); ``maxp`` f32 [B * H,
    Tq] or None."""
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib("flash_attention_bias").flash_bias_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if key_valid is None else key_valid.data_ptr(),
        None if rows is None else rows.data_ptr(), out.data_ptr(),
        None if maxp is None else maxp.data_ptr(),
        (ctypes.c_longlong * 12)(*strides), B, H, Tq, Tk, D, rows_per_mask,
        _dtype_code(q, k, v), stream)
    _check_rc(rc, "flash_attention_bias")
    flash_attention_bias.launches += 1


def _forward_only(*tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("flash_attention_bias is forward-only; call it "
                           "under torch.no_grad()")


def flash_attention_bias(q, k, v, bias=None, key_valid=None):
    """softmax(q.k + bias, keys masked by key_valid) . v: the contract of the
    JAX package's ``flash_attention_bias`` (no scale inside: q comes
    scaled).  q [N, Tq, D], k/v [N, Tk, D] of one dtype (f32 or bf16),
    contiguous; bias f32 [N, Tq, Tk] or None for a zero bias (nothing is
    allocated); key_valid bool [N / R, Tk] or None, row n reading mask row
    n // R (one row per sample serves its R heads) -> [N, Tq, D] in q's
    dtype.  One kernel launch on CUDA tensors (D a multiple of 16 or a
    power of two, up to 128; any Tq and Tk: the kernel streams the keys),
    the kernel that ``flash_bias_path`` names; the twin on CPU ones.
    Forward only."""
    if q.device.type == "cpu":
        return flash_attention_bias_plain(q, k, v, bias, key_valid)
    _forward_only(q, k, v)
    N, Tq, D = q.shape
    Tk = k.shape[1]
    if k.shape != (N, Tk, D) or v.shape != k.shape or Tk == 0:
        raise ValueError(f"q/k/v shapes do not fit: {q.shape} {k.shape} {v.shape}")
    _check_flash_d(q)
    extra = []
    if bias is not None:
        if bias.dtype != torch.float32 or bias.shape != (N, Tq, Tk):
            raise TypeError(f"bias must be float32 {(N, Tq, Tk)}, got "
                            f"{bias.dtype} {tuple(bias.shape)}")
        extra.append(bias)
    rows_per_mask = 1
    if key_valid is not None:
        rows_per_mask = _check_mask(key_valid, N, Tk)
        extra.append(key_valid)
    _check_cuda(q, k, v, *extra)
    out = torch.empty_like(q)
    if flash_bias_path(Tq, Tk, D, q.dtype) == "tiled":
        _flash_tiled_launch(q, k, v, bias, key_valid, out, rows_per_mask)
        return out
    # [N, T, D] rows are samples of one head
    strides = [Tq * D, D, 0, Tk * D, D, 0, Tk * D, D, 0, Tq * D, D, 0]
    _flash_launch(q, k, v, bias, key_valid, None, out, None, strides, N, 1, Tq, Tk,
                  D, rows_per_mask)
    return out


def flash_attention_bias_cached(q4, k4, v4, key_valid=None, rows=None, *,
                                return_max_prob=False):
    """The same function on the decoder's layouts, K and V read where they
    lie: q4 [B, Tq, H, D] (scaled), k4/v4 [Bk, Tk, H, D] with any strides
    whose last is 1 and whose others are whole 16-byte vectors (the KV cache
    [B, Tmax, H, D], or the head-major cross K/V of ``precompute_kv``);
    ``rows`` int64 [B, Tk] or None: key j of sample b is k4[rows[b,
    j], j] (the beam's ancestry map; None: Bk == B and key j of b is k4[b,
    j]); key_valid bool [B * H / R, Tk] or None, row b * H + h reading mask
    row (b * H + h) // R ([B, Tk]: one row per sample; [1, Tk]: one for
    all) -> [B, Tq, H, D] contiguous in q4's dtype; with
    ``return_max_prob`` (out, the largest probability of row b * H + h and
    each query, f32 [B * H, Tq], from the same launch).  One launch of the
    split kernel on CUDA tensors, whatever Tq, counted in
    ``flash_attention_bias.launches``; the twin
    (gather, then the dense formula) on CPU ones.  Forward only."""
    if q4.device.type == "cpu":
        return flash_attention_bias_cached_plain(q4, k4, v4, key_valid, rows,
                                                 return_max_prob=return_max_prob)
    _forward_only(q4, k4, v4)
    if (q4.dim() != 4 or k4.dim() != 4 or k4.shape[2:] != q4.shape[2:]
            or v4.shape != k4.shape or k4.shape[1] == 0
            or (rows is None and k4.shape[0] != q4.shape[0])):
        raise ValueError(f"q/k/v shapes do not fit: {tuple(q4.shape)} "
                         f"{tuple(k4.shape)} {tuple(v4.shape)}")
    B, Tq, H, D = q4.shape
    Tk = k4.shape[1]
    per_vec = _check_flash_d(q4)
    for name, t in (("k", k4), ("v", v4)):
        if (t.stride(3) != 1 or any(st % per_vec for st in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"{name} must have d contiguous, 16-byte aligned "
                             f"rows and strides of whole 16-byte vectors; got "
                             f"strides {t.stride()}")
    if q4.stride(3) != 1:
        raise ValueError(f"q must have d contiguous; got strides {q4.stride()}")
    tensors = [q4, k4, v4]
    rows_per_mask = 1
    if key_valid is not None:
        rows_per_mask = _check_mask(key_valid, B * H, Tk)
        tensors.append(key_valid)
    if rows is not None:
        if (rows.dtype != torch.int64 or tuple(rows.shape) != (B, Tk)
                or not rows.is_contiguous()):
            raise ValueError(f"rows must be contiguous int64 {(B, Tk)}, got "
                             f"{rows.dtype} {tuple(rows.shape)}")
        tensors.append(rows)
    if any(t.device != q4.device for t in tensors):
        raise ValueError(f"expected all tensors on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    out = torch.empty(B, Tq, H, D, dtype=q4.dtype, device=q4.device)
    maxp = (torch.empty(B * H, Tq, dtype=torch.float32, device=q4.device)
            if return_max_prob else None)
    strides = [*q4.stride()[:3], *k4.stride()[:3], *v4.stride()[:3], *out.stride()[:3]]
    _flash_launch(q4, k4, v4, None, key_valid, rows, out, maxp, strides, B, H, Tq, Tk,
                  D, rows_per_mask)
    return (out, maxp) if return_max_prob else out


flash_attention_bias.launches = 0
flash_attention_bias.tiled_launches = 0     # the share of the tiled kernel


WRAPPERS = (banded_flash_attention, conv_stack, banded_attention_train_fwd,
            banded_attention_train_bwd_dq, banded_attention_train_bwd_dkv,
            fused_log_mel, flash_attention_bias)


def reset_launch_counts():
    for fn in WRAPPERS:
        fn.launches = 0
    flash_attention_bias.tiled_launches = 0


def launch_counts() -> dict:
    """Each wrapper's launches, and under "flash_attention_bias_tiled" the
    share of ``flash_attention_bias``'s that went to the tiled kernel."""
    return {**{fn.__name__: fn.launches for fn in WRAPPERS},
            "flash_attention_bias_tiled": flash_attention_bias.tiled_launches}
