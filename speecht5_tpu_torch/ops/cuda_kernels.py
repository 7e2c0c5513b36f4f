"""Hand-written CUDA kernels of the port, their plain PyTorch twins, and the
loader that builds them.

Two kernels carry the ASR serving path (``speecht5_tpu/ops/pallas_kernels.py``
holds the TPU kernels they replace):

- ``banded_flash_attention`` (``csrc/banded_attention.cu``): encoder
  self-attention with the clipped relative-position bias computed in-kernel
  from the shared ``[Dh, T, T]`` band; replaces ``banded_flash_attention``
  (pallas_kernels.py:215).
- ``conv_stack`` (``csrc/conv_stack.cu``): feature-extractor layers 1..n,
  each a VALID strided Conv1d without bias followed by the exact GELU;
  replaces ``conv_stack_pallas`` / ``conv_stack_fused`` (pallas_kernels.py
  :714, :783).  One launch per layer.

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

import torch
import torch.nn.functional as F

NEG_INF = -1e9

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_ROOT = _PKG_DIR.parent / "build" / "torch_kernels"
SOURCES = {
    "banded_attention": "banded_attention.cu",
    "conv_stack": "conv_stack.cu",
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
    """``build/torch_kernels/<hash>``: the hash covers every source and the
    flags, so an edited source never loads a stale library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(SOURCES):
        h.update(name.encode())
        h.update((CSRC_DIR / SOURCES[name]).read_bytes())
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
        if name == "banded_attention":
            lib.banded_attention_launch.argtypes = [vp] * 6 + [i] * 4 + [vp]
            lib.banded_attention_launch.restype = i
        else:
            lib.conv_gelu_launch.argtypes = [vp] * 3 + [i] * 8 + [vp]
            lib.conv_gelu_launch.restype = i
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


def banded_flash_attention(q, k, v, pe_band, lengths=None):
    """Fused self-attention with the SpeechT5 rel-pos bias computed in-kernel
    from the shared band.  Same contract as the JAX package's
    ``banded_flash_attention``: q/k/v [N, T, Dh] (q pre-scaled), pe_band
    [Dh, T, T], lengths [N] -> [N, T, Dh] in q's dtype.  CUDA: T <= 1024,
    Dh <= 128."""
    if q.device.type == "cpu":
        return banded_flash_attention_plain(q, k, v, pe_band, lengths)
    N, T, Dh = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if pe_band.shape != (Dh, T, T):
        raise ValueError(f"pe_band shape {tuple(pe_band.shape)} != {(Dh, T, T)}")
    if T > 1024 or Dh > 128:
        raise ValueError(f"kernel limits T <= 1024, Dh <= 128; got T={T} Dh={Dh}")
    if lengths is None:
        lengths = torch.full((N,), T, dtype=torch.int32, device=q.device)
    if lengths.dtype != torch.int32 or lengths.shape != (N,):
        raise TypeError("lengths must be int32 [N]")
    _check_cuda(q, k, v, pe_band, lengths)
    code = _dtype_code(q, k, v, pe_band)
    lib = _lib("banded_attention")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.banded_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pe_band.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), N, T, Dh, code, stream)
    _check_rc(rc, "banded_attention")
    banded_flash_attention.launches += 1
    return out


banded_flash_attention.launches = 0


# ====================================================== conv-FE stack


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


def conv_stack(x, weights, specs):
    """Strided conv + exact GELU stack: [B, T, Cin] -> [B, T_out, Cout].

    ``specs``: ((k, s), ...) per layer; ``weights``: matching [k, Cin, Cout]
    tensors, cast to x's dtype as the JAX kernel does.  VALID padding, no
    bias.  On CUDA: one kernel launch per layer."""
    if x.device.type == "cpu":
        return conv_stack_plain(x, weights, specs)
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, C], got {tuple(x.shape)}")
    code = _dtype_code(x)
    lib = _lib("conv_stack")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for (k, s), w in zip(specs, weights):
        B, T, Cin = x.shape
        if w.dim() != 3 or w.shape[0] != k or w.shape[1] != Cin:
            raise ValueError(f"weight {tuple(w.shape)} does not match k={k}, Cin={Cin}")
        w = w.to(x.dtype).contiguous()
        _check_cuda(x, w)
        n_out = (T - k) // s + 1
        if n_out <= 0:
            raise ValueError(f"input of {T} frames is shorter than kernel {k}")
        Cout = w.shape[2]
        y = torch.empty((B, n_out, Cout), dtype=x.dtype, device=x.device)
        rc = lib.conv_gelu_launch(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                  B, T, Cin, n_out, Cout, k, s, code, stream)
        _check_rc(rc, "conv_stack")
        conv_stack.launches += 1
        x = y
    return x


conv_stack.launches = 0


def reset_launch_counts():
    banded_flash_attention.launches = 0
    conv_stack.launches = 0


def launch_counts() -> dict:
    return {
        "banded_flash_attention": banded_flash_attention.launches,
        "conv_stack": conv_stack.launches,
    }
