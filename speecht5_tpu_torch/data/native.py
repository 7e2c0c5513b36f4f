"""The port's ctypes loader of the repository's native library
(``csrc/dataloader.cpp``, ``csrc/ctc_beam.cpp``, ``csrc/flac.cpp``).

Counterpart of ``speecht5_tpu/data/native.py`` (:57-100), with two
deliberate differences:

- it never writes under ``csrc/``: the library is compiled at first use
  with ``g++`` and ``csrc/Makefile``'s flags into
  ``build/native/<hash of sources and flags>/libspeechdata.so``, written
  under a temporary name and renamed into place, so concurrent processes
  (pytest-xdist workers, the JAX package's own in-place ``make``) never
  race on one file;
- a failed build raises with the compiler's stderr; there is no pure
  Python fallback behind the served paths (the Python references in
  ``decode/nbest.py`` and ``decode/lexicon.py`` are for tests).

Only the symbols the port calls are declared: the open-vocabulary N-best
CTC beam (``ctc_nbest``, ``ctc_nbest_batch``), the lexicon decoder
(``lexdec_*``) and the binary LM writers (``lexlm_build_binary``,
``lexlm_build_kenlm_binary``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import subprocess
from pathlib import Path

REPO_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = REPO_DIR / "csrc"
BUILD_ROOT = REPO_DIR / "build" / "native"
SOURCES = ("dataloader.cpp", "ctc_beam.cpp", "flac.cpp")
LIB_NAME = "libspeechdata.so"

_LIB = None


def cxx_flags() -> list:
    """The ``CXXFLAGS ?=`` line of ``csrc/Makefile``."""
    for line in (CSRC_DIR / "Makefile").read_text().splitlines():
        name, sep, value = line.partition("?=")
        if sep and name.strip() == "CXXFLAGS":
            return shlex.split(value)
    raise RuntimeError(f"no CXXFLAGS line in {CSRC_DIR / 'Makefile'}")


def build_command(output: Path) -> list:
    return ["g++", *cxx_flags(), "-shared", "-o", str(output),
            *(str(CSRC_DIR / s) for s in SOURCES)]


def build_dir() -> Path:
    """``build/native/<hash>``: the hash covers the sources and the flags,
    so an edited source never loads a stale library."""
    h = hashlib.sha256(" ".join(cxx_flags()).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile the library if it is not built yet; returns its path.
    Raises RuntimeError with the compiler's stderr if the build fails."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(build_command(tmp), capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: the native library cannot be built "
                           f"({e})") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {LIB_NAME} failed (exit {proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The native library, built at first use, its port symbols declared."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    i64, i32, f64 = ctypes.c_int64, ctypes.c_int32, ctypes.c_double
    vp, cp = ctypes.c_void_p, ctypes.c_char_p
    decl = {
        # lp, T, V, blank, beam, nbest, topk, blank_thresh, tokens, lens, scores
        "ctc_nbest": (i64, [f32p, i64, i64, i32, i32, i32, i32, f64, i32p, i32p, f64p]),
        # lp, lens, B, Tmax, V, blank, beam, nbest, topk, blank_thresh,
        # n_threads, tokens, lens, scores, counts
        "ctc_nbest_batch": (i64, [f32p, i32p, i64, i64, i64, i32, i32, i32, i32, f64,
                                  i32, i32p, i32p, f64p, i32p]),
        # lexicon path, ARPA / binary LM path, vocab, V, blank, sep,
        # lm_weight, word_score, beam
        "lexdec_create": (vp, [cp, cp, ctypes.POINTER(cp), i64, i32, i32, f64, f64, i32]),
        "lexdec_decode": (i64, [vp, f32p, i64, i64, i32p, f64p]),
        "lexdec_decode_nbest": (i64, [vp, f32p, i64, i64, i32, i32p, i32p, f64p]),
        "lexdec_free": (None, [vp]),
        "lexlm_build_binary": (i32, [cp, cp]),
        "lexlm_build_kenlm_binary": (i32, [cp, cp]),
    }
    for name, (restype, argtypes) in decl.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    _LIB = lib
    return lib


def ptr(a, ctype):
    """A ctypes pointer to a contiguous numpy array's data."""
    return a.ctypes.data_as(ctypes.POINTER(ctype))
