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
(``lexdec_*``), the binary LM writers (``lexlm_build_binary``,
``lexlm_build_kenlm_binary``), the FLAC decoder (``flac_info``,
``flac_read_i32``) and the batcher, WAV batch reader and collator of
``csrc/dataloader.cpp`` (``batch_by_size``, ``read_wav_batch``,
``collate_tokens``; JAX native.py:124-170, :228-257, which no path calls
yet).  A missing symbol raises at load, as a failed build does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import subprocess
from pathlib import Path
from typing import List, Tuple

import numpy as np

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
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
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
        # path, sample rate, channels, bits per sample, STREAMINFO MD5
        "flac_info": (i64, [cp, i32p, i32p, i32p, u8p]),
        # path, interleaved int32 out, per-channel capacity
        "flac_read_i32": (i64, [cp, i32p, i64]),
        # sizes, n, max_tokens, max_sentences, indices out, offsets out
        "batch_by_size": (i64, [i64p, i64, i64, i64, i64p, i64p]),
        # paths, n, out [n, max_samples], max_samples, lengths, sample rates
        "read_wav_batch": (None, [ctypes.POINTER(cp), i64, f32p, i64, i64p, i32p]),
        # tokens, offsets, n, max_len, pad, eos, targets out, prev out
        "collate_tokens": (None, [i64p, i64p, i64, i64, i64, i64, i64p, i64p]),
    }
    for name, (restype, argtypes) in decl.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    _LIB = lib
    return lib


def ptr(a, ctype):
    """A ctypes pointer to a contiguous numpy array's data."""
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def flac_info(path: str):
    """STREAMINFO probe (JAX native.py:172-187): (total samples, 0 when the
    stream does not say; sample rate; channels; bits per sample; MD5 of
    the samples).  Raises ValueError on a file that is not FLAC."""
    lib = load()
    sr, ch, bps = ctypes.c_int32(0), ctypes.c_int32(0), ctypes.c_int32(0)
    md5 = (ctypes.c_uint8 * 16)()
    n = lib.flac_info(path.encode(), ctypes.byref(sr), ctypes.byref(ch),
                      ctypes.byref(bps), md5)
    if n < 0:
        raise ValueError(f"not a decodable FLAC stream: {path}")
    return int(n), sr.value, ch.value, bps.value, bytes(md5)


def read_flac(path: str, normalize: bool = True) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file with ``csrc/flac.cpp`` (JAX native.py:190-225) ->
    (samples, sample rate): float32 scaled by 2^-(bps-1) when
    ``normalize``, else raw int32; 1-D for mono, [n, channels] otherwise.
    A stream whose STREAMINFO gives no length is decoded into a buffer
    bounded by the file's size and retried 8x larger while it fills (a
    CONSTANT subframe can hold a whole block in a few bytes)."""
    total, sr, ch, bps, _ = flac_info(path)
    lib = load()
    cap = total or max(os.path.getsize(path) * 2 // max(ch, 1), 1024)
    for _attempt in range(4):
        out = np.zeros(cap * ch, np.int32)
        n = lib.flac_read_i32(path.encode(), ptr(out, ctypes.c_int32), cap)
        if n < 0:
            raise ValueError(f"FLAC decode failed: {path}")
        if total or n < cap:
            break
        cap *= 8
    else:
        raise ValueError(f"FLAC stream longer than {cap} samples: {path}")
    data = out[: n * ch].reshape(n, ch)
    if normalize:
        data = data.astype(np.float32) / float(1 << (bps - 1))
    return (data[:, 0] if ch == 1 else data), sr


def batch_by_size_native(sizes, max_tokens: int, max_sentences: int = 0
                         ) -> List[np.ndarray]:
    """fairseq's batcher in C++ (JAX native.py:124-140): indices sorted by
    size (stable), cut where a batch's padded tokens would pass
    ``max_tokens`` or it would hold more than ``max_sentences`` (0: no
    limit)."""
    lib = load()
    n = len(sizes)
    sizes64 = np.ascontiguousarray(sizes, np.int64)
    out_idx = np.empty(n, np.int64)
    out_off = np.empty(n + 1, np.int64)
    nb = lib.batch_by_size(ptr(sizes64, ctypes.c_int64), n, max_tokens, max_sentences,
                           ptr(out_idx, ctypes.c_int64), ptr(out_off, ctypes.c_int64))
    return [out_idx[out_off[b] : out_off[b + 1]].copy() for b in range(nb)]


def read_wav_batch_native(paths: List[str], max_samples: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """``n`` WAV files into a zero-padded [n, max_samples] float32 array
    and their lengths (-1 for a file that cannot be read; JAX
    native.py:143-170)."""
    lib = load()
    n = len(paths)
    out = np.zeros((n, max_samples), np.float32)
    lengths = np.zeros(n, np.int64)
    srs = np.zeros(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.read_wav_batch(arr, n, ptr(out, ctypes.c_float), max_samples,
                       ptr(lengths, ctypes.c_int64), ptr(srs, ctypes.c_int32))
    return out, lengths


def collate_tokens_native(token_lists: List[np.ndarray], max_len: int, pad_id: int,
                          eos_id: int) -> Tuple[np.ndarray, np.ndarray]:
    """Targets padded to ``max_len`` and the decoder input (EOS, then the
    targets shifted right) in one native pass (JAX native.py:228-257)."""
    lib = load()
    n = len(token_lists)
    flat = np.concatenate([np.asarray(t, np.int64) for t in token_lists])
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(t) for t in token_lists], out=offsets[1:])
    tgt = np.empty((n, max_len), np.int64)
    prev = np.empty((n, max_len), np.int64)
    lib.collate_tokens(ptr(flat, ctypes.c_int64), ptr(offsets, ctypes.c_int64), n, max_len,
                       pad_id, eos_id, ptr(tgt, ctypes.c_int64), ptr(prev, ctypes.c_int64))
    return tgt, prev
