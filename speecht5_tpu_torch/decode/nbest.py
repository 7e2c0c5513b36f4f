"""Open-vocabulary N-best CTC prefix beam search.

Port of ``speecht5_tpu/decode/nbest.py`` (:58-176).  Pass 1 of the
two-pass CTC -> attention-rescore decode: a lexicon-free prefix beam
(Graves 2012 / Hannun 2014) over the encoder's CTC posteriors keeps the N
best label prefixes; pass 2 (``decode/asr.RescoreDecoder``) scores them
with one teacher-forced decoder forward.

- ``ctc_nbest`` / ``ctc_nbest_batch``: the native decoder of
  ``csrc/ctc_beam.cpp`` through the port's loader (``data/native.py``).
  Unlike the JAX module, which falls back to Python when its library does
  not load (:122-125), these raise: the served path never silently runs
  a Python copy.  The tests hold them against the JAX package's Python
  reference, ``ctc_nbest_py``.

Scores are natural-log throughout.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np

from ..data import native


def ctc_nbest(lp: np.ndarray, *, blank: int, beam: int = 16, nbest: int = 8,
              topk: int = 0, blank_thresh: float = 0.0
              ) -> List[Tuple[List[int], float]]:
    """N-best CTC prefix beam over one utterance's [T, V] natural-log
    posteriors, in the native library -> up to ``nbest`` (token ids, total
    log-prob) pairs, best first.  ``topk`` restricts each frame's extension
    candidates to the top-k emissions (0 = all); blank and the repeat-last
    transition are always considered.  Frames with ``lp[blank] >
    blank_thresh`` (natural log; >= 0 disables) take only the stay
    transitions: trained CTC models emit ~90% such frames."""
    lib = native.load()
    lp = np.ascontiguousarray(lp, np.float32)
    T, V = lp.shape
    out_tokens = np.zeros((nbest, max(T, 1)), np.int32)
    out_lens = np.zeros((nbest,), np.int32)
    out_scores = np.zeros((nbest,), np.float64)
    n = lib.ctc_nbest(native.ptr(lp, ctypes.c_float), T, V, blank, beam, nbest, topk,
                      blank_thresh, native.ptr(out_tokens, ctypes.c_int32),
                      native.ptr(out_lens, ctypes.c_int32),
                      native.ptr(out_scores, ctypes.c_double))
    return [(out_tokens[i, : out_lens[i]].tolist(), float(out_scores[i]))
            for i in range(n)]


def ctc_nbest_batch(lp: np.ndarray, lens: np.ndarray, *, blank: int,
                    beam: int = 16, nbest: int = 8, topk: int = 0,
                    blank_thresh: float = 0.0, n_threads: int = 0
                    ) -> List[List[Tuple[List[int], float]]]:
    """Batched N-best over [B, Tmax, V] posteriors with per-utterance frame
    counts; the utterances decode independently on the native library's
    worker pool (``n_threads`` 0 = hardware concurrency)."""
    lib = native.load()
    B, Tmax, V = lp.shape
    lens = np.ascontiguousarray(lens, np.int32)
    lp = np.ascontiguousarray(lp, np.float32)
    out_tokens = np.zeros((B, nbest, max(Tmax, 1)), np.int32)
    out_lens = np.zeros((B, nbest), np.int32)
    out_scores = np.zeros((B, nbest), np.float64)
    out_counts = np.zeros((B,), np.int32)
    lib.ctc_nbest_batch(native.ptr(lp, ctypes.c_float), native.ptr(lens, ctypes.c_int32),
                        B, Tmax, V, blank, beam, nbest, topk, blank_thresh, n_threads,
                        native.ptr(out_tokens, ctypes.c_int32),
                        native.ptr(out_lens, ctypes.c_int32),
                        native.ptr(out_scores, ctypes.c_double),
                        native.ptr(out_counts, ctypes.c_int32))
    return [[(out_tokens[b, i, : out_lens[b, i]].tolist(), float(out_scores[b, i]))
             for i in range(out_counts[b])] for b in range(B)]
