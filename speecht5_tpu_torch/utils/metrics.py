"""Evaluation metrics (the port's copy of ``speecht5_tpu/utils/metrics.py``
:25-95): the edit distance, WER and CER (word and character error rates,
per utterance and over a corpus), corpus BLEU-4 for ST and the
mel-cepstral distortion for TTS / VC."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def edit_distance(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance, O(len(a)*len(b)) with two rows."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i]
        for j, y in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (x != y)))
        prev = cur
    return prev[-1]


def wer(ref: str, hyp: str) -> float:
    r, h = ref.split(), hyp.split()
    return edit_distance(r, h) / max(len(r), 1)


def corpus_wer(refs: List[str], hyps: List[str]) -> float:
    errs = total = 0
    for r, h in zip(refs, hyps):
        rs = r.split()
        errs += edit_distance(rs, h.split())
        total += len(rs)
    return errs / max(total, 1)


def cer(ref: str, hyp: str) -> float:
    return edit_distance(list(ref), list(hyp)) / max(len(ref), 1)


def corpus_bleu(refs: List[str], hyps: List[str], max_n: int = 4,
                smooth: bool = True) -> float:
    """Corpus BLEU-4 (whitespace tokens, exp brevity penalty, add-1 smoothing
    on orders with zero matches).  For ST evaluation (reference reports
    MuST-C BLEU via sacrebleu; this is the standard corpus formula)."""
    import math
    from collections import Counter

    match = [0] * max_n
    total = [0] * max_n
    hyp_len = ref_len = 0
    for ref, hyp in zip(refs, hyps):
        r = ref.split()
        h = hyp.split()
        hyp_len += len(h)
        ref_len += len(r)
        for n in range(1, max_n + 1):
            h_ngrams = Counter(
                tuple(h[i : i + n]) for i in range(len(h) - n + 1)
            )
            r_ngrams = Counter(
                tuple(r[i : i + n]) for i in range(len(r) - n + 1)
            )
            total[n - 1] += max(len(h) - n + 1, 0)
            match[n - 1] += sum(
                min(c, r_ngrams[g]) for g, c in h_ngrams.items()
            )
    log_p = 0.0
    for n in range(max_n):
        m, t = match[n], total[n]
        if t == 0:
            return 0.0
        if m == 0:
            if not smooth:
                return 0.0
            m = 1.0
            t += 1.0
        log_p += math.log(m / t)
    log_p /= max_n
    bp = 1.0 if hyp_len > ref_len else math.exp(1.0 - ref_len / max(hyp_len, 1))
    return 100.0 * bp * math.exp(log_p)


def mcd(mel_ref: np.ndarray, mel_hyp: np.ndarray) -> float:
    """Mel-cepstral distortion (dB) over the overlapping frames (log10 mels)."""
    n = min(len(mel_ref), len(mel_hyp))
    diff = mel_ref[:n] - mel_hyp[:n]
    k = 10.0 / np.log(10.0) * np.sqrt(2.0)
    return float(k * np.mean(np.sqrt(np.sum(diff ** 2, axis=-1))))
