"""BART-style text denoising for pretraining: a copy of
``speecht5_tpu/data/text_noising.py`` (numpy only), so a seed gives the
same noised tokens in both packages.

Behavioral spec from reference data/text_dataset.py:100-476
(TextPretrainDataset): whole-word span masking with span-Poisson lengths
(lambda 3.5), each span replaced by one <mask> (replace_length 1) or a
random token at random_ratio; optional insertion noise and rotation.
Host-side numpy, one seeded generator per item (deterministic on resume).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class NoisingConfig:
    mask_ratio: float = 0.30
    random_ratio: float = 0.10
    insert_ratio: float = 0.0
    rotate_ratio: float = 0.0
    permute_sentence_ratio: float = 0.0
    poisson_lambda: float = 3.5
    replace_length: int = 1
    max_span: int = 10


def _poisson_span_dist(lam: float, max_span: int) -> np.ndarray:
    ps = []
    p = math.exp(-lam)
    fact = 1.0
    lam_k = 1.0
    for k in range(max_span + 1):
        ps.append(p * lam_k / fact)
        lam_k *= lam
        fact *= k + 1
    ps = np.asarray(ps)
    return ps / ps.sum()


def add_whole_word_mask(
    tokens: np.ndarray,
    word_starts: np.ndarray,
    cfg: NoisingConfig,
    mask_id: int,
    vocab_size: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Mask ~mask_ratio of words in Poisson-length spans.

    tokens: [T] (with eos); word_starts: bool [T] True where a word begins.
    Returns the noised source sequence.
    """
    starts = np.flatnonzero(word_starts)
    num_words = len(starts)
    num_to_mask = int(round(num_words * cfg.mask_ratio))
    if num_to_mask == 0:
        return tokens.copy()

    dist = _poisson_span_dist(cfg.poisson_lambda, cfg.max_span)
    span_lens = rng.choice(len(dist), size=num_to_mask, p=dist)
    chosen = rng.choice(num_words, size=num_to_mask, replace=False)

    keep = np.ones(len(tokens), bool)
    masked_here = np.zeros(len(tokens), bool)
    out = tokens.copy()
    for w, sl in zip(chosen, span_lens):
        w_end = min(w + max(sl, 1), num_words)
        lo = starts[w]
        hi = starts[w_end] if w_end < num_words else len(tokens) - 1  # keep eos
        if masked_here[lo]:
            continue
        masked_here[lo:hi] = True
        if cfg.replace_length == 0:
            keep[lo:hi] = False
        else:
            # span -> single <mask> (or random token at random_ratio)
            if rng.random() < cfg.random_ratio:
                out[lo] = rng.integers(4, vocab_size)
            else:
                out[lo] = mask_id
            keep[lo + 1 : hi] = False
    return out[keep]


def add_insertion_noise(tokens: np.ndarray, p: float, mask_id: int,
                        vocab_size: int, random_ratio: float,
                        rng: np.random.Generator) -> np.ndarray:
    if p == 0.0:
        return tokens
    n = len(tokens)
    num = int(math.ceil(n * p))
    pos = rng.choice(n + num - 2, size=num, replace=False) + 1
    out = np.zeros(n + num, tokens.dtype)
    sel = np.zeros(n + num, bool)
    sel[pos] = True
    fill = np.where(
        rng.random(num) < random_ratio,
        rng.integers(4, vocab_size, num),
        mask_id,
    )
    out[sel] = fill
    out[~sel] = tokens
    return out


def noise_tokens(
    tokens: np.ndarray,
    cfg: NoisingConfig,
    mask_id: int,
    vocab_size: int,
    seed: int,
    word_sep_fn=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Apply BART noising; returns (source, target).

    target = original tokens (full reconstruction, reference default path).
    word_starts default: every token begins a word (subword-agnostic fallback).
    """
    rng = np.random.default_rng(seed)
    target = tokens.copy()
    if word_sep_fn is None:
        word_starts = np.ones(len(tokens), bool)
        word_starts[-1] = False  # eos
    else:
        word_starts = word_sep_fn(tokens)
    src = add_whole_word_mask(tokens, word_starts, cfg, mask_id, vocab_size, rng)
    if cfg.insert_ratio > 0:
        src = add_insertion_noise(
            src, cfg.insert_ratio, mask_id, vocab_size, cfg.random_ratio, rng
        )
    if cfg.rotate_ratio > 0 and rng.random() < cfg.rotate_ratio and len(src) > 2:
        offset = rng.integers(1, len(src) - 1)
        src = np.concatenate([src[offset:-1], src[:offset], src[-1:]])
    return src, target
