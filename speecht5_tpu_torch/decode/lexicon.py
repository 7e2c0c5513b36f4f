"""Lexicon-constrained CTC beam decode with word n-gram LM fusion.

Port of ``speecht5_tpu/decode/lexicon.py`` (:32-355).  The reference
SpeechLM decodes CTC emissions with flashlight's C++ LexiconDecoder + KenLM
(reference SpeechLM/speechlm/infer.py:29-33,121,
config/decode/infer_kenlm.yaml); the same contract here:

- ``LexiconDecoder``: ctypes over the native decoder of
  ``csrc/ctc_beam.cpp``, built by the port's own loader
  (``data/native.py``); a failed build raises;
- ``materialize_arpa``: decompresses a ``.arpa.gz`` once for the native
  decoder (the reference decode recipe ships OpenSLR's 4-gram.arpa.gz,
  reference SpeechLM/README.md:105);
- ``build_binary_lm``: an ARPA LM compiled to the native or the KenLM
  probing binary format.

Scores are natural-log throughout.  The tests hold the native decoder
against the JAX package's Python reference (``lexicon_beam_py``,
``lexicon_beam_nbest_py`` over its ``NGramLM``).
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..data import native


def materialize_arpa(path: str) -> str:
    """A plain-text ARPA path for the native decoder: a gzipped file is
    decompressed once into ``build/arpa/``, keyed on its path and mtime
    (hashlib: a per-process ``hash()`` would defeat the cache), written
    under a temporary name and renamed into place."""
    if not path.endswith(".gz"):
        return path
    import gzip
    import hashlib
    import shutil

    key = hashlib.sha1(
        f"{os.path.abspath(path)}:{os.path.getmtime(path)}".encode()
    ).hexdigest()[:16]
    out_dir = native.REPO_DIR / "build" / "arpa"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = str(out_dir / f"s5_arpa_{key}.arpa")
    if not os.path.exists(out):
        tmp = f"{out}.{os.getpid()}.partial"
        with gzip.open(path, "rb") as f, open(tmp, "wb") as o:
            shutil.copyfileobj(f, o)
        os.replace(tmp, out)
    return out


def build_binary_lm(arpa_path: str, bin_path: str,
                    format: str = "native") -> None:
    """Compile a text ARPA LM (``.arpa.gz`` too) into a binary: ``format``
    "native" is the library's flat format, "kenlm" KenLM's probing layout
    (format version 5, PROBING model; csrc/ctc_beam.cpp documents the
    bytes).  Either, and an existing KenLM ``.bin``, goes wherever an ARPA
    path does: ``LexiconDecoder`` tells the formats apart by their magic."""
    fn = {"native": "lexlm_build_binary",
          "kenlm": "lexlm_build_kenlm_binary"}[format]
    arpa_path = materialize_arpa(arpa_path)
    rc = getattr(native.load(), fn)(arpa_path.encode(), bin_path.encode())
    if rc != 0:
        raise RuntimeError(f"{fn}({arpa_path}) failed with code {rc}")


def letter_lexicon_decoder(lexicon_path: str, dictionary, *, blank: int,
                           arpa_path: Optional[str] = None, lm_weight: float = 0.0,
                           word_score: float = 0.0, beam: int = 50) -> "LexiconDecoder":
    """A ``LexiconDecoder`` over a letter dictionary's symbols with its '|'
    as the word separator (the CLIs' lexicon arm); SystemExit when the
    dictionary has no '|'."""
    sep = dictionary.index("|")
    if sep == dictionary.unk_index:
        raise SystemExit("dictionary has no '|' word separator")
    return LexiconDecoder(lexicon_path, list(dictionary.symbols), arpa_path=arpa_path,
                          blank=blank, sep=sep, lm_weight=lm_weight,
                          word_score=word_score, beam=beam)


class LexiconDecoder:
    """Native lexicon + LM CTC beam decoder (``csrc/ctc_beam.cpp``).

    vocab: the token symbols by emission column; lexicon_path: "word tok1
    tok2 ..." lines; arpa_path: an optional ARPA (or ``.arpa.gz``, or
    binary) word LM."""

    def __init__(self, lexicon_path: str, vocab: Sequence[str], *,
                 arpa_path: Optional[str] = None, blank: int, sep: int,
                 lm_weight: float = 0.0, word_score: float = 0.0,
                 beam: int = 50):
        self._lib = native.load()
        varr = (ctypes.c_char_p * len(vocab))(*[v.encode() for v in vocab])
        if arpa_path:
            arpa_path = materialize_arpa(arpa_path)
        self._h = self._lib.lexdec_create(
            lexicon_path.encode(), (arpa_path or "").encode(), varr, len(vocab),
            blank, sep, lm_weight, word_score, beam)
        if not self._h:
            raise RuntimeError(f"failed to load lexicon {lexicon_path}")

    def decode(self, lp: np.ndarray) -> Tuple[List[int], float]:
        """lp: [T, V] natural-log posteriors -> (token ids, total score)."""
        lp = np.ascontiguousarray(lp, np.float32)
        T, V = lp.shape
        out = np.zeros((T,), np.int32)
        score = ctypes.c_double(0.0)
        n = self._lib.lexdec_decode(self._h, native.ptr(lp, ctypes.c_float), T, V,
                                    native.ptr(out, ctypes.c_int32), ctypes.byref(score))
        return out[:n].tolist(), score.value

    def decode_nbest(self, lp: np.ndarray, nbest: int = 8
                     ) -> List[Tuple[List[int], float]]:
        """lp: [T, V] natural-log posteriors -> up to ``nbest`` (token ids,
        total score) pairs, best first: the lexicon + LM constrained pass 1
        of the two-pass attention rescore."""
        lp = np.ascontiguousarray(lp, np.float32)
        T, V = lp.shape
        out_tokens = np.zeros((nbest, max(T, 1)), np.int32)
        out_lens = np.zeros((nbest,), np.int32)
        out_scores = np.zeros((nbest,), np.float64)
        n = self._lib.lexdec_decode_nbest(
            self._h, native.ptr(lp, ctypes.c_float), T, V, nbest,
            native.ptr(out_tokens, ctypes.c_int32), native.ptr(out_lens, ctypes.c_int32),
            native.ptr(out_scores, ctypes.c_double))
        return [(out_tokens[i, : out_lens[i]].tolist(), float(out_scores[i]))
                for i in range(n)]

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.lexdec_free(self._h)
            self._h = None
