"""Manifest-TSV speech-to-text dataset and batching (the port's copy of
the s2t part of ``speecht5_tpu/data/manifests.py`` :33-210, which imports
JAX through ``ops.mel`` and so cannot be imported here).

- audio manifests: first line = root dir, then "relpath\\tnframes" rows
  (reference data/speech_to_text_dataset.py:74-140); label files are
  parallel text files, one utterance a line;
- batching by token count with length-sorted ordering (fairseq
  batch_by_size semantics);
- batches are padded to bucketed lengths, as in the JAX package, so the
  card sees few distinct shapes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .audio import layer_norm_wav, read_audio
from .dictionary import Dictionary


def load_audio_manifest(path: str) -> Tuple[str, List[str], np.ndarray]:
    with open(path, encoding="utf-8") as f:
        root = f.readline().strip()
        names, sizes = [], []
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2:
                continue
            names.append(parts[0])
            sizes.append(int(parts[1]))
    return root, names, np.asarray(sizes, np.int64)


def read_lines(path: str) -> List[str]:
    with open(path, encoding="utf-8") as f:
        return [l.rstrip("\n") for l in f]


def bucket_length(n: int, grid: Sequence[int]) -> int:
    """Smallest bucket >= n (last bucket if none)."""
    for g in grid:
        if n <= g:
            return g
    return grid[-1]


def batch_by_size(sizes: np.ndarray, max_tokens: int,
                  max_sentences: Optional[int] = None,
                  shuffle_seed: Optional[int] = None) -> List[np.ndarray]:
    """fairseq-style: order by length, fill batches until cost
    (= batch_max_len * batch_count) exceeds max_tokens."""
    order = np.argsort(sizes, kind="stable")
    batches, cur = [], []
    cur_max = 0
    for idx in order:
        n = int(sizes[idx])
        new_max = max(cur_max, n)
        if cur and (new_max * (len(cur) + 1) > max_tokens
                    or (max_sentences and len(cur) >= max_sentences)):
            batches.append(np.asarray(cur))
            cur, cur_max = [], 0
            new_max = n
        cur.append(int(idx))
        cur_max = new_max
    if cur:
        batches.append(np.asarray(cur))
    if shuffle_seed is not None:
        rng = np.random.default_rng(shuffle_seed)
        rng.shuffle(batches)
    return batches


AUDIO_BUCKETS = tuple(
    int(16000 * s) for s in (0.25, 0.5, 1, 2, 4, 6, 8, 10, 13, 16, 20, 25, 30)
)
TOKEN_BUCKETS = (16, 32, 48, 64, 96, 128, 192, 256, 384, 512, 600)


@dataclass
class SpeechToTextDataset:
    """ASR/ST: waveform source, token targets (reference
    data/speech_to_text_dataset.py:74-206)."""

    manifest: str
    labels: str                 # parallel label file (one utt per line)
    dictionary: Dictionary
    normalize: bool = False
    max_sample_size: Optional[int] = None

    def __post_init__(self):
        self.root, self.names, self.sizes = load_audio_manifest(self.manifest)
        self.label_lines = read_lines(self.labels)
        if len(self.label_lines) != len(self.names):
            raise ValueError(f"{len(self.label_lines)} labels != "
                             f"{len(self.names)} utterances")

    def __len__(self):
        return len(self.names)

    def __getitem__(self, i: int) -> Dict:
        wav, _ = read_audio(os.path.join(self.root, self.names[i]))
        if self.normalize:
            wav = layer_norm_wav(wav)
        if self.max_sample_size and len(wav) > self.max_sample_size:
            wav = wav[: self.max_sample_size]
        tokens = self.dictionary.encode_line(self.label_lines[i])
        return {"id": i, "wav": wav.astype(np.float32),
                "tokens": np.asarray(tokens, np.int64)}

    @staticmethod
    def collate(items: List[Dict], eos_id: int, pad_id: int,
                bucketed: bool = True) -> Dict[str, np.ndarray]:
        B = len(items)
        wav_len = max(len(it["wav"]) for it in items)
        tok_len = max(len(it["tokens"]) for it in items)
        if bucketed:
            wav_len = bucket_length(wav_len, AUDIO_BUCKETS)
            tok_len = bucket_length(tok_len, TOKEN_BUCKETS)
        wav = np.zeros((B, wav_len), np.float32)
        wav_lengths = np.zeros((B,), np.int32)
        targets = np.full((B, tok_len), pad_id, np.int64)
        prev = np.full((B, tok_len), pad_id, np.int64)
        for b, it in enumerate(items):
            w, t = it["wav"], it["tokens"]
            wav[b, : min(len(w), wav_len)] = w[:wav_len]
            wav_lengths[b] = min(len(w), wav_len)
            L = min(len(t), tok_len)  # clamp once: utt may exceed top bucket
            targets[b, :L] = t[:L]
            # EOS-shifted decoder input (fairseq collate_tokens
            # move_eos_to_beginning)
            prev[b, 0] = eos_id
            prev[b, 1:L] = t[: L - 1]
        return {"wav": wav, "wav_lengths": wav_lengths,
                "prev_tokens": prev, "targets": targets,
                "ids": np.asarray([it["id"] for it in items])}
