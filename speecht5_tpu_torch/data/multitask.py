"""Ratio-balanced multitask batch scheduling (port of
``speecht5_tpu/data/multitask.py``; reference data/multitask_dataset.py
:21-265): batches stay modality-pure, each sub-dataset is batched under its
own token budget, batch lists are resampled by ``sample_ratio`` and
interleaved by a seeded permutation, so the schedule is a deterministic,
resumable function of (seed, epoch, start_batch), bit-equal to JAX's.
Host-side numpy only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np

from .manifests import batch_by_size


@dataclass
class TaskSpec:
    name: str
    dataset: object                  # indexable with .sizes
    collate: Callable                # items -> batch dict
    max_tokens: int
    sample_ratio: float = 1.0


class MultitaskLoader:
    """Deterministic interleaved loader over several task datasets."""

    def __init__(self, specs: Sequence[TaskSpec], seed: int = 1,
                 max_sentences: Optional[int] = None):
        self.specs = list(specs)
        self.seed = seed
        self._batches: List[tuple] = []  # (spec index, item indices)
        for si, spec in enumerate(self.specs):
            bs = batch_by_size(np.asarray(spec.dataset.sizes), spec.max_tokens,
                               max_sentences)
            n = int(len(bs) * spec.sample_ratio)
            self._batches.extend((si, bs[i % len(bs)]) for i in range(n))

    def epoch_schedule(self, epoch: int) -> List[tuple]:
        order = np.random.default_rng(self.seed + epoch).permutation(len(self._batches))
        return [self._batches[i] for i in order]

    def iter_epoch(self, epoch: int, start_batch: int = 0):
        """Yields (task name, collated batch); ``start_batch`` resumes
        mid-epoch."""
        sched = self.epoch_schedule(epoch)
        for si, item_idxs in sched[start_batch:]:
            spec = self.specs[si]
            yield spec.name, spec.collate([spec.dataset[int(i)] for i in item_idxs])

    def __len__(self):
        return len(self._batches)
