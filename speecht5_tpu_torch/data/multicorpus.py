"""Multi-corpus joint batching for SpeechLM / SpeechUT pretraining (port of
``speecht5_tpu/data/multicorpus.py``; reference SpeechLM/speechlm/data/
multimodal_corpus_dataset.py:24 and tasks/joint_sc2t_pretrain.py:705-860).

Named sub-corpora (speech with km labels, mono units, paired units and
text) are resampled by ``sample_ratio``, batched under a scaled token
budget, rounded down to ``BATCH_SIZE_GRID`` and inner-bucket shuffled;
corpora that share a ``stream`` alternate in one slot of the joint batch,
and one update consumes ``{stream: batch}``, the dict that
``train/joint.py`` reads.  The plan is a deterministic, resumable function
of (seed, epoch, step), bit-equal to JAX's.  Host-side numpy only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .manifests import batch_by_size

#: batch sizes are rounded down to this grid, so few distinct shapes reach
#: the card
BATCH_SIZE_GRID = (1, 2, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256)


@dataclass
class TokenCorpusSpec:
    """A named sub-corpus batched by a max-token budget: ``sample_ratio``
    of all instances are drawn per epoch (full copies + a random
    remainder), under ``max_tokens * max_tokens_ratio``.  ``stream``
    defaults to "speech" for speech-prefixed names, else the name."""

    name: str
    dataset: object            # indexable, len()
    collate: Callable          # items -> batch dict
    sizes: np.ndarray          # per-item size in tokens / samples / frames
    sample_ratio: float = 1.0
    max_tokens_ratio: float = 1.0
    stream: Optional[str] = None

    def __post_init__(self):
        self.sizes = np.asarray(self.sizes, np.int64)
        assert len(self.sizes) == len(self.dataset)
        if self.stream is None:
            self.stream = "speech" if self.name.startswith("speech") else self.name


def _grid_floor(n: int, grid: Sequence[int]) -> int:
    out = 0
    for g in grid:
        if g <= n:
            out = g
    return out


def _inner_bucket_shuffle(batches: List[np.ndarray], rng, bucket: int = 10):
    """Shuffle the samples within each group of ``bucket`` length-sorted
    batches, keeping the batch sizes (reference inner_bucket_shuffle,
    multimodal_corpus_dataset.py:335-356)."""
    out: List[np.ndarray] = []
    for i in range(0, len(batches), bucket):
        group = batches[i : i + bucket]
        flat = np.concatenate(group)
        rng.shuffle(flat)
        out.extend(np.array_split(flat, np.cumsum([len(b) for b in group])[:-1]))
    return out


class MultiCorpusLoader:
    """Joint loader over ``specs``: per epoch each corpus draws its
    instances, batches them, rounds the batch sizes down to the grid
    (dropping a random subset) and inner-bucket shuffles; each stream's
    batches are then permuted, and the epoch yields as many joint steps as
    its shortest stream has batches."""

    def __init__(self, specs: Sequence[TokenCorpusSpec], max_tokens: int,
                 seed: int = 1, max_sentences: Optional[int] = None,
                 batch_size_grid: Optional[Sequence[int]] = BATCH_SIZE_GRID,
                 inner_bucket: int = 10):
        self.specs = list(specs)
        assert self.specs, "need at least one corpus"
        names = [s.name for s in self.specs]
        assert len(set(names)) == len(names), f"duplicate corpus names: {names}"
        self.max_tokens = max_tokens
        self.seed = seed
        self.max_sentences = max_sentences
        self.batch_size_grid = tuple(batch_size_grid) if batch_size_grid else None
        self.inner_bucket = inner_bucket
        self.total_instances = sum(len(s.dataset) for s in self.specs)

    def _sample_indices(self, spec: TokenCorpusSpec, rng) -> np.ndarray:
        n = len(spec.dataset)
        num_instances = max(int(spec.sample_ratio * self.total_instances), 1)
        num_copies = num_instances // n
        idx = rng.permutation(n)[: num_instances - num_copies * n]
        if num_copies > 0:
            idx = np.concatenate([np.repeat(np.arange(n), num_copies), idx])
        rng.shuffle(idx)
        return idx.astype(np.int64)

    def _corpus_batches(self, spec: TokenCorpusSpec, rng) -> List[np.ndarray]:
        idx = self._sample_indices(spec, rng)
        budget = max(int(round(self.max_tokens * spec.max_tokens_ratio)),
                     int(spec.sizes.max()))
        batches = [idx[b] for b in batch_by_size(spec.sizes[idx], budget,
                                                 max_sentences=self.max_sentences)]
        if self.batch_size_grid is not None:
            out = []
            for b in batches:
                keep = _grid_floor(len(b), self.batch_size_grid)
                if keep:
                    out.append(b[rng.permutation(len(b))[:keep]] if keep < len(b) else b)
            batches = out
        return _inner_bucket_shuffle(batches, rng, self.inner_bucket)

    def epoch_plan(self, epoch: int) -> Tuple[Dict[str, List], int]:
        """-> ({stream: [(spec, item indices), ...]}, number of joint steps)."""
        streams: Dict[str, List] = {}
        for ci, spec in enumerate(self.specs):
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch, ci]))
            for b in self._corpus_batches(spec, rng):
                streams.setdefault(spec.stream, []).append((spec, b))
        for si, (name, blist) in enumerate(sorted(streams.items())):
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch, 7919 + si]))
            streams[name] = [blist[i] for i in rng.permutation(len(blist))]
        return streams, min(len(b) for b in streams.values())

    def steps_per_epoch(self, epoch: int) -> int:
        return self.epoch_plan(epoch)[1]

    def iter_epoch(self, epoch: int, start_step: int = 0):
        """Yield (step, {stream: collated batch}); step i of epoch e is
        always the same joint batch."""
        streams, n_steps = self.epoch_plan(epoch)
        for step in range(start_step, n_steps):
            joint = {}
            for name, blist in streams.items():
                spec, idxs = blist[step]
                joint[name] = spec.collate([spec.dataset[int(i)] for i in idxs])
            yield step, joint
