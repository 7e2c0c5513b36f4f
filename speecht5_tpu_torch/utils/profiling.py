"""Tracing and phase timing (port of ``speecht5_tpu/utils/profiling.py``).

- ``PhaseTimer``: named wall-clock phases; a phase closed with ``fence``
  (a tensor, or True) first waits for the card (``torch.cuda.synchronize``)
  so that its time covers the device work it queued.  One line per phase
  when ``verbose``.
- ``trace``: a ``torch.profiler`` trace of the CPU and the card around a
  block, written to a directory as a Chrome trace (``trace.json``) with a
  table of the device time by kernel (``key_averages.txt``).
- ``annotate``: a named region in the profiler's timeline
  (``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Dict, Optional

import torch


def _fence(fence):
    if fence is None or fence is False:
        return
    dev = fence.device if torch.is_tensor(fence) else None
    if (dev is None or dev.type == "cuda") and torch.cuda.is_available():
        torch.cuda.synchronize(dev)


class PhaseTimer:
    """Wall-clock phase timing with an optional device fence (JAX :21).

    >>> pt = PhaseTimer("train")
    >>> pt.phase("data")                    # closes the previous phase
    >>> pt.phase("log", fence=metrics["loss"])   # waits for the card first
    >>> pt.report()                         # {phase: seconds}
    """

    def __init__(self, name: str = "", stream=None, verbose: bool = True):
        self.name = name
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._cur: Optional[str] = None
        self._t0 = time.perf_counter()
        self._start = self._t0
        self.stream = stream if stream is not None else sys.stderr
        self.verbose = verbose

    def _close(self, fence=None):
        _fence(fence)
        if self._cur is not None:
            dt = time.perf_counter() - self._t0
            self.totals[self._cur] = self.totals.get(self._cur, 0.0) + dt
            self.counts[self._cur] = self.counts.get(self._cur, 0) + 1

    def phase(self, name: Optional[str], fence=None):
        """Close the current phase (waiting for the card first when
        ``fence`` is given) and start ``name`` (None: just close)."""
        self._close(fence)
        self._cur = name
        self._t0 = time.perf_counter()
        if self.verbose and name is not None:
            print(f"[{self.name} {self._t0 - self._start:8.1f}s] -> {name}",
                  file=self.stream, flush=True)

    def report(self) -> Dict[str, float]:
        self._close()
        self._cur = None
        return dict(self.totals)

    def summary(self) -> str:
        rep = self.report()
        total = sum(rep.values()) or 1.0
        return " | ".join(
            f"{k}: {v:.2f}s ({100 * v / total:.0f}%, n={self.counts[k]})"
            for k, v in sorted(rep.items(), key=lambda kv: -kv[1]))


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` around a block (CPU, and CUDA when a card is
    present); on exit writes ``<log_dir>/trace.json`` (Chrome trace) and
    ``<log_dir>/key_averages.txt`` (time by op and kernel) (JAX :77)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        _fence(torch.cuda.is_available())
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
        table = None
        for sort in ("device_time_total", "cuda_time_total", "cpu_time_total"):
            try:    # the device column's name differs between torch versions
                table = prof.key_averages().table(sort_by=sort, row_limit=60)
                break
            except (AttributeError, KeyError, ValueError):
                continue
        with open(os.path.join(log_dir, "key_averages.txt"), "w", encoding="utf-8") as f:
            f.write(table or "")


def annotate(name: str):
    """A named region in the profiler's timeline (JAX :88)."""
    return torch.profiler.record_function(name)
