"""Background-thread batch prefetching (the port's copy of
``speecht5_tpu/data/prefetch.py``): the host data path runs in a worker
thread while the card executes the previous step.  Exceptions propagate to
the consumer; closing the generator (or leaving it early) stops the
worker."""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator


def prefetch(it: Iterable, depth: int = 2) -> Iterator:
    """Run ``it`` in a daemon thread, buffering up to ``depth`` items."""
    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
    END = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not put(item):
                    return
            put(END)
        except BaseException as e:  # forward to the consumer
            put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is END:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=30)
