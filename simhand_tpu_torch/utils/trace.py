"""Named spans and counters inside the feed and the train step.

``span(name)`` is a ``torch.profiler.record_function`` range, so a span sits
in the profiler's own session, on the clock of the device operations it
launches; nothing here reads a clock of its own. With no profiler running
it returns a shared no-op context after one attribute read: it never
synchronizes, allocates on the device or reads a tensor.

The counters are integers by name, added to from any thread (the feed's
worker threads count the gather), under a lock:

  feed.batches          batches the card's prefetch handed to the step
  feed.h2d_bytes        bytes of the prefetch's copies to the card
  feed.pinned_batches   batches the card's prefetch sent straight from
                        page-locked staging, with no copy on the step's thread
  feed.staging_allocs   page-locked blocks the staging pool allocated
                        (``data/staging.py``)
  gather.bytes          bytes of records the native gather wrote
  gather.busy_ns        nanoseconds inside the native gather, summed over threads

Spans are named ``simhand.<layer>.<phase>``: ``simhand.feed.queue``,
``.slot_wait``, ``.pin``, ``.h2d`` in ``data/pipeline.py`` and
``data/prefetch.py``; ``simhand.step.augment``, ``.forward``, ``.loss``,
``.backward``, ``.optimizer`` in ``train/loop.py``.
"""
from __future__ import annotations

import contextlib
import threading

from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler records,
    else a shared no-op context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _profiler.record_function(name)


class Counters:
    """Integers by name, safe to add to from several threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}

    def add(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + int(n)

    def counters(self) -> dict[str, int]:
        """A copy of every count."""
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()


#: the process's counters, which the feed and the gather add to
COUNTERS = Counters()
add = COUNTERS.add
counters = COUNTERS.counters
reset = COUNTERS.reset
