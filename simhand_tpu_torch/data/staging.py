"""Page-locked staging for the raw route's batches.

The feed's worker threads gather each raw batch straight into page-locked
host memory (``PretrainDataset.raw_batch(indices, stage)`` with
``StagingPool.take``), so that ``data.prefetch.device_prefetch`` sends it to
the card as it is, with no copy on the step's thread. The memory comes from
one bounded pool for the whole process (``shared_pool``), which every
``batch_iterator(raw=True)`` draws from: page-locked memory is allocated only
while the pool grows to its working size, never again after it.

A batch's arrays lie in one block of the pool, held by a lease that every
array of the batch, and every view of one, keeps alive. When the last of
them is freed, the block goes back to the pool with the events of the copies
made out of it (``after_copy``). The pool hands a block out again only after
those events have completed; the worker that takes it waits for them, never
the step's thread. A batch that never reaches the card gives its block back
the same way, when it is freed.

The pool allocates all its blocks at its first use, in a run's set-up. A
worker waits for the copies of a returned block rather than allocate more.
Where every block is held by a live batch (a consumer that keeps batches, or
several iterators at once) the pool gives none, and the batch is gathered
into ordinary memory, which the prefetch copies as before. The counter
``feed.staging_allocs`` (``utils/trace.py``) counts the blocks it allocated.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable

import numpy as np
import torch

from simhand_tpu_torch.utils import trace

#: blocks in use at once on the raw route: batch_iterator's window (two
#: batches a worker, at most two workers), the prefetch's depth (2) and the
#: batch the step holds
LIMIT = 2 * 2 + 2 + 1
#: the alignment of each array inside its block, in bytes
ALIGN = 256


def page_locked_memory(nbytes: int) -> np.ndarray:
    """``nbytes`` of page-locked host memory, as a uint8 array."""
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True).numpy()


class _Block:
    """A block of host memory, whether it is page-locked (asked once, when it
    is made), and the events of the last copies out of it."""

    def __init__(self, memory: np.ndarray):
        self.memory = memory
        self.locked = torch.from_numpy(memory).is_pinned()
        self.events: list = []


class _Lease:
    """One batch's hold on a block. The arrays made from it keep it alive;
    its end returns the block, with the events of the copies made out of it,
    to the pool."""

    def __init__(self, returned: queue.SimpleQueue, block: _Block, nbytes: int):
        self._returned, self.block = returned, block
        self.__array_interface__ = {"data": (block.memory.ctypes.data, False),
                                    "shape": (nbytes,), "typestr": "|u1", "version": 3}

    def __del__(self):
        # SimpleQueue.put may run in a finalizer, on any thread
        self._returned.put(self.block)


class StagingPool:
    """A bounded pool of host memory blocks, one a raw batch.

    ``alloc(nbytes)`` gives a block as a uint8 array (``page_locked_memory``;
    a test passes ordinary memory). The events that ``after_copy`` attaches
    need ``query()`` and ``synchronize()``, as a ``torch.cuda.Event`` has."""

    def __init__(self, limit: int = LIMIT,
                 alloc: Callable[[int], np.ndarray] = page_locked_memory):
        self.limit, self._alloc = limit, alloc
        self._lock = threading.Lock()
        self._returned: queue.SimpleQueue = queue.SimpleQueue()
        self._free: list[_Block] = []
        self.blocks = 0                  # allocated and kept

    def take(self, layout: dict) -> dict[str, np.ndarray] | None:
        """Arrays of ``layout`` ({key: (shape, dtype)}, C order) in one block,
        once the block's last copies have completed; None where every block
        is held by a live batch."""
        spans, nbytes = {}, 0
        for k, (shape, dtype) in layout.items():
            size = int(np.prod(shape)) * np.dtype(dtype).itemsize
            spans[k] = (nbytes, size)
            nbytes += -(-size // ALIGN) * ALIGN
        with self._lock:
            block = self._pick(nbytes)
        if block is None:
            return None
        for e in block.events:
            e.synchronize()              # the last copies out of the block
        block.events = []
        if block.memory.nbytes < nbytes:  # too small for this layout: a new one in its place
            try:
                block = _Block(self._alloc(nbytes))
            except BaseException:
                with self._lock:
                    self.blocks -= 1
                raise
        whole = np.asarray(_Lease(self._returned, block, nbytes))
        return {k: whole[o:o + size].view(np.dtype(layout[k][1])).reshape(layout[k][0])
                for k, (o, size) in spans.items()}

    def _pick(self, nbytes: int) -> _Block | None:
        """Under the lock: a free block of ``nbytes`` whose copies have
        completed, else one whose copies are still running, else a smaller
        one to replace. The first call grows the pool to its limit at once,
        so that no page-locked memory is allocated after a run's first
        batch."""
        while self.blocks < self.limit:
            self._free.append(_Block(self._alloc(nbytes)))
            self.blocks += 1
            trace.add("feed.staging_allocs")
        self._drain()
        fits = [i for i, b in enumerate(self._free) if b.memory.nbytes >= nbytes]
        for i in fits:
            if all(e.query() for e in self._free[i].events):
                return self._free.pop(i)
        if fits:
            return self._free.pop(fits[0])
        if self._free:
            trace.add("feed.staging_allocs")
            return self._free.pop(0)
        return None

    def free_blocks(self) -> int:
        """Blocks that no live batch holds."""
        with self._lock:
            self._drain()
            return len(self._free)

    def _drain(self) -> None:
        while True:
            try:
                self._free.append(self._returned.get_nowait())
            except queue.Empty:
                return


def _lease(a) -> _Lease | None:
    """The lease of the block that ``a`` lies in, if it lies in one."""
    while isinstance(a, np.ndarray):
        a = a.base
    return a if isinstance(a, _Lease) else None


def page_locked(arrays: dict) -> dict[str, bool]:
    """Whether each array is page-locked: as its block was found when it was
    made, or asked of the array itself (``Tensor.is_pinned``) where it lies
    in no block."""
    out = {}
    for k, a in arrays.items():
        lease = _lease(a)
        out[k] = lease.block.locked if lease else torch.from_numpy(np.asarray(a)).is_pinned()
    return out


def after_copy(arrays: Iterable[np.ndarray], event) -> None:
    """Marks the blocks under ``arrays`` as read by the copies that ``event``
    follows: the pool hands none of them out again before it has completed."""
    for a in arrays:
        lease = _lease(a)
        if lease is not None and not any(e is event for e in lease.block.events):
            lease.block.events.append(event)


_shared: StagingPool | None = None
_shared_lock = threading.Lock()


def shared_pool() -> StagingPool | None:
    """The process's pool, made at its first use; None without a card, where
    no memory can be page-locked."""
    global _shared
    if not torch.cuda.is_available():
        return None
    with _shared_lock:
        if _shared is None:
            _shared = StagingPool()
        return _shared
