"""Double-buffers host batches onto the card (counterpart of the single-device
half of ``simhand_tpu/parallel/mesh.py:device_prefetch``).

Each batch goes to the card with ``non_blocking`` copies on a side stream, so
batch n + 1 crosses PCIe while batch n computes. An array that is already
page-locked (the raw route gathers into ``data.staging``'s pool) is copied
to the card as it is, and the copy's event goes to its block, which the pool
refills only after that event; any other array is first copied into pinned
host buffers on the step's thread, which are filled again only after their
last copy's event has completed. The consumer's stream waits on the copy's
event (the host does not), and the device tensors are recorded on the
consumer's stream so the allocator keeps them until the consumer's work on
them is done. The spans ``simhand.feed.slot_wait``, ``.pin`` and ``.h2d``
and the counters ``feed.batches``, ``feed.h2d_bytes`` and
``feed.pinned_batches`` (``utils/trace.py``) mark those phases on the card's
route.
"""
from __future__ import annotations

import collections
from typing import Iterator

import numpy as np
import torch

from simhand_tpu_torch.data import staging
from simhand_tpu_torch.device import resolve_device
from simhand_tpu_torch.utils import trace


class _Slot:
    """Pinned host buffers for the arrays that are not page-locked, and the
    event of their last copy."""

    def __init__(self):
        self.host: dict[str, torch.Tensor] = {}
        self.copied: torch.cuda.Event | None = None

    def fill(self, batch: dict) -> tuple[dict[str, torch.Tensor], bool]:
        """The batch as page-locked tensors, and whether it was so already:
        a page-locked array as it is, any other copied into these buffers."""
        with trace.span("simhand.feed.pin"):
            host = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
            copy = [k for k, locked in staging.page_locked(batch).items() if not locked]
        if not copy:
            return host, True
        if self.copied is not None:
            with trace.span("simhand.feed.slot_wait"):
                self.copied.synchronize()   # the last copy out of these buffers
        with trace.span("simhand.feed.pin"):
            for k in copy:
                t, buf = host[k], self.host.get(k)
                if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                    buf = self.host[k] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t)
                host[k] = buf
        return host, False


def device_prefetch(iterator, device=None, depth: int = 2) -> Iterator[dict]:
    """Yields each numpy batch of ``iterator`` as tensors on ``device`` (the
    card unless the caller passes ``device="cpu"``), ``depth`` batches
    ahead of the consumer."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        for batch in iterator:
            yield {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        return
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.Stream(dev)
    slots = [_Slot() for _ in range(depth)]
    pending: collections.deque = collections.deque()

    def put(n: int, batch: dict):
        slot = slots[n % depth]
        host, pinned = slot.fill(batch)
        with trace.span("simhand.feed.h2d"), torch.cuda.stream(stream):
            out = {k: t.to(dev, non_blocking=True) for k, t in host.items()}
            slot.copied = torch.cuda.Event()
            slot.copied.record(stream)
        staging.after_copy(batch.values(), slot.copied)
        trace.add("feed.h2d_bytes", sum(t.nbytes for t in host.values()))
        trace.add("feed.pinned_batches", int(pinned))
        return out, slot.copied

    def take(item):
        out, copied = item
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(copied)
        for t in out.values():
            t.record_stream(consumer)
        trace.add("feed.batches")
        return out

    for n, batch in enumerate(iterator):
        pending.append(put(n, batch))
        if len(pending) >= depth:
            yield take(pending.popleft())
    while pending:
        yield take(pending.popleft())
