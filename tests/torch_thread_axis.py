"""W ranks of the port's data axis as threads of one process, for the CPU
tests that hold the port's sharded code against JAX's ``shard_map``.

Threads work here because CPU autograd runs on the thread that calls
``backward``, so a collective inside a backward meets the other ranks'. On
CUDA, autograd runs a device's backward on one engine thread for the whole
process, and two ranks' backwards in one process would wait for each other
there: on the card the ranks are processes (``parallel.mesh``).
"""
import functools
import threading

import torch

from simhand_tpu_torch.parallel.mesh import Axis

_REDUCE = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


class ThreadGroup:
    """Where the ranks of one run exchange their tensors."""

    def __init__(self, size: int, timeout: float = 120.0):
        self.size = size
        self.barrier = threading.Barrier(size, timeout=timeout)
        self._slots = [None] * size

    def exchange(self, index: int, x: torch.Tensor) -> list:
        """Every rank's x, in rank order, once every rank has given its own."""
        self._slots[index] = x.detach()
        self.barrier.wait()
        out = list(self._slots)
        self.barrier.wait()
        return out


class ThreadAxis(Axis):
    """Rank ``index`` of a ThreadGroup; reductions add in rank order, so
    every rank gets the same bits."""

    def __init__(self, group: ThreadGroup, index: int):
        self.group, self.index, self.size = group, index, group.size

    def gather_raw(self, x):
        return torch.cat(self.group.exchange(self.index, x))

    def reduce_raw(self, x, op):
        return functools.reduce(_REDUCE[op], self.group.exchange(self.index, x)).clone()

    def broadcast_raw(self, x, src=0):
        return self.group.exchange(self.index, x)[src].clone()


def run_ranks(size: int, fn, timeout: float = 300.0) -> list:
    """fn(axis) on ``size`` threads, one a rank; their results in rank
    order. A rank that raises breaks the others' barriers, and its error
    is raised here."""
    group = ThreadGroup(size)
    results, errors = [None] * size, [None] * size

    def target(i):
        try:
            results[i] = fn(ThreadAxis(group, i))
        except BaseException as exc:  # reported below, after every thread ends
            errors[i] = exc
            group.barrier.abort()

    threads = [threading.Thread(target=target, args=(i,), daemon=True) for i in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    if any(t.is_alive() for t in threads):
        group.barrier.abort()
        raise TimeoutError(f"ranks still running after {timeout} s")
    first = [e for e in errors if e is not None and not isinstance(e, threading.BrokenBarrierError)]
    if first or any(errors):
        raise (first or [e for e in errors if e is not None])[0]
    return results
