"""The data-parallel axis (counterpart of ``simhand_tpu/parallel/mesh.py``).

The pre-training workload is pure data parallelism: a 1-D "data" axis over
one process a GPU. The contrastive losses all-gather the (2B, 128)
projections over it and reduce the batch statistics, so every rank holds
its row shard of the global similarity matrix.

An axis is an object with ``index`` (this rank) and ``size`` (the world),
and the collectives as methods. Each collective differentiates as JAX's
does under ``shard_map(check_vma=False)``:

  * ``all_gather(x)`` is tiled on dim 0; its backward sums the cotangent
    over the ranks and keeps this rank's rows (``psum_scatter``);
  * ``psum(x)``'s backward is ``psum`` and ``pmean(x)``'s is ``pmean``;
  * ``pmin``, ``pmax`` and ``broadcast`` carry no gradient.

So a rank's backward through a loss that every rank computes whole gives
the gradient of the sum of the ranks' losses: W times the global gradient
where the loss is the same on every rank (the dense losses' behaviour in
both packages).

``ProcessGroupAxis`` runs them over the default ``torch.distributed``
group. Production runs one process a GPU under NCCL, launched with the
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` that torchrun sets (``init_distributed``).
"""
from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from simhand_tpu_torch.data import prefetch
from simhand_tpu_torch.device import resolve_device

DATA_AXIS = "data"


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.rows = axis, x.shape[0]
        return axis.gather_raw(x)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.axis.index * ctx.rows
        return ctx.axis.reduce_raw(g.contiguous(), "sum")[lo:lo + ctx.rows], None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.reduce_raw(x, "sum")

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.reduce_raw(g.contiguous(), "sum"), None


class Axis:
    """A data-parallel axis: ``index`` of ``size`` ranks. Subclasses give
    the raw collectives (``gather_raw``, ``reduce_raw``, ``broadcast_raw``),
    which take no part in autograd; the methods here add JAX's transposes.
    An axis is shared, never copied: a deep copy of a model keeps its axis.
    """

    index: int
    size: int

    def __deepcopy__(self, memo):
        return self

    def gather_raw(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def reduce_raw(self, x: torch.Tensor, op: str) -> torch.Tensor:
        raise NotImplementedError

    def broadcast_raw(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        raise NotImplementedError

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' x concatenated on dim 0, in rank order."""
        return _AllGather.apply(x.contiguous(), self)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return _PSum.apply(x.contiguous(), self)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        return self.psum(x) / self.size

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return self.reduce_raw(x.detach().contiguous(), "min")

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self.reduce_raw(x.detach().contiguous(), "max")

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        return self.broadcast_raw(x.detach().contiguous(), src)

    def any_rank(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank, agreed on the host: the
        caller never waits for its device's queue."""
        return bool(self.reduce_raw(torch.tensor(float(flag)), "max"))


# how long a rank waits in a collective for the others before it fails
_TIMEOUT_S = 600.0
_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


class ProcessGroupAxis(Axis):
    """The axis over the default ``torch.distributed`` process group, with
    a gloo group beside it for host-side flags where the default group is
    NCCL (which takes only CUDA tensors)."""

    def __init__(self):
        if not dist.is_initialized():
            raise RuntimeError("no torch.distributed process group: call "
                               "init_distributed (or init_process_group) first")
        self.index, self.size = dist.get_rank(), dist.get_world_size()
        self._host = None if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")

    def gather_raw(self, x):
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)

    def reduce_raw(self, x, op):
        t = x.clone()
        dist.all_reduce(t, _OPS[op])
        return t

    def broadcast_raw(self, x, src=0):
        t = x.clone()
        dist.broadcast(t, src)
        return t

    def any_rank(self, flag):
        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.all_reduce(t, dist.ReduceOp.MAX, group=self._host)
        return bool(t)


def create_mesh() -> ProcessGroupAxis:
    """The data axis over the default process group."""
    return ProcessGroupAxis()


def init_distributed(device=None) -> torch.device:
    """Joins the process group that the torchrun-style environment names
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL on
    the card (``LOCAL_RANK`` picks it), gloo on the CPU. Returns the device
    of this rank."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]),
                            timeout=datetime.timedelta(seconds=_TIMEOUT_S))
    return dev


def shard_batch(axis: Axis, batch: dict) -> dict:
    """This rank's rows ``[r B/W, (r+1) B/W)`` of each array of a global
    batch: the row order of JAX's ``P("data")``."""
    out = {}
    for k, v in batch.items():
        rows = v.shape[0]
        if rows % axis.size:
            raise ValueError(f"{k}: {rows} rows do not split over {axis.size} ranks")
        n = rows // axis.size
        out[k] = v[axis.index * n:(axis.index + 1) * n]
    return out


@torch.no_grad()
def replicate(axis: Axis, state):
    """Rank 0's model (parameters and buffers) and optimizer moments on
    every rank, in place; returns the state."""
    tensors = [*state.model.parameters(), *state.model.buffers(),
               *state.optimizer.mu, *state.optimizer.nu, *(state.optimizer.acc or ())]
    for t in tensors:
        t.copy_(axis.broadcast(t))
    return state


def device_prefetch(iterator, axis: Axis | None, device=None, depth: int = 2):
    """``data.prefetch.device_prefetch`` of this rank's rows of each global
    batch (every batch whole without an axis)."""
    if axis is not None:
        iterator = (shard_batch(axis, {k: np.asarray(v) for k, v in b.items()})
                    for b in iterator)
    return prefetch.device_prefetch(iterator, device, depth)
