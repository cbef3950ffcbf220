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
  * ``psum_scatter(x)`` (the ranks' sum of x, split on dim 0 in rank
    order, this rank's part kept) has ``all_gather`` as its backward;
  * ``ppermute(x)`` sends x to rank ``(index + 1) % size`` and returns what
    rank ``index - 1`` sent; its backward is the inverse permutation;
  * ``pmin``, ``pmax`` and ``broadcast`` carry no gradient.

So a rank's backward through a loss that every rank computes whole gives
the gradient of the sum of the ranks' losses: W times the global gradient
where the loss is the same on every rank (the dense losses' behaviour in
both packages).

``ProcessGroupAxis`` runs them over a ``torch.distributed`` group: the
default one, or a sub-axis of it (``create_hybrid_mesh``). Production runs
one process a GPU under NCCL, launched with the ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` that torchrun sets
(``init_distributed``). Under gloo, the point-to-point exchange of a CUDA
tensor (``ppermute``) goes through the host: the axis copies it to the
CPU, sends and receives there, copies the result back and records it in
``staged``. Gloo's send of a CUDA tensor fails in torch 2.11 ("Bad
address"); it takes CUDA tensors for the collectives.
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


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.scatter_raw(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.gather_raw(g.contiguous()), None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, shift):
        ctx.axis, ctx.shift = axis, shift
        return axis.permute_raw(x, shift)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.permute_raw(g.contiguous(), -ctx.shift), None, None


class Axis:
    """A data-parallel axis: ``index`` of ``size`` ranks. Subclasses give
    the raw collectives (``gather_raw``, ``reduce_raw``, ``broadcast_raw``,
    ``scatter_raw``, ``permute_raw``), which take no part in autograd; the
    methods here add JAX's transposes.
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

    def scatter_raw(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' sum of x (size * m rows), this rank's rows
        ``[index m, (index + 1) m)``."""
        raise NotImplementedError

    def permute_raw(self, x: torch.Tensor, shift: int = 1) -> torch.Tensor:
        """x sent to rank ``(index + shift) % size``; returns what rank
        ``(index - shift) % size`` sent."""
        raise NotImplementedError

    def split(self, groups: list) -> "Axis":
        """The sub-axis of this rank, ``groups`` being every sub-axis's
        members (indices of this axis, in the sub-axis's order); every rank
        passes the same ``groups``."""
        raise NotImplementedError

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' x concatenated on dim 0, in rank order."""
        return _AllGather.apply(x.contiguous(), self)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return _PSum.apply(x.contiguous(), self)

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        return self.psum(x) / self.size

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """JAX's ``psum_scatter(x, tiled=True)`` on dim 0."""
        return _PSumScatter.apply(x.contiguous(), self)

    def ppermute(self, x: torch.Tensor) -> torch.Tensor:
        """JAX's ``ppermute`` with the ring ``[(i, (i + 1) % size)]``."""
        return _PPermute.apply(x.contiguous(), self, 1)

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
    """The axis over a ``torch.distributed`` group (the default one when
    ``group`` is None; ``ranks`` are its members' global ranks in the
    group's order), with a gloo group beside the default one for host-side
    flags where that is NCCL (which takes only CUDA tensors).
    ``staged`` names the collectives this axis has run through the host."""

    def __init__(self, group=None, ranks=None):
        if not dist.is_initialized():
            raise RuntimeError("no torch.distributed process group: call "
                               "init_distributed (or init_process_group) first")
        self.group = group
        self.index, self.size = dist.get_rank(group), dist.get_world_size(group)
        self.ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
        self._gloo = dist.get_backend(group) == "gloo"
        self._host = None if group is not None or self._gloo else dist.new_group(backend="gloo")
        self.staged = set()

    def gather_raw(self, x):
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts)

    def reduce_raw(self, x, op):
        t = x.clone()
        dist.all_reduce(t, _OPS[op], group=self.group)
        return t

    def broadcast_raw(self, x, src=0):
        t = x.clone()
        dist.broadcast(t, self.ranks[src], group=self.group)
        return t

    def scatter_raw(self, x):
        if self.size == 1:
            return x.clone()
        out = x.new_empty((x.shape[0] // self.size, *x.shape[1:]))
        dist.reduce_scatter_tensor(out, x.contiguous(), group=self.group)
        return out

    def permute_raw(self, x, shift=1):
        # an NCCL send to this rank itself inside one group deadlocks
        if self.size == 1 or shift % self.size == 0:
            return x.clone()
        staged = self._gloo and x.is_cuda
        if staged:
            self.staged.add("ppermute")
        t = x.cpu() if staged else x.contiguous()
        out = torch.empty_like(t)
        dst = self.ranks[(self.index + shift) % self.size]
        src = self.ranks[(self.index - shift) % self.size]
        ops = [dist.P2POp(dist.isend, t, dst, self.group),
               dist.P2POp(dist.irecv, out, src, self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out.to(x.device) if staged else out

    def split(self, groups):
        for members in groups:
            # every rank creates every group, in the same order
            ranks = [self.ranks[i] for i in members]
            group = dist.new_group(ranks)
            if self.index in members:
                mine = ProcessGroupAxis(group, ranks)
        return mine

    def barrier(self, timeout_s: float) -> None:
        """Waits until every rank is here; fails after ``timeout_s`` (over
        gloo, the host group beside NCCL)."""
        dist.monitored_barrier(self._host if self._host is not None else self.group,
                               timeout=datetime.timedelta(seconds=timeout_s))

    def any_rank(self, flag):
        if self.group is not None:
            return super().any_rank(flag)
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
    opt = state.optimizer
    tensors = [*state.model.parameters(), *state.model.buffers(),
               *opt.mu, *opt.nu, *(getattr(opt, "acc", None) or ())]
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
