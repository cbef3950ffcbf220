"""FSDP (ZeRO-3) parameter and optimizer-state sharding (counterpart of
``simhand_tpu/parallel/fsdp.py``).

Each rank holds its 1/n piece of every large parameter and of its Adam
moments (and of the accumulation buffer, where there is one). A step
all-gathers the pieces into whole parameters for the forward and the
backward, reduce-scatters the gradients, and updates its pieces; between
steps the model's large parameters hold no storage.

Two layouts, as in the JAX package:

* 1-D: the batch and the state both split over every rank;
* hybrid ``(data, fsdp)`` (``create_hybrid_mesh``): the batch split over
  every rank, the state over the ``fsdp`` ranks of one replica group only.
  Rank ``r = d * n_fsdp + f`` (JAX's ``reshape(n_data, n_fsdp)``); the
  pieces are gathered over ``fsdp`` and the gradients reduce-scattered
  over ``fsdp`` and then summed over ``data``.

The step is JAX's single program ``_step_fn(axis_name=None)`` under GSPMD:
the encoder's and the projection head's BatchNorm statistics, the weight
statistics and the loss all see the global batch, and the gradient is the
single-device step's on the global batch (``tests/test_fsdp.py``). The
port gives every BatchNorm the world axis (``sync_batch_norms``) and takes
the loss over it; autograd through the axis's collectives then gives each
rank W times its rows' share of the global gradient on the dense route
and its share itself on the kernel route (``parallel/mesh.py``), so the
reduce-scattered sum is divided by W on the dense route only. Every
``bn_fused`` mode runs: its kernels (#5-#9) reduce this rank's rows and
their per-channel sums are all-reduced over the world, one collective a
site in the forward and one in the backward (``models/fused_bn.py``,
``models/bn_epilogue.py``). Device
augmentation draws for the global batch from ``(0, step)``, no rank in
the key, and each rank keeps its rows. At one rank there is no axis: the
step is the single-device step.

The leaf rule is JAX's ``leaf_partition_spec`` applied to the port's own
layouts (OIHW convolutions): a leaf under ``min_leaf_elements`` stays
whole, otherwise it is split over its largest dim that the shard count
divides; a leaf with no such dim stays whole. A piece is stored with that
dim first, so the collectives work on dim 0.

A hand-written ZeRO-3 over ``parallel.mesh``'s axes: ``torch.distributed.fsdp``
wraps a module in DTensors and needs a process group, where the CPU tests
hold this step against JAX's with the ranks as threads.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from simhand_tpu_torch.data.augment import apply_views, sample_augment, seeded_generator
from simhand_tpu_torch.models.contrastive import (
    _EQUIVARIANT,
    ContrastiveConfig,
    contrastive_loss_from_projections,
    kernel_route,
    projection_stats,
)
from simhand_tpu_torch.parallel.mesh import DATA_AXIS, Axis, ProcessGroupAxis, shard_batch
from simhand_tpu_torch.train.loop import _check_state, _images
from simhand_tpu_torch.train.optimizer import Optimizer, decay_mask
from simhand_tpu_torch.train.state import TrainState

FSDP_AXIS = "fsdp"
MIN_LEAF_ELEMENTS = 4096


@dataclasses.dataclass(frozen=True)
class FSDPMesh:
    """The axes of an FSDP layout: ``world`` (every rank: the batch, the
    BatchNorm statistics, the loss), ``fsdp`` (the ranks that together hold
    one copy of the state) and ``data`` (the replica groups; None on a 1-D
    mesh, where ``fsdp`` is ``world``)."""

    world: Axis
    fsdp: Axis
    data: Axis | None = None

    @property
    def shape(self) -> dict:
        if self.data is None:
            return {DATA_AXIS: self.world.size}
        return {DATA_AXIS: self.data.size, FSDP_AXIS: self.fsdp.size}


def as_mesh(axes) -> FSDPMesh:
    """An FSDPMesh, or the 1-D mesh of an axis."""
    return axes if isinstance(axes, FSDPMesh) else FSDPMesh(axes, axes)


def create_hybrid_mesh(n_data: int, n_fsdp: int, axis: Axis | None = None) -> FSDPMesh:
    """The ``(data, fsdp)`` mesh over ``axis`` (the default process group
    when None): batch over both, state over ``fsdp``."""
    world = ProcessGroupAxis() if axis is None else axis
    if world.size != n_data * n_fsdp:
        raise ValueError(f"a ({n_data}, {n_fsdp}) mesh over {world.size} ranks")
    fsdp = world.split([[d * n_fsdp + f for f in range(n_fsdp)] for d in range(n_data)])
    data = world.split([[d * n_fsdp + f for d in range(n_data)] for f in range(n_fsdp)])
    return FSDPMesh(world, fsdp, data)


def leaf_partition_spec(shape, n_shards: int,
                        min_leaf_elements: int = MIN_LEAF_ELEMENTS) -> int | None:
    """The dim one leaf is split over (None: held whole)."""
    if math.prod(shape) < min_leaf_elements:
        return None
    divisible = [i for i, s in enumerate(shape) if s > 0 and s % n_shards == 0]
    if not divisible:
        return None
    return max(divisible, key=lambda i: shape[i])


def fsdp_sharding(axes, state: TrainState,
                  min_leaf_elements: int = MIN_LEAF_ELEMENTS) -> list:
    """The split dim of each parameter of ``state`` (its moments follow it);
    one rank shards nothing."""
    n = as_mesh(axes).fsdp.size
    if n == 1:
        return [None] * len(state.params)
    return [leaf_partition_spec(tuple(p.shape), n, min_leaf_elements) for p in state.params]


def _piece(t: torch.Tensor, dim, axis: Axis) -> torch.Tensor:
    """This rank's piece of a whole tensor, its split dim first."""
    if dim is None:
        return t
    return t.detach().movedim(dim, 0).chunk(axis.size)[axis.index].clone()


@dataclasses.dataclass
class FSDPTrainState(TrainState):
    """A train state in the FSDP layout. ``shards`` are this rank's pieces of
    the parameters (the parameter itself where ``dims`` is None), which the
    optimizer updates; the model's split parameters hold no storage outside
    ``gathered``."""

    mesh: FSDPMesh = None
    dims: list = None
    shards: list = None

    @property
    def params(self) -> list[torch.Tensor]:
        return self.shards

    def _split_params(self):
        return [(p, d, s) for p, d, s in zip(self.model.parameters(), self.dims, self.shards)
                if d is not None]

    def gather_params(self) -> list[torch.Tensor]:
        """Every parameter whole, in one all-gather over ``fsdp``."""
        axis, split = self.mesh.fsdp, self._split_params()
        out = list(self.shards)
        if not split:
            return out
        flat = torch.cat([s.reshape(-1) for _, _, s in split])
        rows = axis.gather_raw(flat).view(axis.size, -1)
        start = 0
        for i, d in enumerate(self.dims):
            if d is None:
                continue
            s = self.shards[i]
            piece = rows[:, start:start + s.numel()]
            start += s.numel()
            out[i] = piece.reshape(axis.size * s.shape[0], *s.shape[1:]).movedim(0, d).contiguous()
        return out

    def release_params(self) -> None:
        for p, _, s in self._split_params():
            p.data = s.new_empty(0)

    @contextlib.contextmanager
    def gathered(self):
        """Inside, the model's parameters are whole (a collective on every
        rank of ``fsdp``)."""
        for p, whole in zip(self.model.parameters(), self.gather_params()):
            p.data = whole
        try:
            yield list(self.model.parameters())
        finally:
            self.release_params()

    def _whole(self, pieces: list) -> list:
        """Whole tensors of pieces laid out as the parameters' shards."""
        saved = self.shards
        try:
            self.shards = list(pieces)
            return self.gather_params()
        finally:
            self.shards = saved

    def payload(self) -> dict:
        names = [n for n, _ in self.model.named_parameters()]
        model = dict(self.model.state_dict())
        model.update(zip(names, (t.detach() for t in self.gather_params())))
        opt = self.optimizer.state_dict()
        for key in ("mu", "nu", "acc"):
            if opt[key] is not None:
                opt[key] = self._whole(opt[key])
        return {"model": model, "optimizer": opt}

    @torch.no_grad()
    def load_payload(self, saved: dict) -> None:
        names = [n for n, _ in self.model.named_parameters()]
        params = set(names)
        expected = set(self.model.state_dict())
        if set(saved["model"]) != expected:
            raise ValueError("the saved model's keys differ from this model's: "
                             f"{sorted(set(saved['model']) ^ expected)[:5]}")
        for name, d, s in zip(names, self.dims, self.shards):
            s.copy_(_piece(saved["model"][name], d, self.mesh.fsdp))
        buffers = dict(self.model.named_buffers())
        for k, v in saved["model"].items():
            if k not in params:
                buffers[k].copy_(v)
        opt = dict(saved["optimizer"])
        for key in ("mu", "nu", "acc"):
            if opt[key] is not None:
                opt[key] = [_piece(t, d, self.mesh.fsdp) for t, d in zip(opt[key], self.dims)]
        self.optimizer.load_state_dict(opt)


def shard_state(axes, state: TrainState) -> FSDPTrainState:
    """``state`` (the same whole state on every rank) in the FSDP layout:
    this rank keeps its piece of each large parameter and of its moments;
    the model's split parameters give up their storage."""
    mesh = as_mesh(axes)
    dims = fsdp_sharding(mesh, state)
    params = list(state.model.parameters())
    shards = [p if d is None else _piece(p, d, mesh.fsdp) for p, d in zip(params, dims)]
    old = state.optimizer
    opt = Optimizer(old.cfg, shards, decay_mask(state.model))
    opt.load_state_dict({**old.state_dict(),
                         **{k: None if v is None else [_piece(t, d, mesh.fsdp)
                                                       for t, d in zip(v, dims)]
                            for k, v in old.state_dict().items() if k in ("mu", "nu", "acc")}})
    if mesh.fsdp.size > 1:
        opt.shard_norms(mesh.fsdp, [d is not None for d in dims])
    out = FSDPTrainState(state.model, opt, state.step, mesh=mesh, dims=dims, shards=shards)
    out.release_params()
    return out


def gathered(state):
    """``state.gathered()`` for an FSDP state; nothing for a whole one."""
    return state.gathered() if isinstance(state, FSDPTrainState) else contextlib.nullcontext()


def state_bytes(state) -> int:
    """The bytes this rank holds of the state: parameters (or pieces),
    moments, accumulator and buffers."""
    opt = state.optimizer
    tensors = [*state.params, *opt.mu, *opt.nu, *(opt.acc or ()), *state.model.buffers()]
    return sum(t.numel() * t.element_size() for t in tensors)


def _global_views(batch: dict, augment, axis: Axis, step: int) -> dict:
    """This rank's rows of the global batch's views: the draws of the whole
    global batch from ``(0, step)``, of which this rank keeps its own."""
    flags, params, out_size = augment
    generator = seeded_generator(batch["image1"].device, 0, step)
    b = batch["image1"].shape[0]
    rows = slice(axis.index * b, (axis.index + 1) * b)
    # view 1's draws, then view 2's, from one generator (data.augment.sample_views)
    draws = [sample_augment(generator, b * axis.size, batch[f"image{v}"].shape[1], flags,
                            params, out_size) for v in (1, 2)]
    draws = [type(d)(*(None if f is None else f[rows] for f in d)) for d in draws]
    return apply_views(batch, draws, flags, params, out_size)


def _reduce_gradients(state: FSDPTrainState, grads, scale: float) -> list:
    """The gradients of this rank's pieces: the split ones reduce-scattered
    over ``fsdp`` and summed over ``data``, the whole ones summed over the
    world, each in one collective; then times ``scale``."""
    mesh, dims = state.mesh, state.dims
    n = mesh.fsdp.size
    out = [None] * len(grads)
    split = [i for i, d in enumerate(dims) if d is not None]
    whole = [i for i, d in enumerate(dims) if d is None]
    if split:
        flat = torch.cat([grads[i].movedim(dims[i], 0).reshape(n, -1) for i in split], dim=1)
        local = mesh.fsdp.scatter_raw(flat.reshape(-1))
        if mesh.data is not None:
            local = mesh.data.reduce_raw(local, "sum")
        start = 0
        for i in split:
            s = state.shards[i]
            out[i] = local[start:start + s.numel()].view(s.shape)
            start += s.numel()
    if whole:
        flat = torch.cat([grads[i].reshape(-1) for i in whole])
        if mesh.world.size > 1:
            flat = mesh.world.reduce_raw(flat, "sum")
        start = 0
        for i in whole:
            out[i] = flat[start:start + grads[i].numel()].view(grads[i].shape)
            start += grads[i].numel()
    if scale != 1.0:
        torch._foreach_mul_(out, scale)
    return out


def make_fsdp_train_step(model, cfg: ContrastiveConfig, axes, state: TrainState,
                         augment=None):
    """The pre-training step in the FSDP layout of ``axes`` (an axis: 1-D;
    an ``FSDPMesh``: hybrid). ``state`` is a freshly built whole state, the
    template of the layout. Returns ``(step, place_state, place_batch)``:
    ``step(state, batch) -> (state, metrics)`` on an FSDP state and this
    rank's rows of the global batch, ``place_state`` (a whole state -> the
    FSDP layout) and ``place_batch`` (a global host batch -> this rank's
    rows on the model's device). Every BatchNorm of ``model``, in every
    ``bn_fused`` mode, takes the world axis (``sync_batch_norms``)."""
    mesh = as_mesh(axes)
    batch_axis = mesh.world if mesh.world.size > 1 else None
    model.sync_batch_norms(batch_axis)
    layout = fsdp_sharding(mesh, state)
    device = next(model.parameters()).device

    def place_state(s: TrainState) -> FSDPTrainState:
        placed = shard_state(mesh, s)
        if placed.dims != layout:
            raise ValueError("the state does not have the template's parameters")
        return placed

    def place_batch(batch: dict) -> dict:
        rows = batch if batch_axis is None else shard_batch(batch_axis, batch)
        return {k: torch.as_tensor(v).to(device) for k, v in rows.items()}

    def step(state: FSDPTrainState, batch: dict):
        _check_state(state, model)
        if augment is not None:
            batch = _global_views(batch, augment, mesh.world, state.step)
        model.train()
        with state.gathered() as params:
            _, proj = model(_images(batch))
            loss, _ = contrastive_loss_from_projections(proj, batch, cfg, batch_axis)
            grads = torch.autograd.grad(loss, params)
        dense = batch_axis is not None and not kernel_route(cfg, proj.shape[0], batch_axis)
        grads = _reduce_gradients(state, grads, 1.0 / mesh.world.size if dense else 1.0)
        state.optimizer.step(state.shards, grads)
        state.step += 1
        metrics = {"contrastive_loss": loss.detach()}
        if cfg.experiment_type in _EQUIVARIANT:
            metrics.update(projection_stats(proj, batch_axis))
        return state, metrics

    return step, place_state, place_batch
