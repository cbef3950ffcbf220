"""The loss dispatch (``contrastive_loss_from_projections``) of every
experiment type against the JAX package's, on one device and over a data
axis of two ranks (JAX's ``shard_map`` on 2 of ``tests/conftest.py``'s 8
devices; the port's ranks are threads over ``ThreadAxis``), float32 on the
CPU at B = 16 pairs, with and without crop and rotate.

Each rank's projections are [view1 rows; view2 rows] of its own pairs, as
the step's encoder gives them. The weighted types take their default
linear mpjpe pos_neg weights over the global batch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from simhand_tpu.models.contrastive import ContrastiveConfig as JConfig
from simhand_tpu.models.contrastive import EXPERIMENT_TYPES
from simhand_tpu.models.contrastive import contrastive_loss_from_projections as jloss
from simhand_tpu_torch.models import ContrastiveConfig as TConfig
from simhand_tpu_torch.models import contrastive_loss_from_projections as tloss
from simhand_tpu_torch.parallel import shard_batch
from torch_thread_axis import run_ranks

torch.set_num_threads(2)
B, W = 16, 2
MESH = Mesh(np.array(jax.devices()[:W]), ("data",))


def inputs():
    rng = np.random.default_rng(17)
    batch = {
        "jitter_x_1": rng.uniform(-10, 0, B), "jitter_x_2": rng.uniform(-10, 0, B),
        "jitter_y_1": rng.uniform(-10, 0, B), "jitter_y_2": rng.uniform(-10, 0, B),
        "angle_1": rng.uniform(-45, 45, B), "angle_2": rng.uniform(-45, 45, B),
        "joints1_aug": rng.uniform(0, 128, (B, 21, 3)),
        "joints2_aug": rng.uniform(0, 128, (B, 21, 3)),
    }
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    return rng.normal(size=(B, 128)).astype(np.float32), \
        rng.normal(size=(B, 128)).astype(np.float32), batch


@pytest.mark.parametrize("ranks", [1, W], ids=["one-device", "two-ranks"])
@pytest.mark.parametrize("augmentation", [(), ("crop", "rotate", "resize")],
                         ids=["plain-views", "crop-rotate"])
@pytest.mark.parametrize("experiment_type", EXPERIMENT_TYPES)
def test_loss_dispatch_matches_jax(experiment_type, augmentation, ranks):
    """The loss within rel 1e-5 (a scratch run of this grid on one device
    measured <= 2.8e-7), on every rank."""
    p1, p2, batch = inputs()
    kw = dict(experiment_type=experiment_type, augmentation=augmentation)
    if ranks == 1:
        want = float(jloss(jnp.concatenate([p1, p2]), batch, JConfig(**kw))[0])
        got = [float(tloss(torch.from_numpy(np.concatenate([p1, p2])),
                           {k: torch.from_numpy(v) for k, v in batch.items()},
                           TConfig(**kw))[0])]
    else:
        def device(a, b, bt):
            return jloss(jnp.concatenate([a, b]), bt, JConfig(**kw), "data")[0]

        want = float(jax.jit(shard_map(device, mesh=MESH, in_specs=(P("data"),) * 3,
                                       out_specs=P(), check_vma=False))(p1, p2, batch))

        def rank(axis):
            local = shard_batch(axis, {"p1": p1, "p2": p2, **batch})
            proj = torch.from_numpy(np.concatenate([local.pop("p1"), local.pop("p2")]))
            return float(tloss(proj, {k: torch.from_numpy(v) for k, v in local.items()},
                               TConfig(**kw), axis)[0])

        got = run_ranks(W, rank)
    assert got == pytest.approx([want] * ranks, rel=1e-5)
