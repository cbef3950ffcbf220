"""The port's deeper ResNets against the JAX package on the CPU: ResNet-152
(BASELINE.json's largest configuration) in eval mode in float32 and in
train mode in float64, with the JAX model's variables carried over by
``convert.from_flax_variables`` (``strict=True``) at 32x32, B = 4, and the
152 encoder's keys against torchvision's ``resnet152`` names.

The variables are drawn with numpy over the port's shapes and carried into
the JAX model's tree (tracing the JAX init alone takes seconds for a
ResNet-152; jit-compiling it ~20 s).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simhand_tpu.models import ContrastiveModel as JModel
from simhand_tpu.train.torch_port import torch_state_dict_to_encoder
from simhand_tpu_torch.convert import from_flax_variables
from simhand_tpu_torch.models import ContrastiveModel as TModel

torch.set_num_threads(2)
SIDE, B = 32, 4
# XLA's CPU backend at its first optimisation level: a ResNet-152 compiles
# in about two thirds of the time, and runs as fast at this size
XLA_QUICK = {"xla_backend_optimization_level": 1}


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def max_rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(got.detach().double().numpy() - want).max() / np.abs(want).max())


def ported(variables, size: str, dtype=torch.float32) -> TModel:
    model = TModel(size, dtype=dtype)
    model.load_state_dict(from_flax_variables(to_numpy(variables["params"]),
                                              to_numpy(variables["batch_stats"])), strict=True)
    return model.to(dtype)


def images(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(B, SIDE, SIDE, 3)).astype(np.float32)


def random_variables(size: str, seed: int) -> dict:
    """Variables of the JAX ``ContrastiveModel(resnet_size=size)`` drawn with
    numpy over the port's state dict (its shapes, built on the meta device)
    and carried into flax's tree by ``torch_state_dict_to_encoder``:
    lecun-normal kernels, BatchNorm scales and biases, running means and
    variances away from the init's 1 / 0 / 0 / 1 (no trace of the JAX init:
    seconds for a ResNet-152)."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = TModel(size).state_dict()
    sd = {}
    for key, t in shapes.items():
        leaf, shape = key.rsplit(".", 1)[1], tuple(t.shape)
        if leaf == "num_batches_tracked":
            continue
        if leaf == "weight" and len(shape) > 1:
            v = rng.normal(size=shape) / np.sqrt(np.prod(shape[1:]))
        elif leaf == "weight":
            v = 1 + 0.1 * rng.normal(size=shape)
        elif leaf in ("bias", "running_mean"):
            v = 0.1 * rng.normal(size=shape)
        elif leaf == "running_var":
            v = 0.5 + rng.random(shape)
        else:
            raise ValueError(key)
        sd[key] = v.astype(np.float32)
    params, batch_stats = torch_state_dict_to_encoder(sd)
    return {"params": params, "batch_stats": batch_stats}


@pytest.fixture(scope="module")
def rn152():
    return JModel(resnet_size="152"), random_variables("152", 0)


def test_resnet152_keys_are_torchvisions(rn152):
    """torchvision's resnet152 key table (its definition order), the
    classifier left out: stages of (3, 8, 36, 3) bottlenecks, layer3.0 ...
    layer3.35, a downsample on each stage's first block."""
    want = ["conv1.weight"] + [f"bn1.{leaf}" for leaf in
                               ("weight", "bias", "running_mean", "running_var",
                                "num_batches_tracked")]
    for stage, n in enumerate((3, 8, 36, 3), start=1):
        for b in range(n):
            for i in (1, 2, 3):
                want.append(f"layer{stage}.{b}.conv{i}.weight")
                want += [f"layer{stage}.{b}.bn{i}.{leaf}" for leaf in
                         ("weight", "bias", "running_mean", "running_var",
                          "num_batches_tracked")]
            if b == 0:
                want.append(f"layer{stage}.0.downsample.0.weight")
                want += [f"layer{stage}.0.downsample.1.{leaf}" for leaf in
                         ("weight", "bias", "running_mean", "running_var",
                          "num_batches_tracked")]
    sd = TModel("152").encoder.state_dict()
    assert list(sd) == want
    assert tuple(sd["layer3.35.conv2.weight"].shape) == (256, 256, 3, 3)
    assert tuple(sd["layer4.0.downsample.0.weight"].shape) == (2048, 1024, 1, 1)
    # the weights carried from JAX fill every key
    _, variables = rn152
    carried = from_flax_variables(variables["params"]["encoder"],
                                  variables["batch_stats"]["encoder"])
    assert sorted(carried) == sorted(sd)


def test_resnet152_eval_forward_matches(rn152):
    """Eval mode in float32: a fixed affine map per layer, only the order of
    the convolutions' sums differs (ResNet-50's limit in test_torch_models.py,
    2e-3 of the largest output)."""
    jm, variables = rn152
    x = images()
    emb, proj = jax.jit(lambda v, x: jm.apply(v, x, train=False),
                        compiler_options=XLA_QUICK)(variables, jnp.asarray(x))
    with torch.no_grad():
        temb, tproj = ported(variables, "152").eval()(torch.from_numpy(x))
    assert temb.shape == (B, 2048) and tproj.shape == (B, 128)
    assert max_rel(temb, emb) < 2e-3
    assert max_rel(tproj, proj) < 2e-3


def test_resnet152_train_mode_matches_exactly_in_float64(rn152):
    """Train mode in float64, 155 BatchNorms over B = 4 at 32x32 (layer4
    normalises 4 values a channel): the outputs within 1e-6 of the largest
    (both cast to float32 at the end) and every running statistic within
    rel 1e-5, as test_torch_models.py holds ResNet-50."""
    _, variables = rn152
    x = images(1)
    with jax.enable_x64(True):
        jm = JModel(resnet_size="152", dtype=jnp.float64)
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        (emb, proj), mutated = jax.jit(
            lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]),
            compiler_options=XLA_QUICK)(
                v64, jnp.asarray(x, jnp.float64))
        mutated = to_numpy(mutated["batch_stats"])
    model = ported(variables, "152", torch.float64).train()
    with torch.no_grad():
        temb, tproj = model(torch.from_numpy(x).double())
    assert max_rel(temb, emb) < 1e-6
    assert max_rel(tproj, proj) < 1e-6
    got = model.state_dict()
    want = from_flax_variables(variables["params"], mutated)
    running = [k for k in want if "running" in k]
    assert len(running) == 2 * 156     # 155 encoder BatchNorms and the head's
    for key in running:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-5,
                                   atol=1e-12, err_msg=key)
