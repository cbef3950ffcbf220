"""The port's ResNet, projection head and ContrastiveModel
(``simhand_tpu_torch.models``) against the JAX package on the CPU, with the
weights carried over by ``simhand_tpu_torch.convert``.

Inputs are made from a seed with numpy. Each comparison runs in float32;
where train-mode BatchNorm makes float32 ill-conditioned, the same
comparison also runs in float64, where the two packages must agree to
rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simhand_tpu.models import ContrastiveModel as JModel
from simhand_tpu.models.contrastive import projection_stats as jstats
from simhand_tpu_torch.convert import from_flax_variables
from simhand_tpu_torch.models import ContrastiveModel as TModel
from simhand_tpu_torch.models import projection_stats as tstats
from simhand_tpu_torch.models.layers import same_pads
from test_torch_contract import torchvision_resnet50_contract

torch.set_num_threads(2)
SIDE, B = 32, 4


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def ported(jmodel_vars, size, dtype=torch.float32):
    model = TModel(size, dtype=dtype)
    model.load_state_dict(from_flax_variables(to_numpy(jmodel_vars["params"]),
                                              to_numpy(jmodel_vars["batch_stats"])),
                          strict=True)
    return model.to(dtype)


def max_rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(got.detach().double().numpy() - want).max() / np.abs(want).max())


@pytest.fixture(scope="module", params=["18", "50"])
def setup(request):
    size = request.param
    jm = JModel(resnet_size=size)
    variables = jm.init(jax.random.key(0), jnp.zeros((2, SIDE, SIDE, 3)))
    x = np.random.default_rng(0).normal(size=(B, SIDE, SIDE, 3)).astype(np.float32)
    return size, jm, variables, x


# float32 train-mode tolerances, relative to the largest output. Train-mode
# BatchNorm at B = 4 and 32x32 normalises layer4 over 4 values per channel;
# it divides rounding differences of XLA's and oneDNN's convolutions by a
# tiny spread, layer after layer (measured: 3e-5 for ResNet-18, 8e-3 for
# the 53 BatchNorms of ResNet-50). The float64 test below holds the
# semantics exactly.
TRAIN_RTOL = {"18": 5e-4, "50": 3e-2}


def test_train_mode_outputs_and_running_stats_match(setup):
    size, jm, variables, x = setup
    (emb, proj), mutated = jm.apply(variables, jnp.asarray(x), train=True,
                                    mutable=["batch_stats"])
    model = ported(variables, size).train()
    temb, tproj = model(torch.from_numpy(x))
    assert temb.dtype == tproj.dtype == torch.float32
    assert max_rel(temb, emb) < TRAIN_RTOL[size]
    assert max_rel(tproj, proj) < TRAIN_RTOL[size]
    want = from_flax_variables(to_numpy(variables["params"]),
                               to_numpy(mutated["batch_stats"]))
    got = model.state_dict()
    for key in want:
        if "running" in key:
            assert max_rel(got[key], want[key].numpy()) < TRAIN_RTOL[size], key


def test_train_mode_matches_exactly_in_float64(setup):
    """Same semantics to rounding: SAME padding of the stride-2 convs, the
    biased running variance, momentum 0.9, float32 output of both heads."""
    size, _, variables, x = setup
    with jax.enable_x64(True):
        jm = JModel(resnet_size=size, dtype=jnp.float64)
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        (emb, proj), mutated = jm.apply(v64, jnp.asarray(x, jnp.float64), train=True,
                                        mutable=["batch_stats"])
        mutated = to_numpy(mutated["batch_stats"])
    model = ported(variables, size, torch.float64).train()
    temb, tproj = model(torch.from_numpy(x).double())
    assert max_rel(temb, emb) < 1e-6     # both cast to float32 at the end
    assert max_rel(tproj, proj) < 1e-6
    got = model.state_dict()
    for key, want in from_flax_variables(to_numpy(variables["params"]), mutated).items():
        if "running" in key:
            np.testing.assert_allclose(got[key].numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-12, err_msg=key)


def test_eval_mode_outputs_match(setup):
    size, jm, variables, x = setup
    # give the running statistics non-trivial values first
    _, mutated = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": mutated["batch_stats"]}
    emb, proj = jm.apply(variables, jnp.asarray(x), train=False)
    temb, tproj = ported(variables, size).eval()(torch.from_numpy(x))
    # a fixed affine map per layer: only the order of the convolutions' sums
    # differs (measured <= 3e-4 of the largest output for ResNet-50)
    assert max_rel(temb, emb) < 2e-3
    assert max_rel(tproj, proj) < 2e-3


def test_encoder_keys_are_torchvisions():
    want = {k: v for k, v in torchvision_resnet50_contract().items()
            if not k.startswith("fc.")}
    sd = TModel("50").encoder.state_dict()
    assert list(sd) == list(want)
    assert {k: tuple(v.shape) for k, v in sd.items()} == want


def test_feature_map_mode_matches():
    """pool=False returns the float32 (N, H/32, W/32, C) map (the detnet
    backbone mode), in eval mode; tolerance as in the eval test above."""
    from simhand_tpu.models.resnet import resnet18 as jresnet18
    from simhand_tpu_torch.models.resnet import resnet18 as tresnet18

    x = np.random.default_rng(2).normal(size=(2, 64, 64, 3)).astype(np.float32)
    jm = jresnet18(pool=False)
    variables = jm.init(jax.random.key(1), jnp.asarray(x))
    want = jm.apply(variables, jnp.asarray(x), train=False)
    model = tresnet18(pool=False)
    model.load_state_dict(from_flax_variables(to_numpy(variables["params"]),
                                              to_numpy(variables["batch_stats"])), strict=True)
    got = model.eval()(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 2, 2, 512) and got.dtype == torch.float32
    assert max_rel(got, want) < 2e-3


@pytest.mark.parametrize("size", range(5, 12))
def test_same_padding_is_xlas(size):
    for kernel, stride in ((3, 1), (3, 2), (1, 2), (7, 2)):
        want = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")[0]
        assert same_pads(size, kernel, stride) == tuple(want)


def test_projection_stats_match():
    proj = np.random.default_rng(1).normal(size=(10, 128)).astype(np.float32)
    want = jstats(jnp.asarray(proj))
    got = tstats(torch.from_numpy(proj))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(value), rtol=1e-5,
                                   atol=1e-7, err_msg=key)
