"""The port's last encoder options against the JAX package on the CPU: the
space-to-depth stem (``space_to_depth``, ``s2d_stem_kernel``, the
``conv1_s2d`` ResNet with its weights carried over by ``convert``),
``remat`` (``torch.utils.checkpoint`` against flax's ``nn.remat``, with the
BatchNorm running statistics updated once a step), and the refusals of
the cross-replica slice.

Inputs are made from a seed with numpy; float32 unless a test says
otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simhand_tpu.models import ContrastiveModel as JModel
from simhand_tpu.models.resnet import s2d_stem_kernel as j_s2d_kernel
from simhand_tpu.models.resnet import space_to_depth as j_space_to_depth
from simhand_tpu_torch.convert import from_flax_variables
from simhand_tpu_torch.experiments import main as main_mod
from simhand_tpu_torch.models import ContrastiveModel as TModel
from simhand_tpu_torch.models.fused_bn import FusedBatchNorm
from simhand_tpu_torch.models.layers import Conv2d
from simhand_tpu_torch.models.resnet import s2d_stem_kernel, space_to_depth
from torch_thread_axis import ThreadAxis, ThreadGroup

torch.set_num_threads(2)
SIDE, B = 32, 4


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def max_rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(got.detach().double().numpy() - want).max() / np.abs(want).max())


def test_space_to_depth_and_stem_kernel_match_jax():
    """Both rearrangements equal JAX's bit for bit, and the s2d stem with
    s2d_stem_kernel's weights is the conv7 stem (float64, to 1e-12 of its
    largest output)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 12, 3)).astype(np.float32)
    assert np.array_equal(space_to_depth(torch.from_numpy(x), 2).numpy(),
                          np.asarray(j_space_to_depth(jnp.asarray(x), 2)))
    w7 = rng.normal(size=(7, 7, 3, 64)).astype(np.float32)          # flax (kH, kW, I, O)
    want = np.asarray(j_s2d_kernel(jnp.asarray(w7))).transpose(3, 2, 0, 1)
    got = s2d_stem_kernel(torch.from_numpy(w7.transpose(3, 2, 0, 1).copy()))
    assert got.shape == (64, 12, 4, 4) and np.array_equal(got.numpy(), want)

    x64, w64 = torch.from_numpy(x).double(), torch.from_numpy(w7.transpose(3, 2, 0, 1)).double()
    conv7 = torch.nn.functional.conv2d(x64.permute(0, 3, 1, 2), w64, stride=2, padding=3)
    stem = Conv2d(12, 64, 4, 1, padding=((2, 1), (2, 1)), dtype=torch.float64)
    with torch.no_grad():
        stem.weight.copy_(s2d_stem_kernel(w64))
    with torch.no_grad():
        s2d = stem(space_to_depth(x64, 2).permute(0, 3, 1, 2))
    assert s2d.shape == conv7.shape
    assert float((s2d - conv7).abs().max() / conv7.abs().max()) < 1e-12


@pytest.fixture(scope="module")
def s2d_rn18():
    jm = JModel(resnet_size="18", stem="space_to_depth")
    variables = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((2, SIDE, SIDE, 3)))
    x = np.random.default_rng(1).normal(size=(B, SIDE, SIDE, 3)).astype(np.float32)
    return jm, variables, x


def test_s2d_resnet_matches_jax(s2d_rn18):
    """ResNet-18 with the s2d stem: the converted variables load with
    strict=True (``encoder.conv1_s2d.weight``, no ``conv1``); train-mode
    embeddings, projections and running statistics and eval-mode outputs
    within tests/test_torch_models.py's ResNet-18 limit (5e-4 of the
    largest)."""
    jm, variables, x = s2d_rn18
    model = TModel("18", stem="space_to_depth")
    sd = from_flax_variables(to_numpy(variables["params"]), to_numpy(variables["batch_stats"]))
    assert "encoder.conv1_s2d.weight" in sd and "encoder.conv1.weight" not in sd
    model.load_state_dict(sd, strict=True)
    (emb, proj), mutated = jm.apply(variables, jnp.asarray(x), train=True,
                                    mutable=["batch_stats"])
    temb, tproj = model.train()(torch.from_numpy(x))
    assert max_rel(temb, emb) < 5e-4 and max_rel(tproj, proj) < 5e-4
    want = from_flax_variables(to_numpy(variables["params"]), to_numpy(mutated["batch_stats"]))
    for key, w in want.items():
        if "running" in key:
            assert max_rel(model.state_dict()[key], w.numpy()) < 5e-4, key
    emb, proj = jm.apply(variables, jnp.asarray(x), train=False)
    model.load_state_dict(sd, strict=True)
    temb, tproj = model.eval()(torch.from_numpy(x))
    assert max_rel(temb, emb) < 5e-4 and max_rel(tproj, proj) < 5e-4


def test_remat_matches_jax_remat_and_updates_statistics_once():
    """ContrastiveModel(remat=True) at ResNet-18 against JAX's remat model:
    the projections and every parameter gradient of the loss sum(proj * g)
    within 5e-4 of their largest (tests/test_torch_models.py's train-mode
    limit; measured 3.6e-4), but projection_head.fc1.bias's, which feeds a
    train-mode BatchNorm and is 0 up to rounding. Against the port without remat: the loss, the gradients and
    the running statistics bit for bit, the statistics moved once (the
    recomputation in the backward updates nothing)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, SIDE, SIDE, 3)).astype(np.float32)
    g = rng.normal(size=(B, 128)).astype(np.float32)
    jm = JModel(resnet_size="18", remat=True)
    variables = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((2, SIDE, SIDE, 3)))

    def jloss(params):
        (_, proj), _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(proj * g), proj

    (_, want_proj), want_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    want_grads = from_flax_variables(to_numpy(want_grads), to_numpy(variables["batch_stats"]))
    sd = from_flax_variables(to_numpy(variables["params"]), to_numpy(variables["batch_stats"]))

    runs = {}
    for remat in (True, False):
        model = TModel("18", remat=remat)
        model.load_state_dict(sd, strict=True)
        proj = model.train()(torch.from_numpy(x))[1]
        loss = (proj * torch.from_numpy(g)).sum()
        names = [n for n, _ in model.named_parameters()]
        grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
        runs[remat] = proj.detach(), grads, model.state_dict()
    proj, grads, state = runs[True]
    assert max_rel(proj, want_proj) < 5e-4
    errs = {n: max_rel(grad, want_grads[n].numpy()) for n, grad in grads.items()
            if n != "projection_head.fc1.bias"}
    assert max(errs.values()) < 5e-4, errs
    plain_proj, plain_grads, plain_state = runs[False]
    assert torch.equal(proj, plain_proj)
    assert all(torch.equal(grads[n], plain_grads[n]) for n in grads)
    moved = [k for k in state if "running" in k and not torch.equal(state[k], sd[k])]
    assert moved and all(torch.equal(state[k], plain_state[k]) for k in state)


def test_cross_replica_refusals(monkeypatch, tmp_path):
    """FusedBatchNorm with an axis (the reference asserts, fused_bn.py:114),
    bn_fused="epilogue"/"epilogue_xla" and "pallas"/True with a BatchNorm
    axis (resnet.py:173-183), and main's --fsdp with WORLD_SIZE > 1 (not
    ported yet; before any process group is joined) each raise
    NotImplementedError naming the reason."""
    axis = ThreadAxis(ThreadGroup(1), 0)
    with pytest.raises(NotImplementedError, match="per-replica only"):
        FusedBatchNorm(8, axis=axis)
    for bn_fused in ("epilogue", "epilogue_xla"):
        with pytest.raises(NotImplementedError, match="no cross-replica statistics"):
            TModel("18", bn_fused=bn_fused, bn_axis=axis)
    for bn_fused in (True, "pallas"):
        with pytest.raises(NotImplementedError, match="per-replica only"):
            TModel("18", bn_fused=bn_fused, bn_axis=axis)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="--fsdp with WORLD_SIZE > 1"):
        main_mod.main(["--fsdp", "--data_dir", str(tmp_path), "--device", "cpu"])
