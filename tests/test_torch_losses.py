"""The port's geometry, weights, dense losses, median and equivariance
(``simhand_tpu_torch``) against the JAX package, float32 on the CPU.

Inputs are made from a seed with numpy and handed to both packages.
Unless a test says otherwise the tolerance is rtol 1e-5: both sides run
the same float32 arithmetic, and only the order of sums differs.
"""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simhand_tpu.core import geometry as jgeo
from simhand_tpu.losses import contrastive as jcon
from simhand_tpu.losses import supervised as jsup
from simhand_tpu.losses import weights as jw
from simhand_tpu.models import equivariance as jeq
from simhand_tpu_torch.core import geometry as tgeo
from simhand_tpu_torch.losses import contrastive as tcon
from simhand_tpu_torch.losses import supervised as tsup
from simhand_tpu_torch.losses import weights as tw
from simhand_tpu_torch.models import equivariance as teq

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
RTOL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, rtol=RTOL, atol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def normalize(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def joints():
    rng = np.random.default_rng(0)
    b = 12
    return (jnp.asarray(rng.uniform(0, 128, (b, 21, 2)), jnp.float32),
            jnp.asarray(rng.uniform(0, 128, (b, 21, 2)), jnp.float32))


def test_port_imports_neither_jax_nor_the_jax_package():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax|orbax|scripts|simhand_tpu(?!_torch))\b", re.M)
    files = sorted((REPO / "simhand_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    names = {str(f.relative_to(REPO)) for f in files}
    assert {f"simhand_tpu_torch/finetune/{m}.py" for m in (
        "maps", "image_stage", "datasets", "registry", "detnet", "detloss", "evaluation",
        "train", "evaluate", "mano", "aik", "shape_net", "lm_fit", "recon", "smoother",
        "optimize_shape", "train_shape_net", "create_data", "demo", "render")} | {"simhand_tpu_torch/models/heads.py",
                                 "simhand_tpu_torch/data/sources/freihand.py",
                                 "simhand_tpu_torch/experiments/evaluation.py",
                                 "simhand_tpu_torch/experiments/downstream.py",
                                 "simhand_tpu_torch/parallel/__init__.py",
                                 "simhand_tpu_torch/parallel/mesh.py",
                                 "simhand_tpu_torch/bn_grid.py",
                                 "simhand_tpu_torch/int8_quality.py",
                                 "simhand_tpu_torch/verify_release.py"} <= names
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    from simhand_tpu_torch import resolve_device
    from simhand_tpu_torch.models import ContrastiveModel
    from simhand_tpu_torch.train import OptimizerConfig, create_train_state

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_train_state(ContrastiveModel("18"), OptimizerConfig(), 0)


def test_geometry_matches():
    rng = np.random.default_rng(1)
    ang = rng.uniform(-180, 180, 7).astype(np.float32)
    cx, cy = rng.normal(size=7).astype(np.float32), rng.normal(size=7).astype(np.float32)
    pts = rng.normal(size=(7, 64, 2)).astype(np.float32)
    close(tgeo.rotation_matrix_2d(t(ang)), jgeo.rotation_matrix_2d(ang), atol=1e-7)
    mat_j = jgeo.opencv_rotation_matrix(cx, cy, ang)
    mat_t = tgeo.opencv_rotation_matrix(t(cx), t(cy), t(ang))
    close(mat_t, mat_j, atol=1e-6)
    close(tgeo.apply_affine_2d(t(pts), mat_t), jgeo.apply_affine_2d(pts, mat_j), atol=1e-6)


@pytest.mark.parametrize("diff_type", ["w_o_abs", "w_abs", "mpjpe"])
def test_distances_match(joints, diff_type):
    j1, j2 = joints
    close(tw._pair_distance(t(j1), t(j2), diff_type), jw._pair_distance(j1, j2, diff_type))
    close(tw._pairwise_matrix(t(j1), t(j2), diff_type),
          jw._pairwise_matrix(j1, j2, diff_type))


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("diff_type", ["w_o_abs", "w_abs", "mpjpe"])
def test_linear_and_nonlinear_weights_match(joints, diff_type, flat):
    j1, j2 = joints
    if flat:
        j1, j2 = jw.apply_pca(j1, 6), jw.apply_pca(j2, 6)
    # atol: a weight of exactly 0 (the max-distance pair) is 0 +- rounding
    close(tw.linear_weights(t(j1), t(j2), diff_type, flat=flat)[0],
          jw.linear_weights(j1, j2, diff_type, flat=flat)[0], atol=1e-6)
    close(tw.linear_weights(t(j1), t(j2), diff_type, flat=flat)[1],
          jw.linear_weights(j1, j2, diff_type, flat=flat)[1], atol=1e-6)
    # a sigmoid weight near 0 is exp(-lambda (d - mu)) with lambda (d - mu) up
    # to ~80 at pixel scale: its relative rounding is ~lambda d eps ~ 2e-5,
    # so weights (which lie in [0, 1]) are also held to atol 1e-7
    for got, want in zip(tw.nonlinear_weights(t(j1), t(j2), 5.0, 0.05, diff_type, flat=flat),
                         jw.nonlinear_weights(j1, j2, 5.0, 0.05, diff_type, flat=flat)):
        close(got, want, atol=1e-7)


def test_apply_pca_matches():
    # 64 samples of 42 coordinates: a full-rank second moment, so the top
    # 14 eigenvectors are unique up to the sign convention
    j1 = np.random.default_rng(7).uniform(0, 128, (64, 21, 2)).astype(np.float32)
    # two LAPACK eigensolvers in float32: the eigenvectors agree to ~1e-6 of
    # their norm, and the projections sum 42 products of |x| <= 128
    close(tw.apply_pca(t(j1), 14), jw.apply_pca(j1, 14), rtol=1e-4, atol=2e-3)


def test_pairwise_minmax_matches_in_chunks():
    rng = np.random.default_rng(2)
    j = jnp.asarray(rng.uniform(0, 128, (40, 21, 2)), jnp.float32)
    got = tw.pairwise_minmax(t(j), "mpjpe", chunk=16)
    want = jw.pairwise_minmax(j, "mpjpe", chunk=16)
    for g, w in zip(got, want):
        assert g.ndim == 0
        close(g, w)


@pytest.fixture(scope="module")
def zs():
    rng = np.random.default_rng(3)
    b = 16
    z1, z2 = normalize(rng.normal(size=(b, 128))), normalize(rng.normal(size=(b, 128)))
    pw = rng.uniform(0, 1, b).astype(np.float32)
    nw = rng.uniform(0, 1, (2 * b, 2 * b)).astype(np.float32)
    return z1, z2, pw, nw


def test_dense_losses_match(zs):
    z1, z2, pw, nw = zs
    tz1, tz2 = t(z1), t(z2)
    close(tcon.nt_xent(tz1, tz2, 0.5), jcon.nt_xent(z1, z2, 0.5))
    close(tcon.weighted_nt_xent(tz1, tz2, t(pw), t(nw)), jcon.weighted_nt_xent(z1, z2, pw, nw))
    close(tcon.pos_weighted_nt_xent(tz1, tz2, t(pw)), jcon.pos_weighted_nt_xent(z1, z2, pw))
    close(tcon.neg_weighted_nt_xent(tz1, tz2, t(nw)), jcon.neg_weighted_nt_xent(z1, z2, nw))


def test_dense_loss_gradients_match(zs):
    z1, z2, pw, nw = zs
    tz1, tz2 = t(z1).requires_grad_(), t(z2).requires_grad_()
    got = torch.autograd.grad(tcon.weighted_nt_xent(tz1, tz2, t(pw), t(nw)), (tz1, tz2))
    want = jax.grad(lambda a, b: jcon.weighted_nt_xent(a, b, pw, nw), argnums=(0, 1))(z1, z2)
    for g, w in zip(got, want):
        close(g, w, rtol=1e-4, atol=1e-7)  # a gradient sums 2B terms of both signs


def test_torch_median_is_the_lower_middle():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(5, 64, 2)).astype(np.float32)
    close(tsup.torch_median(t(x), dim=1), jsup.torch_median(x, axis=1), rtol=0)
    close(tsup.torch_median(t(x)), jsup.torch_median(x), rtol=0)


def _views(rng, b):
    return (rng.uniform(-10, 0, 2 * b).astype(np.float32),
            rng.uniform(-10, 0, 2 * b).astype(np.float32),
            rng.uniform(-45, 45, 2 * b).astype(np.float32))


@pytest.mark.parametrize("parts", ["none", "crop", "rotate", "both"])
def test_inverse_transform_matches_with_gradients(parts):
    rng = np.random.default_rng(5)
    b = 6
    proj = rng.normal(size=(2 * b, 128)).astype(np.float32)
    jx, jy, ang = _views(rng, b)
    cot = rng.normal(size=(2, b, 128)).astype(np.float32)
    crop, rot = parts in ("crop", "both"), parts in ("rotate", "both")

    def jfn(p):
        z1, z2 = jeq.inverse_transform_projections(
            p, jx if crop else None, jy if crop else None, ang if rot else None, 128.0)
        return jnp.sum(z1 * cot[0]) + jnp.sum(z2 * cot[1]), (z1, z2)

    (_, (wz1, wz2)), wgrad = jax.value_and_grad(jfn, has_aux=True)(proj)
    tp = t(proj).requires_grad_()
    z1, z2 = teq.inverse_transform_projections(
        tp, t(jx) if crop else None, t(jy) if crop else None, t(ang) if rot else None, 128.0)
    close(z1, wz1, atol=1e-6)
    close(z2, wz2, atol=1e-6)
    (tgrad,) = torch.autograd.grad((z1 * t(cot[0])).sum() + (z2 * t(cot[1])).sum(), tp)
    close(tgrad, wgrad, rtol=1e-4, atol=1e-6)


def test_l2_normalize_gradient_at_zero_matches():
    """The clamp sits inside the sqrt: at an exactly-zero vector the
    gradient is finite and the same in both packages."""
    rng = np.random.default_rng(6)
    x = np.zeros((3, 128), np.float32)
    x[1] = rng.normal(size=128)
    cot = rng.normal(size=(3, 128)).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(jeq._l2_normalize(a) * cot))(x)
    tx = t(x).requires_grad_()
    (got,) = torch.autograd.grad((teq._l2_normalize(tx) * t(cot)).sum(), tx)
    assert torch.isfinite(got).all()
    close(got, want)
    close(teq._l2_normalize(t(x)), jeq._l2_normalize(x))
