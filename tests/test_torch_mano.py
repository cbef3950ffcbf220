"""The port's MANO side (``simhand_tpu_torch.finetune``: mano, aik,
smoother, shape_net, lm_fit, recon, datasets' SIK1M, create_data,
train_shape_net, optimize_shape, and ``convert``'s ShapeNet readers)
against the JAX package on the CPU, on the synthetic MANO parameters of
``tests/test_mano.py`` (778 vertices, 16 joints, 10 shape and 135 pose
coefficients; the official pickle is not redistributable).

What is held: the MANO forward within 1e-5 of the largest output;
``shaped_joints`` and ``relative_bone_lengths`` within rel 1e-6; AIK, the
One-Euro filter, the bone helpers and SIK1M's samples bit for bit; ShapeNet
from converted params within 1e-6 of its largest output, ``sik_loss`` and its gradients
within rel 1e-5; PSO's beta within 1e-5 of JAX's; LM within 1e-4 while its
steps are accepted alike (past that its cost sits at float32's resolution,
see ``test_lm_matches_jax``); ``reconstruct`` within 1e-5 and ``recon_epe``
within rel 1e-5; three ``--data_root`` ShapeNet steps within rel 1e-4 of
an optax loop; the CLIs; the chumpy pickle loader; the flax msgpack reader.
"""
from __future__ import annotations

import importlib.util
import pathlib
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_mano  # noqa: E402  (the JAX tests' synthetic MANO)
from simhand_tpu.core.joints import JointMap
from simhand_tpu.finetune import aik as jaik
from simhand_tpu.finetune import lm_fit as jlm
from simhand_tpu.finetune import mano as jmano
from simhand_tpu.finetune import recon as jrecon
from simhand_tpu.finetune import shape_net as jsn
from simhand_tpu.finetune import smoother as jsmooth
from simhand_tpu_torch import convert
from simhand_tpu_torch.finetune import aik as paik
from simhand_tpu_torch.finetune import lm_fit as plm
from simhand_tpu_torch.finetune import mano as pmano
from simhand_tpu_torch.finetune import recon as precon
from simhand_tpu_torch.finetune import shape_net as psn
from simhand_tpu_torch.finetune import smoother as psmooth

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
JM = JointMap()
BUFFERS = ("v_template", "shapedirs", "posedirs", "J_regressor", "weights")


def synthetic_params(seed: int = 0) -> dict:
    """The parameter dict ``tests/test_mano.py``'s generator builds."""
    m = test_mano.synthetic_mano(seed)
    kt = np.zeros((2, 16), np.int64)
    kt[0] = m.parents
    return {**{k: np.array(getattr(m, k)) for k in BUFFERS}, "kintree_table": kt}


@pytest.fixture(scope="module")
def params():
    return synthetic_params()


@pytest.fixture(scope="module")
def jm(params):
    return jmano.ManoModel(params=params)


@pytest.fixture(scope="module")
def pm(params):
    return pmano.ManoModel(params=params, device="cpu")


@pytest.fixture(scope="module")
def mano_pkl(params, tmp_path_factory):
    path = tmp_path_factory.mktemp("mano") / "mano.pkl"
    with open(path, "wb") as f:
        pickle.dump(params, f)
    return str(path)


def rel_largest(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def random_poses(rng, b: int) -> np.ndarray:
    """(b, 16, 3, 3) Rodrigues rotations of random axis-angles."""
    return np.stack([[jaik.axangle2mat(rng.normal(size=3), rng.uniform(0.0, 1.2))
                      for _ in range(16)] for _ in range(b)]).astype(np.float32)


def forward_both(jm, pm, pose, beta):
    jv, jj = jm(jnp.asarray(pose), jnp.asarray(beta))
    with torch.no_grad():
        pv, pj = pm(torch.from_numpy(pose), torch.from_numpy(beta))
    return (np.asarray(jv), np.asarray(jj)), (pv.numpy(), pj.numpy())


def test_chip_smoke_generator_is_the_jax_tests_own(params):
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    mine = smoke.synthetic_mano_params(0)
    assert set(mine) == set(params)
    for k in params:
        np.testing.assert_array_equal(np.asarray(mine[k]), params[k], err_msg=k)


@pytest.mark.parametrize("pose_kind", ["identity", "random"])
def test_mano_forward_matches_jax(jm, pm, pose_kind):
    rng = np.random.default_rng(1)
    pose = (np.broadcast_to(np.eye(3, dtype=np.float32), (4, 16, 3, 3)).copy()
            if pose_kind == "identity" else random_poses(rng, 4))
    beta = (2.0 * rng.standard_normal((4, 10))).astype(np.float32)
    (jv, jj), (pv, pj) = forward_both(jm, pm, pose, beta)
    assert pv.shape == (4, 778, 3) and pj.shape == (4, 21, 3)
    assert rel_largest(pv, jv) <= 1e-5
    assert rel_largest(pj, jj) <= 1e-5


def test_shaped_joints_and_bone_lengths_match_jax(jm, pm):
    beta = (3.0 * np.random.default_rng(2).standard_normal((100, 10))).astype(np.float32)
    with torch.no_grad():
        pj = pm.shaped_joints(torch.from_numpy(beta)).numpy()
        pb = pmano.relative_bone_lengths(pm, torch.from_numpy(beta)).numpy()
    assert rel_largest(pj, jm.shaped_joints(jnp.asarray(beta))) <= 1e-6
    jb = np.asarray(jmano.relative_bone_lengths(jm, jnp.asarray(beta)))
    np.testing.assert_allclose(pb, jb, rtol=1e-6, atol=0)


def test_parents_and_faces(jm, pm):
    np.testing.assert_array_equal(pm.parents, jm.parents)
    assert pm.faces is None and jm.faces is None
    for k in BUFFERS:
        np.testing.assert_array_equal(getattr(pm, k).numpy(), np.asarray(getattr(jm, k)))


def test_chumpy_tolerant_load_gives_both_packages_the_same_dict(params, tmp_path, monkeypatch):
    """The official pickle's layout: chumpy arrays (a stub class here),
    a scipy sparse ``J_regressor``, the uint32 -1 kintree root and faces."""
    import scipy.sparse

    ch = types.ModuleType("chumpy.ch")

    class Ch:
        pass

    Ch.__module__, Ch.__qualname__ = "chumpy.ch", "Ch"
    ch.Ch = Ch
    monkeypatch.setitem(sys.modules, "chumpy", types.ModuleType("chumpy"))
    monkeypatch.setitem(sys.modules, "chumpy.ch", ch)

    def chumpy(a):
        c = Ch()
        c.__dict__["x"] = a
        return c

    kt = params["kintree_table"].astype(np.uint32)
    kt[0, 0] = np.uint32(2**32 - 1)
    faces = np.random.default_rng(3).integers(0, 778, (1538, 3)).astype(np.uint32)
    raw = {"v_template": params["v_template"], "shapedirs": chumpy(params["shapedirs"]),
           "posedirs": params["posedirs"],
           "J_regressor": scipy.sparse.csc_matrix(params["J_regressor"]),
           "weights": chumpy(params["weights"]), "kintree_table": kt, "f": faces,
           "bs_style": "lbs"}
    path = tmp_path / "MANO_RIGHT.pkl"
    with open(path, "wb") as f:
        pickle.dump(raw, f, protocol=2)
    monkeypatch.delitem(sys.modules, "chumpy.ch")
    monkeypatch.delitem(sys.modules, "chumpy")

    got, want = pmano._chumpy_tolerant_load(str(path)), jmano._chumpy_tolerant_load(str(path))
    assert sorted(got) == sorted(want) == sorted(raw)
    for k in want:
        a, b = got[k], want[k]
        assert type(a) is type(b), k
        if scipy.sparse.issparse(b):
            np.testing.assert_array_equal(a.todense(), b.todense())
        else:
            np.testing.assert_array_equal(a, b)
    assert isinstance(got["shapedirs"], np.ndarray)

    j, p = jmano.ManoModel(str(path)), pmano.ManoModel(str(path), device="cpu")
    np.testing.assert_array_equal(p.parents, j.parents)
    assert p.parents[0] == 0
    np.testing.assert_array_equal(p.faces, j.faces)
    for k in BUFFERS:
        np.testing.assert_array_equal(getattr(p, k).numpy(), np.asarray(getattr(j, k)))


def test_aik_and_axangle2mat_bit_for_bit(jm):
    rng = np.random.default_rng(4)
    for _ in range(3):
        axis, angle = rng.normal(size=3), rng.uniform(-3, 3)
        np.testing.assert_array_equal(paik.axangle2mat(axis, angle),
                                      jaik.axangle2mat(axis, angle))
    np.testing.assert_array_equal(paik.axangle2mat(np.zeros(3), 1.0),
                                  jaik.axangle2mat(np.zeros(3), 1.0))
    _, t21 = jm(jnp.broadcast_to(jnp.eye(3), (1, 16, 3, 3)), jnp.zeros((1, 10)))
    template = JM.mano_to_freihand(np.asarray(t21[0]))
    for _ in range(4):
        target = template + rng.normal(scale=0.01, size=(21, 3))
        np.testing.assert_array_equal(paik.adaptive_ik(template, target),
                                      jaik.adaptive_ik(template, target))


def test_one_euro_filter_bit_for_bit():
    rng = np.random.default_rng(5)
    signal = rng.normal(size=(40, 21, 3))
    for kw in ({}, {"mincutoff": 4.0, "beta": 0.3, "dcutoff": 2.0, "freq": 25.0}):
        p, j = psmooth.OneEuroFilter(**kw), jsmooth.OneEuroFilter(**kw)
        for x in signal:
            np.testing.assert_array_equal(p.process(x), j.process(x))


def test_bone_helpers_bit_for_bit():
    rng = np.random.default_rng(6)
    joints = rng.normal(size=(5, 21, 3))
    for normalize in (True, False):
        np.testing.assert_array_equal(plm.ref_bones_from_joints(joints, normalize),
                                      jlm.ref_bones_from_joints(joints, normalize))
    a, b = rng.uniform(0.2, 1.5, (7, 15)), rng.uniform(0.2, 1.5, (7, 15))
    assert plm.align_bone_len(a, b) == jlm.align_bone_len(a, b)
    np.testing.assert_array_equal(plm.align_bone_len_ratio(a, b), jlm.align_bone_len_ratio(a, b))


def flax_shape_net_params(seed: int = 0):
    return jsn.ShapeNet().init(jax.random.key(seed), jnp.zeros((1, 15)))["params"]


def port_shape_net(flax_params) -> psn.ShapeNet:
    model = psn.ShapeNet()
    model.load_state_dict(convert.shape_net_from_flax_params(
        jax.tree.map(np.asarray, flax_params)), strict=True)
    return model


def test_shape_net_forward_from_converted_params():
    fp = flax_shape_net_params()
    bones = np.random.default_rng(7).uniform(0.2, 1.5, (16, 15)).astype(np.float32)
    want = np.asarray(jsn.ShapeNet().apply({"params": fp}, jnp.asarray(bones)))
    with torch.no_grad():
        got = port_shape_net(fp)(torch.from_numpy(bones)).numpy()
    assert got.shape == (16, 10)
    # relative to the largest output: five float32 products summed in
    # another order (measured 7.3e-7 at most over four seeds)
    assert rel_largest(got, want) <= 1e-6
    names = [n for n, _ in psn.ShapeNet().named_parameters()]
    assert names == [f"{m}.{leaf}" for m in ("fc0", "fc1", "fc2", "fc3", "fc4", "fc_out")
                     for leaf in ("weight", "bias")]


def jax_bones_finite_grad(mano, beta):
    """JAX's ``relative_bone_lengths`` with the wrist's zero-length "bone"
    (joint 0 less its own parent) left out before the norm: the same values
    bit for bit, and the gradient ``torch.linalg.norm`` (and the reference's
    ``torch.norm``) gives, where JAX's sqrt at 0 gives NaN."""
    j = mano.shaped_joints(beta)
    reorder = jnp.asarray(pmano.BONE_REORDER)
    rel = (j - j[:, jnp.asarray(pmano.BONE_PARENT)])[:, reorder]
    ref = jnp.linalg.norm(j[:, 4] - j[:, 0], axis=-1, keepdims=True)
    return jnp.linalg.norm(rel, axis=-1) / ref


def sik_setup(jm, seed: int = 1):
    fp = flax_shape_net_params(seed)
    bones = np.array(jmano.relative_bone_lengths(
        jm, 3.0 * jax.random.normal(jax.random.key(2), (32, 10))))

    def loss_fn(p):
        return jsn.sik_loss(jm, jsn.ShapeNet().apply({"params": p}, bones), bones)[0]

    return fp, bones, loss_fn


def test_jax_sik_loss_gradient_is_nan_and_the_ports_finite(jm, pm, monkeypatch):
    """A fault of the JAX package, kept there: the gradient of its
    ``sik_loss`` is NaN, because ``relative_bone_lengths`` takes the norm of
    joint 0 less itself (a zero vector) before dropping it, and sqrt'(0) =
    inf meets the dropped bone's zero cotangent. Its ShapeNet trainer's
    parameters are NaN after the first step. The port's norm has gradient 0
    there, as the reference's ``torch.norm`` has."""
    fp, bones, loss_fn = sik_setup(jm)
    grads = jax.jit(jax.grad(loss_fn))(fp)
    assert any(np.isnan(np.asarray(g)).any() for g in jax.tree.leaves(grads))
    model = port_shape_net(fp)
    psn.sik_loss(pm, model(torch.from_numpy(bones)), torch.from_numpy(bones))[0].backward()
    assert all(p.grad.isfinite().all() for p in model.parameters())
    beta = jnp.asarray(np.random.default_rng(3).normal(size=(8, 10)), jnp.float32)
    np.testing.assert_array_equal(jax_bones_finite_grad(jm, beta),
                                  jmano.relative_bone_lengths(jm, beta))
    monkeypatch.setattr(jsn, "relative_bone_lengths", jax_bones_finite_grad)
    grads = jax.jit(jax.grad(loss_fn))(fp)
    assert all(np.isfinite(np.asarray(g)).all() for g in jax.tree.leaves(grads))


def test_sik_loss_and_its_gradients_match_jax(jm, pm, monkeypatch):
    """Against JAX's ``sik_loss`` over ``jax_bones_finite_grad`` (JAX's own
    gradient is NaN, see above)."""
    monkeypatch.setattr(jsn, "relative_bone_lengths", jax_bones_finite_grad)
    fp, bones, loss_fn = sik_setup(jm)
    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(fp)
    model = port_shape_net(fp)
    loss, bone_hat = psn.sik_loss(pm, model(torch.from_numpy(bones)), torch.from_numpy(bones))
    assert bone_hat.shape == (32, 15)
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    loss.backward()
    want_sd = convert.shape_net_from_flax_params(jax.tree.map(np.asarray, want_grads))
    for name, p in model.named_parameters():
        assert rel_largest(p.grad.numpy(), want_sd[name].numpy()) <= 1e-5, name


@pytest.mark.parametrize("case", ["pso_test", "recon_default"])
def test_pso_matches_jax(jm, pm, case):
    """On the JAX tests' target (test_pso_fits_known_shape) and with the
    reconstruction's settings (60 particles, 20 iterations, seed 0)."""
    rng = np.random.default_rng(5)
    beta_true = rng.uniform(-1, 1, 10).astype(np.float32)
    target = np.asarray(jmano.relative_bone_lengths(jm, jnp.asarray(beta_true)[None]))[0]
    kw = ({"n_particles": 60, "n_iters": 25, "seed": 1} if case == "pso_test"
          else {"n_particles": 60, "n_iters": 20})
    got, want = psn.pso_fit_shape(pm, target, **kw), jsn.pso_fit_shape(jm, target, **kw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_sample_shape_dataset_matches_jax(jm, pm):
    pb, pbeta = psn.sample_shape_dataset(pm, 16, seed=3)
    jb, jbeta = jsn.sample_shape_dataset(jm, 16, seed=3)
    np.testing.assert_array_equal(pbeta, jbeta)
    np.testing.assert_allclose(pb, jb, rtol=1e-6, atol=0)


def test_lm_matches_jax(jm, pm):
    """On the JAX tests' target (test_lm_fit_recovers_shape). Over the
    first 6 iterations every step is accepted in both packages, and beta is
    held within 1e-4. At the JAX test's 25 iterations the cost sits within
    ~1e-8 of its floor, below float32's resolution of it (~1.2e-10 of
    1.7e-3 an ulp, the two packages' costs of one beta 1.3e-8 apart), so
    which late steps are accepted follows the rounding: there the cost is
    held within rel 1e-4 and beta within 3e-3 (measured 1.8e-3), a flat
    direction of the fit."""
    rng = np.random.default_rng(11)
    beta_true = rng.uniform(-1, 1, 10).astype(np.float32)
    target = np.asarray(jmano.relative_bone_lengths(jm, jnp.asarray(beta_true)[None]))[0]
    got, got_cost = plm.lm_fit_shape(pm, target, n_iters=6)
    want, want_cost = jlm.lm_fit_shape(jm, target, n_iters=6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert abs(got_cost - want_cost) <= 1e-4 * want_cost
    got, got_cost = plm.lm_fit_shape(pm, target, n_iters=25)
    want, want_cost = jlm.lm_fit_shape(jm, target, n_iters=25)
    assert abs(got_cost - want_cost) <= 1e-4 * want_cost
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-3)
    beta0 = np.full(10, 0.5, np.float32)
    got, got_cost = plm.lm_fit_shape(pm, target, n_iters=4, beta0=beta0)
    want, want_cost = jlm.lm_fit_shape(jm, target, n_iters=4, beta0=beta0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def rest_joints(jm) -> np.ndarray:
    _, base = jm(jnp.broadcast_to(jnp.eye(3), (1, 16, 3, 3)), jnp.zeros((1, 10)))
    return JM.mano_to_freihand(np.asarray(base[0]))


@pytest.mark.parametrize("case,beta,limit", [
    ("noisy", 0.3, 1e-5), ("noisy", None, 1e-5), ("rest", 0.3, 1e-5), ("rest", 0.0, 5e-3)])
def test_reconstruct_matches_jax(jm, pm, case, beta, limit):
    """On the recon CLI's predictions (the rest skeleton + N(0, 0.002)),
    with beta given and fitted by PSO, within 1e-5. On the rest skeleton
    itself at beta = 0 every bone's swing is 0 to rounding: AIK's arccos
    of a cosine a few ulps under 1 turns the packages' ~1e-7 apart
    templates into angles ~1e-4 apart (measured 9.2e-4 on verts, 3.0e-3 on
    pose_R), which both packages share; held within 5e-3 there."""
    target = rest_joints(jm)
    if case == "noisy":
        target = target + np.random.default_rng(12).normal(scale=0.002, size=(21, 3))
    beta = None if beta is None else np.full(10, beta)
    got = precon.reconstruct(pm, target, beta=beta)
    want = jrecon.reconstruct(jm, target, beta=beta)
    for name, g, w in zip(("verts", "joints21", "pose_R"), got[:3], want[:3]):
        assert rel_largest(g, w) <= limit, name
    assert got[0].shape == (778, 3) and got[2].shape == (1, 16, 3, 3)
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-5)


def test_recon_epe_and_main_match_jax(jm, pm, mano_pkl, capsys):
    preds = rest_joints(jm)[None] + np.random.default_rng(8).normal(scale=0.002, size=(2, 21, 3))
    got, want = precon.recon_epe(pm, preds), jrecon.recon_epe(jm, preds)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), k
    got = precon.main(["--mano", mano_pkl, "--n", "2", "--device", "cpu"])
    jrecon.main(["--mano", mano_pkl, "--n", "2"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed[0] == str(got)
    want = eval(printed[1], {"np": np, "float64": np.float64})  # the dict JAX's main printed
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), k


def test_sik1m_samples_bit_for_bit(tmp_path):
    from simhand_tpu.finetune import datasets as jd
    from simhand_tpu_torch.finetune import datasets as pd

    rng = np.random.default_rng(9)
    np.save(tmp_path / "data_bone.npy", rng.uniform(0.2, 1.5, (50, 15)))
    np.save(tmp_path / "data_shape.npy", 3.0 * rng.standard_normal((50, 10)))
    np.testing.assert_array_equal(pd.SIK1M_NOISE, jd.SIK1M_NOISE)
    for split, n in (("train", 40), ("test", 10), ("val", 10), ("all", 50)):
        p, j = pd.SIK1M(str(tmp_path), split, seed=3), jd.SIK1M(str(tmp_path), split, seed=3)
        assert len(p) == len(j) == n
        for i in (0, n - 1, 0, 3):
            a, b = p[i], j[i]
            np.testing.assert_array_equal(a["rel_bone_len"], b["rel_bone_len"])
            np.testing.assert_array_equal(a["shape"], b["shape"])


def test_create_data_bones_match_jax(jm, pm, mano_pkl, tmp_path):
    from simhand_tpu_torch.finetune import create_data
    from simhand_tpu_torch.finetune.datasets import create_sik1m_data

    create_data.main(["--mano", mano_pkl, "--total", "50", "--out", str(tmp_path / "cli"),
                      "--seed", "2", "--device", "cpu"])
    create_sik1m_data(pm, 50, str(tmp_path / "lib"), batch=16, seed=2)
    for d in ("cli", "lib"):
        bones = np.load(tmp_path / d / "data_bone.npy")
        shapes = np.load(tmp_path / d / "data_shape.npy")
        assert bones.shape == (50, 15) and shapes.shape == (50, 10)
        assert bones.dtype == shapes.dtype == np.float64
        want = np.asarray(jmano.relative_bone_lengths(jm, jnp.asarray(shapes, jnp.float32)))
        np.testing.assert_allclose(bones, want, rtol=1e-6, atol=0)
        # betas ~ 3 N(0, 1), float32 values
        np.testing.assert_array_equal(shapes, shapes.astype(np.float32))
        assert 1.5 < shapes.std() < 4.5
    # one stream of draws, whatever the batch
    np.testing.assert_array_equal(np.load(tmp_path / "cli" / "data_shape.npy"),
                                  np.load(tmp_path / "lib" / "data_shape.npy"))


def test_train_shape_net_data_root_matches_optax(jm, mano_pkl, tmp_path, monkeypatch):
    """Three --data_root steps from JAX's init against an optax loop of
    JAX's ShapeNet / sik_loss (over ``jax_bones_finite_grad``: JAX's own
    gradient is NaN) / adam(exponential_decay), on the same bones (SIK1M
    with its noise and rng(seed + 1)'s indices); the decay at step 2."""
    import optax

    from simhand_tpu.finetune.datasets import SIK1M, create_sik1m_data
    from simhand_tpu_torch.finetune import train_shape_net as tsn

    monkeypatch.setattr(jsn, "relative_bone_lengths", jax_bones_finite_grad)
    root = str(tmp_path / "sik")
    create_sik1m_data(jm, 64, root, batch=32, seed=0)
    fp = flax_shape_net_params(0)
    sd = convert.shape_net_from_flax_params(jax.tree.map(np.asarray, fp))
    monkeypatch.setattr(tsn, "init_weights", lambda model, gen: model.load_state_dict(sd))
    model, losses = tsn.main(["--mano", mano_pkl, "--steps", "3", "--batch_size", "8",
                              "--data_root", root, "--lr_decay_step", "2",
                              "--device", "cpu", "--out", str(tmp_path / "sn.pt")])

    schedule = optax.exponential_decay(1e-3, 2, 0.3, staircase=True)
    tx = optax.adam(schedule)
    params, opt_state = fp, tx.init(fp)
    sik1m, rng = SIK1M(root, "train", seed=0), np.random.default_rng(1)

    @jax.jit
    def step(params, opt_state, bones):
        def loss_fn(p):
            return jsn.sik_loss(jm, jsn.ShapeNet().apply({"params": p}, bones), bones)[0]

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    want_losses = []
    for _ in range(3):
        idx = rng.integers(0, len(sik1m), 8)
        bones = np.stack([sik1m[j]["rel_bone_len"] for j in idx]).astype(np.float32)
        params, opt_state, loss = step(params, opt_state, bones)
        want_losses.append(float(loss))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    want = convert.shape_net_from_flax_params(jax.tree.map(np.asarray, params))
    for name, p in model.state_dict().items():
        assert rel_largest(p.numpy(), want[name].numpy()) <= 1e-4, name
    saved = psn.load_shape_net(str(tmp_path / "sn.pt"), "cpu")
    for name, p in saved.state_dict().items():
        assert torch.equal(p, model.state_dict()[name])


def test_train_shape_net_on_the_fly(mano_pkl, tmp_path):
    from simhand_tpu_torch.finetune import train_shape_net as tsn

    model, losses = tsn.main(["--mano", mano_pkl, "--steps", "4", "--batch_size", "16",
                              "--device", "cpu", "--out", str(tmp_path / "sn.pt")])
    assert losses.shape == (4,) and np.isfinite(losses).all()
    again, losses2 = tsn.main(["--mano", mano_pkl, "--steps", "4", "--batch_size", "16",
                               "--device", "cpu"])
    np.testing.assert_array_equal(losses, losses2)
    fresh = psn.ShapeNet()
    fresh.load_state_dict(torch.load(tmp_path / "sn.pt", weights_only=True), strict=True)


def test_flax_msgpack_reader(tmp_path):
    from flax import serialization

    fp = flax_shape_net_params(2)
    tree = convert.read_flax_msgpack(serialization.to_bytes(fp))
    assert jax.tree.structure(tree) == jax.tree.structure(jax.tree.map(np.asarray, fp))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(fp)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b))
    # a numpy scalar leaf (flax's extension type 3)
    assert convert.read_flax_msgpack(serialization.to_bytes({"s": np.float32(1.5)}))["s"] == 1.5
    path = tmp_path / "sn.msgpack"
    path.write_bytes(serialization.to_bytes(fp))
    sd = convert.read_shape_net(str(path))
    torch.save(sd, tmp_path / "sn.pt")
    for name, t in convert.read_shape_net(str(tmp_path / "sn.pt")).items():
        assert torch.equal(t, sd[name])
    psn.load_shape_net(str(path), "cpu")


def test_optimize_shape_synthetic_route(jm, mano_pkl, tmp_path, capsys):
    from flax import serialization

    from simhand_tpu_torch.finetune import optimize_shape as pos

    path = tmp_path / "sn.msgpack"
    path.write_bytes(serialization.to_bytes(flax_shape_net_params(0)))
    out = pos.main(["--mano", mano_pkl, "--n", "2", "--shapenet", str(path), "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "PSO" in printed and "LM" in printed and "ShapeNet" in printed
    assert out["pso_beta"].shape == out["lm_beta"].shape == out["shapenet_beta"].shape == (2, 10)
    for k in ("pso_mae", "lm_mae", "shapenet_mae"):
        assert np.isfinite(out[k])
    targets, _ = jsn.sample_shape_dataset(jm, 2, seed=0)
    np.testing.assert_allclose(out["targets"], targets, rtol=1e-6)
    want = np.stack([jsn.pso_fit_shape(jm, t, n_particles=80, n_iters=25, seed=i)
                     for i, t in enumerate(targets)])
    np.testing.assert_allclose(out["pso_beta"], want, rtol=0, atol=1e-5)


def test_optimize_shape_dl_route_matches_jax(jm, mano_pkl, tmp_path, monkeypatch, capsys):
    from flax import serialization

    import simhand_tpu.finetune.mano as jmano_mod
    from simhand_tpu.finetune.optimize_shape import main as jmain
    from simhand_tpu_torch.finetune import optimize_shape as pos

    path = tmp_path / "sn.msgpack"
    path.write_bytes(serialization.to_bytes(flax_shape_net_params(0)))
    rng = np.random.default_rng(10)
    pose = jnp.asarray(random_poses(rng, 3))
    _, j21 = jm(pose, jnp.asarray(rng.normal(size=(3, 10)).astype(np.float32)))
    jpath = tmp_path / "pre.npy"
    np.save(jpath, JM.mano_to_freihand(np.asarray(j21)))
    out = pos.main(["--mano", mano_pkl, "--shapenet", str(path), "--pre_joints", str(jpath),
                    "--out_beta", str(tmp_path / "port.npy"), "--device", "cpu"])
    monkeypatch.setattr(jmano_mod, "ManoModel", lambda p: jm)
    jmain(["--mano", "unused", "--shapenet", str(path), "--pre_joints", str(jpath),
           "--out_beta", str(tmp_path / "jax.npy")])
    printed = capsys.readouterr().out
    assert printed.count("dl regression error") == 2
    got, want = np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy")
    assert got.shape == want.shape == (3, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out["beta"], got)
    with pytest.raises(SystemExit):
        pos.main(["--mano", mano_pkl, "--pre_joints", str(jpath), "--device", "cpu"])


def test_entry_points_need_a_card_unless_asked_for_the_cpu(params, mano_pkl, tmp_path):
    from simhand_tpu_torch.finetune import create_data, optimize_shape, recon, train_shape_net

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmano.ManoModel(params=params)
    for main, flags in ((recon.main, ["--n", "1"]),
                        (create_data.main, ["--total", "4", "--out", str(tmp_path)]),
                        (train_shape_net.main, ["--steps", "1"]),
                        (optimize_shape.main, ["--n", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--mano", mano_pkl, *flags])
