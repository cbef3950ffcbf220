"""The port's 2.5D downstream path against the JAX package on the CPU:
the 2.5D <-> 3D geometry, the regression head ``RN25DWithMLPRef`` and its
helpers, the supervised samples of ``data/pipeline.py`` on a FreiHAND
layout written by the test, and ``experiments/downstream.py``'s main.
Float32 throughout.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import simhand_tpu.models.heads as jheads  # noqa: E402
from simhand_tpu.core import geometry as jgeo  # noqa: E402
from simhand_tpu.data.augment_cv2 import AugmentFlags as JFlags  # noqa: E402
from simhand_tpu.data.augment_cv2 import AugmentParams as JParams  # noqa: E402
from simhand_tpu.data.pipeline import PretrainDataset as JDataset  # noqa: E402
from simhand_tpu.data.sources.freihand import FreihandPretrainSource as JSource  # noqa: E402
from simhand_tpu.experiments import downstream as jdown  # noqa: E402
from simhand_tpu_torch.convert import from_flax_variables  # noqa: E402
from simhand_tpu_torch.core import geometry as tgeo  # noqa: E402
from simhand_tpu_torch.data.augment_cv2 import AugmentFlags, AugmentParams  # noqa: E402
from simhand_tpu_torch.data.pipeline import PretrainDataset  # noqa: E402
from simhand_tpu_torch.data.sources.freihand import FreihandPretrainSource  # noqa: E402
from simhand_tpu_torch.experiments import downstream as tdown  # noqa: E402
from simhand_tpu_torch.models import heads as theads  # noqa: E402
from simhand_tpu_torch.models.resnet import RESNETS  # noqa: E402

torch.set_num_threads(2)


def joints_and_K(seed, b=16):
    rng = np.random.default_rng(seed)
    j = rng.uniform(-0.08, 0.08, (b, 21, 3)).astype(np.float32)
    j[..., 2] += 0.6
    K = np.tile(np.array([[480, 0, 112], [0, 481, 113], [0, 0, 1]], np.float32), (b, 1, 1))
    K[:, 0, 0] += rng.uniform(0, 50, b).astype(np.float32)
    K[:, :2, 2] += rng.uniform(-9, 9, (b, 2)).astype(np.float32)
    return j, K


def test_2_5d_geometry_matches():
    """convert_to_2_5d bit for bit (XLA's dot as two fused multiply-adds);
    the lift back through K's inverse within 1e-6 of the largest value
    (torch.linalg.inv and XLA's LU solve round the inverse differently)."""
    j, K = joints_and_K(0)
    want, wscale = jgeo.convert_to_2_5d(jnp.asarray(K), jnp.asarray(j))
    got, gscale = tgeo.convert_to_2_5d(torch.from_numpy(K), torch.from_numpy(j))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gscale.numpy(), np.asarray(wscale))
    wz, wkinv = jgeo.root_depth(want, jnp.asarray(K))
    gz, gkinv = tgeo.root_depth(got, torch.from_numpy(K))
    np.testing.assert_allclose(gz.numpy(), np.asarray(wz), rtol=1e-6)
    np.testing.assert_allclose(gkinv.numpy(), np.asarray(wkinv), rtol=1e-6, atol=1e-9)
    w3 = np.asarray(jgeo.convert_2_5d_to_3d(want, wscale, jnp.asarray(K)))
    g3 = tgeo.convert_2_5d_to_3d(got, gscale, torch.from_numpy(K)).numpy()
    np.testing.assert_allclose(g3, w3, rtol=0, atol=1e-6 * np.abs(w3).max())
    np.testing.assert_allclose(g3, j, rtol=0, atol=1e-5)
    zr = np.full(16, 7.5, np.float32)
    w3 = np.asarray(jgeo.convert_2_5d_to_3d(want, wscale, jnp.asarray(K), jnp.asarray(zr)))
    np.testing.assert_allclose(
        tgeo.convert_2_5d_to_3d(got, gscale, torch.from_numpy(K), torch.from_numpy(zr)).numpy(),
        w3, rtol=0, atol=1e-6 * np.abs(w3).max())


@pytest.fixture(scope="module")
def rn25d():
    model = jheads.RN25DWithMLPRef(resnet_size="18")
    v = jax.device_get(model.init(jax.random.key(0), jnp.zeros((2, 32, 32, 3))))
    return model, v


@pytest.mark.parametrize("train", [False, True])
def test_rn25d_forward_matches(rn25d, train):
    """ResNet-18, B = 8, 32x32, with and without K: every output within
    1e-4 of its largest (train mode: batch statistics over 8 samples), the
    root's zrel exactly 0 in kp25d too (the reference's aliased write)."""
    jm, v = rn25d
    model = theads.RN25DWithMLPRef("18")
    model.load_state_dict(from_flax_variables(v["params"], v["batch_stats"]), strict=True)
    model.train(train)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (8, 32, 32, 3)).astype(np.float32)
    _, K = joints_and_K(2, 8)
    for k_in in (None, K):
        jargs = {} if k_in is None else {"K": jnp.asarray(k_in)}
        if train:
            want, _ = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"], **jargs)
        else:
            want = jm.apply(v, jnp.asarray(x), **jargs)
        with torch.no_grad():
            got = model(torch.from_numpy(x), None if k_in is None else torch.from_numpy(k_in))
        assert got.keys() == want.keys()
        for key in want:
            w = np.asarray(want[key])
            np.testing.assert_allclose(got[key].numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                       err_msg=key)
        assert (got["kp25d"][:, 0, 2] == 0).all() and (got["zrel"][:, 0] == 0).all()


def test_head_helpers_match():
    rng = np.random.default_rng(3)
    hm = rng.normal(size=(2, 21, 8, 8)).astype(np.float32)
    np.testing.assert_allclose(theads.normalize_heatmap(torch.from_numpy(hm)).numpy(),
                               np.asarray(jheads.normalize_heatmap(jnp.asarray(hm))), rtol=1e-6)
    jx, jy, sc, ang = rng.uniform(-3, 3, (4, 5)).astype(np.float32)
    sc = np.abs(sc) + 0.5
    np.testing.assert_allclose(
        theads.heatmap_transformation_matrix(jx, jy, sc, ang * 30, (32, 48)).numpy(),
        np.asarray(jheads.heatmap_transformation_matrix(jx, jy, sc, ang * 30, (32, 48))),
        rtol=1e-5, atol=1e-5)
    m = rng.normal(size=(5, 2, 3)).astype(np.float32)
    np.testing.assert_allclose(theads.affine_mat_to_theta(m, 64.0, 48.0).numpy(),
                               np.asarray(jheads.affine_mat_to_theta(m, 64.0, 48.0)), rtol=1e-6)
    jd = jheads.Denoiser()
    x = rng.normal(size=(6, 10)).astype(np.float32)
    v = jax.device_get(jd.init(jax.random.key(1), jnp.asarray(x)))
    td = theads.Denoiser(10)
    td.load_state_dict(from_flax_variables(v["params"], v["batch_stats"]), strict=True)
    with torch.no_grad():
        np.testing.assert_allclose(td.eval()(torch.from_numpy(x)).numpy(),
                                   np.asarray(jd.apply(v, jnp.asarray(x))), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(theads.DEFAULT_K.numpy(), np.asarray(jheads.DEFAULT_K))


N_UNIQUE = 8


@pytest.fixture(scope="module")
def freihand(tmp_path_factory):
    """A FreiHAND release layout: 8 labelled frames, x4 green-screen copies
    (4 * 8 JPEGs of 224x224), training_K.json and training_xyz.json."""
    root = tmp_path_factory.mktemp("freihand")
    rng = np.random.default_rng(4)
    xyz, K = joints_and_K(5, N_UNIQUE)
    (root / "training" / "rgb").mkdir(parents=True)
    for i in range(4 * N_UNIQUE):
        img = rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)
        cv2.imwrite(str(root / "training" / "rgb" / f"{i:08d}.jpg"), img)
    (root / "training_K.json").write_text(json.dumps(K.tolist()))
    (root / "training_xyz.json").write_text(json.dumps(xyz.tolist()))
    return root


@pytest.mark.parametrize("use_palm", [False, True])
def test_supervised_samples_match(freihand, use_palm):
    """Every third supervised sample of both splits on the host route (cv2),
    crop / resize / rotate / colour jitter: every key bit for bit but the
    recreated 3D joints, which pass through K's inverse (within 1e-6 of
    their largest)."""
    flags = dict(crop=True, resize=True, rotate=True, color_jitter=True)
    for split in ("train", "val"):
        js, ts = JSource(str(freihand), split), FreihandPretrainSource(str(freihand), split)
        assert len(js) == len(ts) and (js.indices == ts.indices).all()
        jd = JDataset(js, "supervised", JFlags(**flags), JParams(), seed=3, use_palm=use_palm)
        td = PretrainDataset(ts, "supervised", AugmentFlags(**flags), AugmentParams(), seed=3,
                             use_palm=use_palm)
        for i in range(0, len(js), 3):
            want, got = jd.__getitem__(i, epoch=1), td.__getitem__(i, epoch=1)
            assert want.keys() == got.keys()
            for k in want:
                w = np.asarray(want[k])
                if k == "joints3D_recreated":
                    np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6 * np.abs(w).max())
                else:
                    np.testing.assert_array_equal(got[k], w, err_msg=k)
                    assert np.asarray(got[k]).dtype == w.dtype, k


def test_downstream_main_matches_jax(freihand, tmp_path, monkeypatch):
    """Both mains on the layout's val split (4 samples, B = 2) with one
    torchvision-layout ResNet-18 .pth, from JAX's initial head (the port's
    init is patched to load it): every metric within rel 1e-4 of JAX's
    (float32 forwards; the lift's K inverse rounds apart)."""
    enc = RESNETS["18"]()
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for t in enc.state_dict().values():
            if t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=gen) * 0.05 + (t == 1).float())
    path = tmp_path / "encoder.pth"
    torch.save({k: v for k, v in enc.state_dict().items()
                if not k.endswith("num_batches_tracked")}, path)
    inits = []
    real_init = jheads.RN25DWithMLPRef.init

    def recording_init(self, *a, **k):
        inits.append(jax.device_get(real_init(self, *a, **k)))
        return inits[-1]

    def jax_init(model, generator):
        v = inits[0]
        model.load_state_dict(from_flax_variables(v["params"], v["batch_stats"]), strict=True)

    monkeypatch.setattr(jheads.RN25DWithMLPRef, "init", recording_init)
    monkeypatch.setattr(tdown, "init_weights", jax_init)
    args = ["--encoder", str(path), "--resnet_size", "18", "--data_dir", str(freihand),
            "--batch_size", "2"]
    want = jdown.main(args + ["-contrastive", "rotate"])
    got = tdown.main(args + ["--device", "cpu", "-contrastive", "rotate"])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
