"""The port's fine-tune data (``simhand_tpu_torch.finetune``: maps, datasets,
sample builder and its image stage, registry, batch iterator) against the
JAX package on the CPU.

The host half of the builder is the JAX package's numpy code: its targets
are held bit for bit. The image stage computes the JAX builder's ``cv2``
calls in torch: the blur and RGB2HSV bit for bit, the float steps (luma,
mean, HSV2RGB, the bilinear crop) in plain float32, where numpy, OpenBLAS
and OpenCV fuse and order them as their build's vector code does. So
``img`` is held to limits in 8-bit units, measured against OpenCV 5.0.0
on x86 (AVX2) and stated beside each assertion: at most the stated units
on at most the stated share of values. Frame widths that are a multiple
of 32 (the synthetic and FreiHAND frames are 224 wide) take the tight
limit; at other widths OpenCV's HSV2RGB rounds the row's last W mod 32
pixels where it truncates the rest (the port truncates everywhere), and
the jitter ops after the hue op scale that unit by up to 1.5 each.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from simhand_tpu.finetune import datasets as jds  # noqa: E402
from simhand_tpu.finetune import maps as jmaps  # noqa: E402
from simhand_tpu.finetune import registry as jreg  # noqa: E402
from simhand_tpu_torch.finetune import datasets as tds  # noqa: E402
from simhand_tpu_torch.finetune import image_stage as S  # noqa: E402
from simhand_tpu_torch.finetune import maps as tmaps  # noqa: E402
from simhand_tpu_torch.finetune import registry as treg  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OP_NAMES = {"_brightness": S.BRIGHTNESS, "_saturation": S.SATURATION, "_hue": S.HUE,
            "_contrast": S.CONTRAST}


# (units, share): the largest difference in 8-bit units, and the share of
# values that differ at all
CROP_LIMIT = (1, 1e-3)      # the crop alone (measured: 1, 2.4e-4 of one sample's)
VECTOR_LIMIT = (2, 2e-3)    # jitter + crop, width a multiple of 32 (2, 4e-4)
TAIL_LIMIT = (8, 0.08)      # jitter (+ crop) at other widths (6, 3.7e-2)


def assert_img_within(got, want, limit, what=""):
    got, want = np.asarray(got), np.asarray(want)
    if want.dtype == np.uint8:
        d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    else:                       # v / 255 - 0.5
        d = np.rint(np.abs(got.astype(np.float64) - want) * 255).astype(np.int64)
    units, share = limit
    assert d.max() <= units and (d > 0).mean() <= share, (what, int(d.max()), (d > 0).mean())


def assert_same(a: dict, b: dict, img_limit=None):
    assert a.keys() == b.keys()
    for k in a:
        if k == "img" and img_limit is not None:
            assert_img_within(b[k].numpy() if isinstance(b[k], torch.Tensor) else b[k], a[k],
                              img_limit, k)
            assert b[k].dtype in (np.float32, torch.float32)
            continue
        got = b[k].numpy() if isinstance(b[k], torch.Tensor) else b[k]
        np.testing.assert_array_equal(got, a[k], err_msg=k)
        assert np.asarray(got).dtype == np.asarray(a[k]).dtype, k


def test_maps_match_bit_for_bit():
    rng = np.random.default_rng(0)
    for _ in range(20):
        kp = rng.uniform(-20, 150, (21, 2)).astype(np.float32)
        for sigma in (1.0, 2.0):
            assert_same(dict(zip(("hm", "veil"), jmaps.gen_heatmaps(kp, 128, 32, sigma))),
                        dict(zip(("hm", "veil"), tmaps.gen_heatmaps(kp, 128, 32, sigma))))
        joint = rng.uniform(-0.1, 0.1, (21, 3)).astype(np.float32)
        joint[:, 2] += 0.5
        want, got = jmaps.joint_maps(joint, 16), tmaps.joint_maps(joint, 16)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(tmaps.xyz_from_maps(joint, got[2], got[3]),
                                      jmaps.xyz_from_maps(joint, want[2], want[3]))
    assert (tmaps.SNAP_PARENT, tmaps.REF_BONE_LINK, tmaps.JOINT_ROOT_IDX) == (
        jmaps.SNAP_PARENT, jmaps.REF_BONE_LINK, jmaps.JOINT_ROOT_IDX)


def test_uvd_conversions_match():
    """float32 on both sides, the same elementwise arithmetic: rtol 1e-6."""
    rng = np.random.default_rng(1)
    xyz = rng.uniform(-0.1, 0.1, (3, 21, 3)).astype(np.float32)
    xyz[..., 2] += 0.6
    root, bone = xyz[:, 9], np.linalg.norm(xyz[:, 9] - xyz[:, 0], axis=-1)
    K = np.tile(np.array([[480, 0, 128], [0, 470, 120], [0, 0, 1]], np.float32), (3, 1, 1))
    want = np.asarray(jmaps.xyz2uvd(xyz, root, bone, K))
    got = tmaps.xyz2uvd(*map(torch.from_numpy, (xyz, root, bone, K)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    back = tmaps.uvd2xyz(got, *map(torch.from_numpy, (root, bone, K)))
    np.testing.assert_allclose(back.numpy(), np.asarray(jmaps.uvd2xyz(want, root, bone, K)),
                               rtol=1e-6, atol=1e-7)


def test_affine_helpers_match_bit_for_bit():
    rng = np.random.default_rng(2)
    for _ in range(10):
        center, scale, rot = rng.uniform(20, 200, 2), rng.uniform(30, 300), rng.uniform(-3, 3)
        for a, b in zip(jds.get_affine_transform(center, scale, [128, 128], rot),
                        tds.get_affine_transform(center, scale, [128, 128], rot)):
            np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(tds.get_affine_trans_no_rot(center, scale, [64, 96]),
                                      jds.get_affine_trans_no_rot(center, scale, [64, 96]))
        pts = rng.uniform(0, 224, (21, 2))
        aff = jds.get_affine_transform(center, scale, [128, 128], rot)[0]
        np.testing.assert_array_equal(tds.transform_coords(pts, aff),
                                      jds.transform_coords(pts, aff))


@pytest.mark.parametrize("render", [False, True])
def test_datasets_match_bit_for_bit(render):
    kw = dict(n=12, side=96, seed=3, render_joints=render)
    jd, td = jds.SyntheticPoseDataset(**kw), tds.SyntheticPoseDataset(**kw)
    assert len(td) == len(jd)
    for i in range(len(jd)):
        assert_same(jd[i], td[i])
    jsets = [jds.SyntheticPoseDataset(n=5, side=64, seed=s) for s in (0, 1)]
    tsets = [tds.SyntheticPoseDataset(n=5, side=64, seed=s) for s in (0, 1)]
    jc, tc = jds.ConcatDataset(jsets), tds.ConcatDataset(tsets)
    assert len(tc) == len(jc) == 10
    for i in (0, 4, 5, 9):
        assert_same(jc[i], tc[i])
    jm = jds.WeightedMixDataset(jsets, [0.3, 0.7], epoch_size=7, seed=2)
    tm = tds.WeightedMixDataset(tsets, [0.3, 0.7], epoch_size=7, seed=2)
    for epoch in (0, 3):
        jm.set_epoch(epoch)
        tm.set_epoch(epoch)
        for i in range(7):
            assert_same(jm[i], tm[i])


class RecordingRng:
    """A numpy Generator that records the op names photometric_augment's
    shuffle leaves (the JAX builder shuffles its list of functions)."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.orders = []

    def shuffle(self, ops):
        self.rng.shuffle(ops)
        self.orders.append(tuple(OP_NAMES[f.__name__] for f in ops))

    def __getattr__(self, name):
        return getattr(self.rng, name)


@pytest.mark.parametrize("train", [True, False])
def test_builder_targets_bit_for_bit_and_img_within_limit(train):
    """Every target key bit for bit, and img to its limit, at 24 (seed,
    epoch, index) draws on frames 224 and 150 wide; the photometric
    permutation is JAX's, and both builders leave their generators in the
    same state."""
    jb, tb = jds.DetnetSampleBuilder(train=train), tds.DetnetSampleBuilder(train=train)
    ds = jds.SyntheticPoseDataset(n=12, side=224, seed=5, render_joints=True)
    small = jds.SyntheticPoseDataset(n=12, side=150, seed=6)
    orders = set()
    for src, jitter_limit in ((ds, VECTOR_LIMIT), (small, TAIL_LIMIT)):
        for i in range(12):
            key = [7, i % 3, i]
            jr, tr = RecordingRng(key), np.random.default_rng(key)
            want = jb(src[i], jr)
            got = tb(src[i], tr)
            assert_same(want, got, jitter_limit if train else CROP_LIMIT)
            assert jr.rng.bit_generator.state == tr.bit_generator.state
            _, _, draws = tb.build(src[i], np.random.default_rng(key))
            assert draws.order == (jr.orders[0] if train else ())
            orders.update(jr.orders)
    assert len(orders) > 5 if train else orders == set()


def test_photometric_augment_within_limit():
    """The function alone on a frame 77 wide, at zero and nonzero strengths
    (a zero-strength op is drawn and skipped): the draws bit for bit, the
    image to TAIL_LIMIT (measured: 2 units, 4.4e-2 of all values)."""
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, (61, 77, 3), dtype=np.uint8)
    for seed in range(12):
        for kw in ({}, {"hue": 0.0}, {"brightness": 0.0, "contrast": 0.0}, {"blur_radius": 0.0}):
            jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
            assert_img_within(tds.photometric_augment(img, tr, **kw),
                              jds.photometric_augment(img, jr, **kw), TAIL_LIMIT, (seed, kw))
            assert jr.bit_generator.state == tr.bit_generator.state


def test_each_cv2_op_matches():
    """GaussianBlur at radii across ksize 3 and 5 (and < 1e-3: the identity)
    and RGB2HSV at random pixels bit for bit; HSV2RGB at every 8-bit HSV
    triple, warpAffine at random crops with rotation and scale that reach
    past the frame, the luma product and the mean to their limits."""
    rng = np.random.default_rng(9)
    frames = rng.integers(0, 256, (3, 57, 83, 3), dtype=np.uint8)
    for r in (0.0005, 0.08, 0.2, 0.3, 0.41, 0.42, 0.5):
        k = S.gaussian_kernel_u8(r)
        got = S.blur_u8(torch.from_numpy(frames), torch.from_numpy(np.stack([k] * 3))).numpy()
        for f, g in zip(frames, got):
            want = cv2.GaussianBlur(f, (0, 0), sigmaX=r) if r > 1e-3 else f
            np.testing.assert_array_equal(g, want)

    px = rng.integers(0, 256, (256, 1024, 3), dtype=np.uint8)
    np.testing.assert_array_equal(S.rgb_to_hsv_u8(torch.from_numpy(px)).numpy(),
                                  cv2.cvtColor(px, cv2.COLOR_RGB2HSV))
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij")
    hsv = np.stack([h, s, v], -1).astype(np.uint8).reshape(180 * 256, 256, 3)
    # rows 256 wide, all in OpenCV's truncating vector code; it fuses
    # 1 - s x, the port rounds twice (measured: 1 unit, 5.0e-5 of values)
    assert_img_within(S.hsv_to_rgb_u8(torch.from_numpy(hsv)).numpy(),
                      cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB), (1, 2e-4), "HSV2RGB")

    for seed in range(6):
        r = np.random.default_rng(seed)
        frame = r.integers(0, 256, (int(r.integers(60, 240)), int(r.integers(60, 240)), 3),
                           dtype=np.uint8)
        aff = jds.get_affine_transform(r.uniform(0, 200, 2), r.uniform(20, 400), [128, 128],
                                       r.uniform(-np.pi, np.pi) if seed % 2 else 0.0)[0]
        assert_img_within(tds.transform_img(frame, aff, [128, 128]),
                          jds.transform_img_cv2(frame, aff, [128, 128]), CROP_LIMIT, seed)

    w = np.array([0.299, 0.587, 0.114], np.float32)
    for shape in ((5, 7), (97, 110), (224, 224), (130, 300)):
        x = rng.uniform(0, 255, shape + (3,)).astype(np.float32)
        gray = S.gray_f32(torch.from_numpy(x))
        # positive terms, five roundings here and up to three in OpenBLAS's
        # fused sgemv: within 8 half-ulps, 2^-21 (measured: 2.3e-7)
        np.testing.assert_allclose(gray.numpy(), x @ w, rtol=2.0**-21, atol=0)
        # float64 against numpy's float32 pairwise sum (error ~ eps log2 n):
        # rtol 1e-6 (measured: 0 at these sizes)
        np.testing.assert_allclose(S.mean_f32(gray.reshape(1, -1)).numpy()[0],
                                   (x @ w).mean(), rtol=1e-6, atol=0)


def test_build_composed_dataset_parsing(tmp_path):
    """The registry's composed sets in both packages, sample for sample: the
    synthetic sets alone, mixed and weighted, and a synthetic set beside a
    benchmark reader (CMU hand labels on the JAX tests' layout)."""
    for names, kw in (("synthetic", {}), ("synthetic,synthetic-hand", {}),
                      (["synthetic", "synthetic-hand"], {"weights": [1.0, 3.0], "epoch_size": 9})):
        j = jreg.build_composed_dataset(names, None, "train", synthetic_n=6, **kw)
        t = treg.build_composed_dataset(names, None, "train", synthetic_n=6, **kw)
        assert type(t).__name__ == type(j).__name__ and len(t) == len(j)
        for i in range(len(j)):
            assert_same(j[i], t[i])
    assert treg.DATASET_KEYS == jreg.DATASET_KEYS and treg._NO_SPLIT == jreg._NO_SPLIT
    assert len(treg.build_composed_dataset("synthetic", None, "val", synthetic_n=6)) == 6
    from test_benchmark_readers import test_cmu_hand_labels_reader as write_cmu

    write_cmu(tmp_path)
    roots = [None, str(tmp_path / "cmu")]
    j = jreg.build_composed_dataset("synthetic,cmu", roots, "train", synthetic_n=6)
    t = treg.build_composed_dataset("synthetic,cmu", roots, "train", synthetic_n=6)
    assert type(t).__name__ == type(j).__name__ == "ConcatDataset" and len(t) == len(j) == 8
    for i in range(len(j)):
        assert_same(j[i], t[i])
    with pytest.raises(KeyError):
        treg.get_dataset("nope", None)


@pytest.mark.parametrize("shuffle,drop", [(True, True), (False, False)])
def test_batch_iterator_order_and_tail(shuffle, drop):
    """Batches of 4 over 10 samples: JAX's order, keys and values (img on
    the CPU device, frames 80 wide: TAIL_LIMIT, measured 2 units, 1.9e-2
    of values; the rest bit for bit), the tail kept when
    drop_remainder=False."""
    jd = jds.SyntheticPoseDataset(n=10, side=80, seed=4)
    td = tds.SyntheticPoseDataset(n=10, side=80, seed=4)
    kw = dict(seed=3, epoch=2, shuffle=shuffle, drop_remainder=drop)
    want = list(jds.detnet_batch_iterator(jd, jds.DetnetSampleBuilder(), 4, **kw))
    got = list(tds.detnet_batch_iterator(td, tds.DetnetSampleBuilder(), 4, device="cpu", **kw))
    assert len(got) == len(want) == (2 if drop else 3)
    for a, b in zip(want, got):
        assert b["img"].device.type == "cpu"
        assert_same(a, b, TAIL_LIMIT)


def test_iterator_needs_a_card_unless_asked_for_the_cpu():
    ds = tds.SyntheticPoseDataset(n=2, side=64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(tds.detnet_batch_iterator(ds, tds.DetnetSampleBuilder(), 2))


def test_synthetic_batch_without_cv2(tmp_path):
    """In a process where importing cv2 fails, the builder makes a train
    batch and the trainer runs one step, saves and exports."""
    script = textwrap.dedent(f"""
        import builtins, sys
        real = builtins.__import__
        def guard(name, *a, **k):
            if name == "cv2" or name.startswith("cv2."):
                raise ImportError("no cv2 here")
            return real(name, *a, **k)
        builtins.__import__ = guard
        sys.path.insert(0, {REPO!r})
        from simhand_tpu_torch.finetune import datasets as d, train
        b = next(d.detnet_batch_iterator(d.SyntheticPoseDataset(n=4, side=96),
                                         d.DetnetSampleBuilder(), 4, device="cpu"))
        assert b["img"].shape == (4, 128, 128, 3), b["img"].shape
        train.main(["--dataset", "synthetic", "--backbone", "18", "--batch_size", "32",
                    "--epochs", "2", "--eval_every", "5", "--max_steps", "1",
                    "--device", "cpu", "--out_dir", {str(tmp_path / "run")!r}])
        assert "cv2" not in sys.modules
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]
