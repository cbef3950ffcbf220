"""The port's fine-tune benchmark readers (``simhand_tpu_torch.finetune.
benchmarks``) against the JAX package's, and ``finetune.evaluate.main``
on a 2D set and a tip-only set in both packages.

Each reader's layout is written by the JAX tests' own writers, imported and
not edited (``tests/test_benchmark_readers.py``, ``tests/test_joint_order.py``):
the JAX test function runs, asserting its readers' schema, and leaves its
layout under ``tmp_path``. Sets the JAX tests write no layout for
(CMU Panoptic 143, EgoDexter's 3D tips) get one here. Both packages' readers
then give the same samples bit for bit: every key, value and dtype (image,
K, joint, kp2d and the validity fields: vis, tip_only, tips_3d, center,
my_scale).
"""
import math
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import test_benchmark_readers as jreaders  # noqa: E402
import test_joint_order as jorder  # noqa: E402

import simhand_tpu.finetune.detnet as jdetnet  # noqa: E402
import simhand_tpu.finetune.evaluate as jevaluate  # noqa: E402
from simhand_tpu.data.sources import generate_synthetic_hand100m  # noqa: E402
from simhand_tpu.finetune import benchmarks as jb  # noqa: E402
from simhand_tpu.finetune import registry as jreg  # noqa: E402
from simhand_tpu_torch.finetune import benchmarks as tb  # noqa: E402
from simhand_tpu_torch.finetune import evaluate as tevaluate  # noqa: E402
from simhand_tpu_torch.finetune import registry as treg  # noqa: E402
from simhand_tpu_torch.finetune.detnet import DetNet as TDetNet  # noqa: E402
from simhand_tpu_torch.finetune.train import init_detnet  # noqa: E402
from simhand_tpu_torch.train.checkpoint import export_state_dict  # noqa: E402

torch.set_num_threads(2)


def _canonical(write, name):
    """A test_joint_order writer of the canonical hand, into tmp/<name>."""
    def run(tmp):
        root = tmp / name
        os.makedirs(root, exist_ok=True)
        write(str(root), jorder.canonical_hand(), np.random.default_rng(0))
    return run


def _write_panoptic(tmp):
    """hand143_panopticdb: hands_v143_14817.json with 3 renders."""
    import json

    root = tmp / "hand143"
    (root / "imgs").mkdir(parents=True)
    rng = np.random.default_rng(5)
    anno = []
    for i in range(3):
        path = f"imgs/{i:08d}.jpg"
        cv2.imwrite(str(root / path), rng.integers(0, 255, (96, 80, 3), dtype=np.uint8))
        anno.append({"img_paths": path,
                     "joint_self": rng.uniform(0, 80, (21, 3)).round(3).tolist()})
    (root / "hands_v143_14817.json").write_text(json.dumps({"root": anno}))


def _write_egodexter_3d(tmp):
    """EgoDexter with (my_)annotation.txt_3D.txt: 3 frames of 5 tips in mm,
    one tip zeroed (invalid), one frame all zeros (skipped)."""
    root = tmp / "eo"
    seq = root / "data" / "Kitchen"
    (seq / "color").mkdir(parents=True)
    rng = np.random.default_rng(6)
    tips = np.stack([rng.uniform(-60, 60, (3, 5)), rng.uniform(-60, 60, (3, 5)),
                     rng.uniform(400, 700, (3, 5))], axis=-1)
    tips[0, 3] = 0.0
    tips[2] = 0.0
    lines = ["; ".join(", ".join(f"{v:.4f}" for v in tip) for tip in row) for row in tips]
    (seq / "annotation.txt_3D.txt").write_text("\n".join(lines) + "\n")
    for i in range(3):
        cv2.imwrite(str(seq / "color" / f"image_{i:05d}_color.png"),
                    rng.integers(0, 255, (480, 640, 3), dtype=np.uint8))


def _write_ego4d(tmp):
    generate_synthetic_hand100m(str(tmp / "h100m"), num_images=6, num_videos=2, side=64,
                                scale="smoke")


def _tip_only(tmp):
    jorder.test_tip_only_readers_use_freihand_tip_slots(tmp)


# id -> (writer of the layout under tmp, the root below tmp, the reader's
# name in both modules, its arguments after the root)
READERS = {
    "rhd-cache": (jreaders.test_rhd_reader, "rhd", "RHD", ("train",), {}),
    "rhd-official": (jreaders.test_rhd_reader_official_layout, "rhd", "RHD", ("train",), {}),
    "rhd-canonical": (_canonical(jorder._write_rhd, "rhd"), "rhd", "RHD", ("train",), {}),
    "dexycb-s1": (_canonical(jorder._write_dexycb, "dy"), "dy", "DexYCB", ("train",),
                  {"setup": "s1"}),
    "dexycb-s2": (_canonical(jorder._write_dexycb, "dy"), "dy", "DexYCB", ("train",),
                  {"setup": "s2"}),
    "stb": (jreaders.test_stb_reader, "stb", "STB", ("test",), {}),
    "stb-canonical": (_canonical(jorder._write_stb, "stb"), "stb", "STB", ("test",), {}),
    "ah-ego": (jreaders.test_assemblyhands_reader, "ah", "AssemblyHandsEgo", ("train",), {}),
    "ah-ego-uncropped": (_canonical(jorder._write_ah, "ah"), "ah", "AssemblyHandsEgo",
                         ("train",), {"crop": False}),
    "ah-exo": (jreaders.test_assemblyhands_exo_and_filters, "ah", "AssemblyHandsExo", ("val",),
               {}),
    "cmu": (jreaders.test_cmu_hand_labels_reader, "cmu", "CMUHandLabels", ("train",), {}),
    "hand143": (_write_panoptic, "hand143", "CMUPanoptic143", (), {}),
    "ganerated": (_canonical(jorder._write_ganerated, "gan"), "gan", "GANeratedHands", (), {}),
    "do-3d": (jreaders.test_dexter_object_color_frame_projection, "do", "DexterObject", (), {}),
    "do-2d": (_tip_only, "do", "DexterObject", (), {}),
    "eo-2d": (_tip_only, "eo", "EgoDexter", (), {}),
    "eo-3d": (_write_egodexter_3d, "eo", "EgoDexter", (), {}),
    "ego4d": (_write_ego4d, "h100m", "Ego4DHands2D", (), {"source": "100doh", "scale": "smoke"}),
}


def assert_samples_equal(want: dict, got: dict):
    assert want.keys() == got.keys()
    for k, w in want.items():
        g = got[k]
        if w is None:
            assert g is None, k
            continue
        assert type(g) is type(w), k
        np.testing.assert_array_equal(g, w, err_msg=k)
        assert np.asarray(g).dtype == np.asarray(w).dtype, k


@pytest.mark.parametrize("case", list(READERS))
def test_reader_matches_jax(case, tmp_path):
    """Every sample of the port's reader equals the JAX reader's bit for
    bit on the same layout (left hands mirrored as JAX mirrors them)."""
    write, sub, name, args, kw = READERS[case]
    write(tmp_path)
    root = str(tmp_path / sub)
    want_ds, got_ds = getattr(jb, name)(root, *args, **kw), getattr(tb, name)(root, *args, **kw)
    assert len(got_ds) == len(want_ds) > 0
    for i in range(len(want_ds)):
        assert_samples_equal(want_ds[i], got_ds[i])


def test_registry_builds_every_key(tmp_path):
    """get_dataset builds each of the 24 keys in both packages on a layout
    of its set (the registry's aliases included) with JAX's lengths, and
    the module constants agree."""
    for case in ("cmu", "hand143", "ganerated", "do-3d", "eo-3d", "ego4d", "stb"):
        READERS[case][0](tmp_path)
    _canonical(jorder._write_rhd, "rhd")(tmp_path)
    _canonical(jorder._write_dexycb, "dy")(tmp_path)
    _canonical(jorder._write_ah, "ah")(tmp_path)
    jreaders.test_assemblyhands_exo_and_filters(tmp_path / "exo")
    _canonical(jorder._write_freihand, "fh")(tmp_path)
    roots = {"freihand": "fh", "fh": "fh", "dexycb": "dy", "dy": "dy", "assemblyhands": "ah",
             "ah": "ah", "ah-ego": "ah", "ah-exo": "exo/ah", "stb": "stb", "rhd": "rhd",
             "cmu": "cmu", "hand_labels": "cmu", "hand143": "hand143", "panoptic": "hand143",
             "ganerated": "gan", "gan": "gan", "dexter_object": "do", "do": "do",
             "egodexter": "eo", "eo": "eo", "ego4d_hands": "h100m", "ego4d": "h100m"}
    split = {"stb": "test", "ah-exo": "val"}
    kw = {"ego4d": {"source": "100doh", "scale": "smoke"},
          "ego4d_hands": {"source": "100doh", "scale": "smoke"},
          "synthetic": {"n": 3}, "synthetic-hand": {"n": 3},
          "freihand": {"train_ratio": 1.0, "replicate": False},
          "fh": {"train_ratio": 1.0, "replicate": False}}
    assert treg.DATASET_KEYS == jreg.DATASET_KEYS and len(treg.DATASET_KEYS) == 24
    for key in treg.DATASET_KEYS:
        root = str(tmp_path / roots[key]) if key in roots else None
        args = (root, split.get(key, "train"))
        want = jreg.get_dataset(key, *args, **kw.get(key, {}))
        got = treg.get_dataset(key, *args, **kw.get(key, {}))
        assert type(got).__name__ == type(want).__name__ and len(got) == len(want) > 0, key
    assert tb.FINGERTIP_IDS == jb.FINGERTIP_IDS == tevaluate.FINGERTIP_IDS
    for const in ("RHD_TO_SNAP", "STB_TO_SNAP", "STB_SK_INTR", "DO_M_COLOR", "EO_M_COLOR"):
        np.testing.assert_array_equal(getattr(tb, const), getattr(jb, const))
    np.testing.assert_array_equal(tb._rodrigues_quat(tb.STB_SK_ROT_VEC),
                                  jb._rodrigues_quat(jb.STB_SK_ROT_VEC))


@pytest.mark.parametrize("case,key,split", [("cmu", "cmu", "train"), ("do-3d", "do", "test")])
def test_evaluate_main_matches_jax_on_2d_and_tip_sets(case, key, split, tmp_path):
    """finetune.evaluate.main in both packages over a 2D set (CMU hand
    labels: pixel PCK and EPE) and a tip-only set (Dexter+Object with its
    3D tips: tip-slot pixel PCK and the masked-tip metric EPE and AUC) from
    one random ResNet-18 detnet (.pth). Both forwards run in float32 so
    that the heatmaps' argmax is not decided by bf16 rounding. The images
    reach the two networks through the builders' warps, equal within their
    stated limits (tests/test_torch_finetune_data.py), not bit for bit: the
    argmax metrics (pixel EPE, PCK) equal JAX's, the metric tip EPE within
    rel 1e-4 (measured 7.0e-6) and its AUC equal. JAX's eager init is
    jitted (the .pth replaces what it makes)."""
    READERS[case][0](tmp_path)
    model = TDetNet("18", dtype=torch.float32)
    init_detnet(model, 0)
    pth = str(tmp_path / "detnet.pth")
    export_state_dict(model, pth)
    argv = ["--dataset", key, "--data_dir", str(tmp_path / READERS[case][1]), "--split", split,
            "--backbone", "18", "--batch_size", "4", "--pretrain", pth]
    mp = pytest.MonkeyPatch()
    devices, jnet, tnet = jax.devices, jdetnet.DetNet, tevaluate.DetNet
    mp.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])
    mp.setattr(jdetnet, "DetNet", lambda **k: jnet(**{**k, "dtype": jnp.float32}))
    mp.setattr(tevaluate, "DetNet", lambda **k: tnet(**{**k, "dtype": torch.float32}))
    init = jnet.init
    mp.setattr(jnet, "init", lambda self, *a: jax.jit(lambda *b: init(self, *b))(*a))
    try:
        want = jevaluate.main(argv)
        got = tevaluate.main(argv + ["--device", "cpu"])
    finally:
        mp.undo()
    assert got.keys() == want.keys() and got["batches"] == want["batches"] == 1
    for k, v in want.items():
        if k.startswith("epe_mm"):
            assert math.isclose(got[k], v, rel_tol=1e-4), (k, got[k], v)
        else:
            assert got[k] == v, (k, got[k], v)
