"""The port's supervised 2.5D losses (``simhand_tpu_torch.losses.supervised``),
its plots (``utils/plots.py``, ``finetune/plot.py``) and
``experiments/model_tester.py`` against the JAX package on the CPU.

The losses take the same seeded inputs in both packages. The plots render
on matplotlib's Agg backend: each function's figure has JAX's axes count
and size, and its PNG render equals JAX's pixel for pixel (the same
matplotlib calls on the same data).
"""
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simhand_tpu.experiments.model_tester as jtester
from simhand_tpu.core.geometry import convert_to_2_5d
from simhand_tpu.finetune import plot as jplot
from simhand_tpu.losses import supervised as jsup
from simhand_tpu.models import ContrastiveModel as JModel
from simhand_tpu.utils import plots as jplots
from simhand_tpu_torch import losses as tlosses
from simhand_tpu_torch.experiments import model_tester as ttester
from simhand_tpu_torch.finetune import plot as tplot
from simhand_tpu_torch.utils import plots as tplots

matplotlib = pytest.importorskip("matplotlib")
torch.set_num_threads(2)
B = 6


def _inputs(seed: int = 0):
    """A batch of hands in camera space (m), their 2.5D joints and a noisy
    prediction of them, the intrinsics, and a validity mask with gaps."""
    rng = np.random.default_rng(seed)
    j3d = (rng.normal(size=(B, 21, 3)) * 0.03 + [0.0, 0.0, 0.5]).astype(np.float32)
    K = np.tile(np.array([[480.0, 0, 64], [0, 480.0, 64], [0, 0, 1]], np.float32), (B, 1, 1))
    K[:, :2, :2] *= rng.uniform(0.9, 1.1, (B, 1, 1)).astype(np.float32)
    gt25, scale = (np.array(a) for a in convert_to_2_5d(jnp.asarray(K), jnp.asarray(j3d)))
    pred25 = (gt25 + rng.normal(size=gt25.shape) * [2.0, 2.0, 0.05]).astype(np.float32)
    valid = (rng.uniform(size=(B, 21, 1)) > 0.2).astype(np.float32)
    z_root = (rng.uniform(8, 12, B)).astype(np.float32)
    return dict(pred=pred25, gt=gt25, j3d=j3d, K=K, scale=scale, valid=valid, z_root=z_root)


def _close(got, want, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), rtol=rtol, atol=0)


@pytest.mark.parametrize("with_valid", [True, False])
def test_supervised_losses_match_jax(with_valid):
    """l1_loss_25d's three terms, loss_3d (with and without an external
    root depth) and epe_metrics (3D and 2D) against JAX's, each to rel 1e-6;
    the port exports them from ``losses`` as JAX does."""
    d = _inputs()
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    valid = (d["valid"], t["valid"]) if with_valid else (None, None)
    want = jsup.l1_loss_25d(d["pred"], d["gt"], d["scale"], valid[0])
    got = tlosses.l1_loss_25d(t["pred"], t["gt"], t["scale"], valid[1])
    for g, w in zip(got, want):
        _close(g, w)
    v = d["valid"] if with_valid else np.ones_like(d["valid"])
    for z in (None, "z_root"):
        want = jsup.loss_3d(d["pred"], d["j3d"], d["scale"], d["K"], v,
                            None if z is None else d[z])
        got = tlosses.loss_3d(t["pred"], t["j3d"], t["scale"], t["K"], torch.from_numpy(v),
                              None if z is None else t[z])
        _close(got, want)
    for dim, prefix in ((3, "val"), (2, "train")):
        want = jsup.epe_metrics(d["pred"][..., :dim], d["gt"][..., :dim], prefix)
        got = tlosses.epe_metrics(t["pred"][..., :dim], t["gt"][..., :dim], prefix)
        assert got.keys() == want.keys()
        for k in want:
            _close(got[k], want[k])


def _png(fig):
    import matplotlib.pyplot as plt

    buf = io.BytesIO()
    fig.savefig(buf, format="png")
    plt.close(fig)
    buf.seek(0)
    return matplotlib.image.imread(buf)


def _same_figure(want, got):
    assert len(got.axes) == len(want.axes)
    assert tuple(got.get_size_inches()) == tuple(want.get_size_inches())
    np.testing.assert_array_equal(_png(got), _png(want))


def test_plots_match_jax(tmp_path):
    """plot_truth_vs_prediction (uint8 and ImageNet-normalized images),
    heatmaps_vis (its two saved PNGs; the modes the reference leaves out
    raise) and plot_pck_curve in both packages."""
    rng = np.random.default_rng(1)
    pred, true = rng.uniform(0, 64, (2, 21, 2))
    for img in (rng.integers(0, 255, (64, 64, 3), dtype=np.uint8),
                rng.normal(size=(64, 64, 3)).astype(np.float32)):
        _same_figure(jplots.plot_truth_vs_prediction(pred, true, img, "t"),
                     tplots.plot_truth_vs_prediction(pred, true, img, "t"))
    batch = {"transformed_image1": rng.uniform(0, 255, (1, 32, 32, 3)),
             "transformed_image2": rng.uniform(0, 1, (1, 32, 32, 3))}
    enc = rng.normal(size=(2, 8, 8))
    want = jplots.heatmaps_vis(3, batch, enc, str(tmp_path / "jax"))
    got = tplots.heatmaps_vis(3, batch, enc, str(tmp_path / "port"))
    assert [os.path.relpath(p, tmp_path / "port") for p in got] == \
        [os.path.relpath(p, tmp_path / "jax") for p in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(matplotlib.image.imread(g), matplotlib.image.imread(w))
    with pytest.raises(NotImplementedError, match="only 'IO'"):
        tplots.heatmaps_vis(3, batch, enc, str(tmp_path / "port"), vis_type="P")
    th = np.linspace(0, 50, 21)
    curve = np.sort(rng.uniform(0, 1, 21))
    _same_figure(jplots.plot_pck_curve(curve, th, "PCK 3D"),
                 tplots.plot_pck_curve(curve, th, "PCK 3D"))


def test_curve_plot_main_matches_jax(tmp_path):
    """finetune/plot.py over a trainer's npy logs (three loss curves, AUC and
    heatmap accuracy of two eval sets): load_curves equal, and main's
    figures equal pixel for pixel."""
    rng = np.random.default_rng(2)
    epochs = np.arange(1, 5, dtype=np.float64)
    for name in ("lossH", "lossD", "lossL"):
        np.save(tmp_path / f"{name}.npy", np.stack([epochs, rng.uniform(0, 1, 4)], 1))
    for name in ("auc_all", "acc_hm_all"):
        np.save(tmp_path / f"{name}.npy",
                {k: [[e, float(rng.uniform())] for e in epochs] for k in ("rhd", "stb")})
    want, got = jplot.load_curves(str(tmp_path)), tplot.load_curves(str(tmp_path))
    assert want[0].keys() == got[0].keys() and want[1] == got[1] and want[2] == got[2]
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k], want[0][k])
    w = jplot.main(["-p", str(tmp_path), "--out", str(tmp_path / "jax.png")])
    g = tplot.main(["-p", str(tmp_path), "--out", str(tmp_path / "port.png")])
    np.testing.assert_array_equal(matplotlib.image.imread(g), matplotlib.image.imread(w))


def test_model_tester_prints_jax_parameter_count(capsys, monkeypatch):
    """model_tester.main at ResNet-18 in both packages: the same total
    parameter count and the same sizes of the parameter leaves (flax's
    layouts against torchvision's). JAX's init is traced for its shapes
    only (``jax.eval_shape``: the same tree, no arrays made)."""
    init = JModel.init
    trees = []

    def shapes(self, *a, **k):
        trees.append(jax.eval_shape(lambda *b: init(self, *b, **k), *a))
        return trees[-1]

    monkeypatch.setattr(JModel, "init", shapes)
    jtester.main(["--resnet_size", "18"])
    want = capsys.readouterr().out.splitlines()
    model = ttester.main(["--resnet_size", "18", "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want[0] == "experiment_type=peclr resnet18"
    assert got[-1] == want[-1] == "total parameters: 11,505,728"
    jsizes = sorted(leaf.size for leaf in jax.tree.leaves(trees[0]["params"]))
    assert sorted(p.numel() for p in model.parameters()) == jsizes


def test_model_tester_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttester.main(["--resnet_size", "18"])
