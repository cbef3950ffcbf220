"""The plain reference against the port at toy shapes on the CPU, in
float32, stage by stage: the feed's batches, the augmentation, the
network's blocks forward and backward, the loss with PeCLR's inverse
transform and its gradient, and one LARS-Adam update. (A whole toy network
is too ill-conditioned to compare: at 32^2 and 16 images a millionth moved
in its input moves its early BatchNorm gradients by percents.)"""
from __future__ import annotations

import os

import pytest
import torch

from perfbench.spec import load_module, load_spec
from perfbench.tests.toy import toy_root

torch.set_num_threads(min(4, os.cpu_count() or 1))


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = toy_root(str(tmp_path_factory.mktemp("toy")))
    spec = load_spec(root, "toy")
    cell = load_module(root, "drivers", "pretrain").Cell(
        spec, 11, torch.device("cpu"), os.path.join(root, "build", "perfbench"))
    cell.corpus = cell.generator.ensure_corpus(cell.traffic, cell.work_dir, cell.device)
    cell._build()
    yield cell, load_module(root, "reference", spec.config["reference"])
    cell.close_program()


def _aug(cell):
    from simhand_tpu_torch.data.augment_cv2 import AugmentFlags, AugmentParams

    ap = cell.cfg["augmentation_params"]
    params = AugmentParams(**{k: tuple(v) if isinstance(v, list) else v for k, v in ap.items()})
    flags = AugmentFlags(**cell.cfg["augmentation_flags"])
    return flags, params


def test_feed_and_augmentation(toy):
    from simhand_tpu_torch.data.augment import prepare_views, seeded_generator

    cell, ref = toy
    batch = next(cell.feed)
    raw = ref.raw_batches(cell.corpus, 11, 8, 1, "cpu")[0]
    for k, v in raw.items():
        assert torch.equal(v, batch[k]), k
    flags, params = _aug(cell)
    views = prepare_views(batch, seeded_generator(torch.device("cpu"), 0, 0), flags, params, 32)
    aug = {"flags": cell.cfg["augmentation_flags"], "params": cell.cfg["augmentation_params"]}
    draws = ref.augment_draws(0, 8, aug, torch.device("cpu"))
    for v in (1, 2):
        r = ref.augment_view(raw[f"image{v}"], raw[f"joints{v}"], draws[v - 1], aug, 32)
        assert torch.equal(views[f"transformed_image{v}"], r["image"])
        assert torch.equal(views[f"angle_{v}"], r["angle"])
        assert torch.equal(views[f"jitter_x_{v}"], r["jitter"][:, 0])
        assert torch.equal(views[f"jitter_y_{v}"], r["jitter"][:, 1])


def test_weights_fill_the_model(toy):
    cell, ref = toy
    w = ref.draw_weights(ref.param_spec(cell.cfg), 11, "cpu")
    own = cell.state.model.state_dict()
    for k, v in w.items():
        assert torch.equal(own[k], v), k
    assert torch.equal(w["encoder.conv1.weight"],
                       ref.draw_weights(ref.param_spec(cell.cfg), 11, "cpu")["encoder.conv1.weight"])
    conv = w["encoder.layer3.0.conv2.weight"]
    assert conv.std().item() == pytest.approx((1 / (256 * 9)) ** 0.5, rel=0.05)


@pytest.mark.parametrize("site,stride,first,cin,side", [
    ("encoder.layer1.0", 1, True, 64, 16), ("encoder.layer2.0", 2, True, 256, 16),
    ("encoder.layer3.2", 1, False, 1024, 8)])
def test_blocks_forward_and_backward(toy, site, stride, first, cin, side):
    cell, ref = toy
    model = cell.state.model
    model.train()
    block = model.get_submodule(site)
    params = {n: p.detach().clone().requires_grad_(True) for n, p in model.named_parameters()}
    net = ref.Net(cell.cfg, params)
    x = torch.relu(torch.randn(32, cin, side, side, generator=torch.Generator().manual_seed(3)))
    yp = block(x)
    yr = net.block(x, site, stride, first)
    assert (yp - yr).abs().max() <= 1e-5 * yr.abs().max()
    r = torch.randn_like(yp)
    names = [n for n, _ in model.named_parameters() if n.startswith(site + ".")]
    gp = torch.autograd.grad((yp * r).sum(), [model.get_parameter(n) for n in names])
    gr = torch.autograd.grad((yr * r).sum(), [params[n] for n in names])
    for n, a, b in zip(names, gp, gr):
        assert (a - b).norm() <= 1e-5 * b.norm() + 1e-12, n


def test_loss_and_its_gradient(toy):
    from simhand_tpu_torch.models.contrastive import (
        ContrastiveConfig,
        contrastive_loss_from_projections,
    )

    cell, ref = toy
    g = torch.Generator().manual_seed(5)
    b = 8
    proj = torch.randn(2 * b, 128, generator=g, requires_grad=True)
    jr = torch.rand(2, b, 21, 3, generator=g)
    batch = {"jitter_x_1": torch.randint(-10, 1, (b,), generator=g).float(),
             "jitter_x_2": torch.randint(-10, 1, (b,), generator=g).float(),
             "jitter_y_1": torch.randint(-10, 1, (b,), generator=g).float(),
             "jitter_y_2": torch.randint(-10, 1, (b,), generator=g).float(),
             "angle_1": torch.randint(-45, 45, (b,), generator=g).float(),
             "angle_2": torch.randint(-45, 45, (b,), generator=g).float(),
             "joints1_ori": jr[0] * 32, "joints2_ori": jr[1] * 32}
    ccfg = ContrastiveConfig(experiment_type="simhand_w",
                             augmentation=("color_jitter", "crop", "resize", "rotate"),
                             image_side=32.0, joints_type="original", use_pallas=False)
    lp, _ = contrastive_loss_from_projections(proj, batch, ccfg)
    z1, z2 = ref.inverse_transform(
        proj, torch.cat([batch["jitter_x_1"], batch["jitter_x_2"]]),
        torch.cat([batch["jitter_y_1"], batch["jitter_y_2"]]),
        torch.cat([batch["angle_1"], batch["angle_2"]]), 32.0)
    lr = ref.weighted_ntxent(z1, z2, jr[0, ..., :2] * 32, jr[1, ..., :2] * 32, 0.5)
    assert lp.item() == pytest.approx(lr.item(), rel=1e-6)
    gp, = torch.autograd.grad(lp, proj)
    gr, = torch.autograd.grad(lr, proj)
    assert (gp - gr).norm() <= 1e-5 * gr.norm()


def test_one_update(toy):
    from simhand_tpu_torch.train.optimizer import Optimizer, OptimizerConfig, decay_mask

    cell, ref = toy
    cfg = cell.cfg
    model = cell.state.model
    names = [n for n, _ in model.named_parameters()]
    g = torch.Generator().manual_seed(9)
    grads = [torch.randn(p.shape, generator=g) * 1e-3 for p in model.parameters()]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt_cfg = OptimizerConfig(lr=cfg["lr"], weight_decay=cfg["opt_weight_decay"],
                              warmup_epochs=cfg["warmup_epochs"], epochs=cfg["epochs"],
                              train_iters_per_epoch=cfg["train_iters_per_epoch"],
                              lars_eta=cfg["lars_eta"])
    params = [p.detach().clone() for p in model.parameters()]
    Optimizer(opt_cfg, params, decay_mask(model)).step(params, grads)
    mine = {k: v.clone() for k, v in before.items()}
    decayed = {n: d for n, _, _, d in ref.param_spec(cfg)}
    opt = {"count": 0, "mu": {k: torch.zeros_like(v) for k, v in mine.items()},
           "nu": {k: torch.zeros_like(v) for k, v in mine.items()}}
    ref.lars_adam(mine, dict(zip(names, grads)), opt, cfg, decayed)
    for n, p in zip(names, params):
        # a few float32 ulps of the parameter; the update itself is ~lr
        assert (p - mine[n]).abs().max() <= 1e-6 * before[n].abs().max() + 1e-9, n
        assert (before[n] - mine[n]).abs().max() > 1e-4, n
