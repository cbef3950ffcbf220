"""The port's detnet (``simhand_tpu_torch.finetune.detnet``), its loss and
train step, and its ``.pth`` interop against the JAX package, float32 on
the CPU, ResNet-18 at 32x32 or 64x64 input (hm_res 8 / 16).

Weights are JAX's initial variables carried over by
``convert.detnet_from_flax_variables``, with the deconv kernels and every
BatchNorm's statistics redrawn from a seed: a symmetric kernel would hide a
wrong flip of the transposed convolutions' taps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from simhand_tpu.finetune import detloss as jloss
from simhand_tpu.finetune.detnet import DetNet as JDetNet
from simhand_tpu.finetune.torch_port_detnet import detnet_to_torch_state_dict
from simhand_tpu.finetune.train import make_detnet_train_step as jmake_step
from simhand_tpu.train.state import TrainState as JState
from simhand_tpu_torch.convert import detnet_from_flax_variables, load_detnet_state_dict
from simhand_tpu_torch.finetune import detloss as tloss
from simhand_tpu_torch.finetune.detnet import DetNet, pose_tile
from simhand_tpu_torch.finetune.train import make_detnet_train_step
from simhand_tpu_torch.train.optimizer import Adam, exponential_decay
from simhand_tpu_torch.train.state import TrainState

torch.set_num_threads(2)
B = 4


def randomized(variables, seed):
    """JAX's variables with random deconv kernels and BatchNorm statistics."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, jax.device_get(variables["params"]))
    stats = jax.tree.map(np.asarray, jax.device_get(variables["batch_stats"]))
    for i in range(3):
        k = params[f"deconv{i}"]["kernel"]
        params[f"deconv{i}"]["kernel"] = (rng.standard_normal(k.shape) / np.sqrt(
            k.shape[0] * k.shape[1] * k.shape[2])).astype(np.float32)

    def redraw(path, a):
        if path[-1].key == "mean":
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)

    stats = jax.tree_util.tree_map_with_path(redraw, stats)
    return {"params": params, "batch_stats": stats}


def port_model(variables, **kw):
    model = DetNet(**kw)
    model.load_state_dict(detnet_from_flax_variables(variables["params"],
                                                     variables["batch_stats"]), strict=True)
    return model


@pytest.fixture(scope="module")
def det64():
    model = JDetNet(resnet_size="18", hm_res=16)
    v = model.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)))
    return model, randomized(v, 1)


@pytest.fixture(scope="module")
def det32():
    model = JDetNet(resnet_size="18", hm_res=8)
    return model, jax.device_get(model.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3))))


def targets(rng, n, res, flag_3d):
    return {
        "hm": rng.uniform(0, 1, (n, res, res, 21)).astype(np.float32),
        "dm": rng.normal(0, 0.5, (n, res, res, 21, 3)).astype(np.float32),
        "lm": rng.normal(0, 0.5, (n, res, res, 21, 3)).astype(np.float32),
        "hm_veil": (rng.uniform(size=(n, 21)) > 0.2).astype(np.float32),
        "flag_3d": np.asarray(flag_3d, np.float32),
    }


def test_pose_tile_matches():
    """bf16 bit for bit; float32 within one ulp (XLA's linspace kernel and
    its reassociation are not reproduced)."""
    from simhand_tpu.finetune.detnet import pose_tile as jtile

    for res in (8, 32):
        want = np.asarray(jtile(2, res, jnp.bfloat16).astype(jnp.float32)).transpose(0, 3, 1, 2)
        np.testing.assert_array_equal(pose_tile(2, res, torch.bfloat16).float().numpy(), want)
        want = np.asarray(jtile(2, res, jnp.float32)).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(pose_tile(2, res).numpy(), want, rtol=0, atol=1.2e-7)


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches(det64, train):
    """Every output at B = 4, 64x64, float32. Eval: maps within 1e-6 of
    their largest; train mode (batch statistics over 4 samples amplify the
    sums' order): 1e-4. uv exactly, delta and xyz as the maps."""
    jm, v = det64
    x = np.random.default_rng(2).uniform(-0.5, 0.5, (B, 64, 64, 3)).astype(np.float32)
    model = port_model(v, resnet_size="18", hm_res=16)
    model.train(train)
    if train:
        want, _ = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = jm.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.keys() == want.keys()
    rtol = 1e-4 if train else 1e-6
    for k in ("h_map", "d_map", "l_map", "delta", "xyz"):
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=rtol * np.abs(w).max(),
                                   err_msg=k)
    np.testing.assert_array_equal(got["uv"].numpy(), np.asarray(want["uv"]))


def test_state_dict_matches_the_reference_export(det64):
    """Same keys as detnet_to_torch_state_dict (the port's adds only
    num_batches_tracked), equal values; the JAX-written dict strict-loads."""
    _, v = det64
    model = port_model(v, resnet_size="18", hm_res=16)
    ref = detnet_to_torch_state_dict(v["params"], v["batch_stats"])
    mine = {k: t for k, t in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert mine.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(mine[k].numpy(), np.asarray(ref[k]), err_msg=k)
    fresh = DetNet(resnet_size="18", hm_res=16)
    load_detnet_state_dict(fresh, {k: torch.from_numpy(np.array(a)) for k, a in ref.items()})
    for k, t in fresh.state_dict().items():
        assert torch.equal(t, model.state_dict()[k]), k


def test_jax_written_pth_strict_loads(det64, tmp_path):
    """The file the JAX trainer writes (torch.save of
    detnet_to_torch_state_dict, no num_batches_tracked) loads strictly, also
    under the alternate ``encoder.`` prefix, and gives the JAX eval forward."""
    jm, v = det64
    ref = detnet_to_torch_state_dict(v["params"], v["batch_stats"])
    path = tmp_path / "detnet.pth"
    torch.save({k: torch.from_numpy(np.ascontiguousarray(a).copy()) for k, a in ref.items()}, path)
    x = np.random.default_rng(3).uniform(-0.5, 0.5, (2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False)["xyz"])
    for sd in (torch.load(path, weights_only=True),
               {k.replace("encoder.resnet.", "encoder."): t
                for k, t in torch.load(path, weights_only=True).items()}):
        model = DetNet(resnet_size="18", hm_res=16)
        load_detnet_state_dict(model, sd)
        with torch.no_grad():
            got = model.eval()(torch.from_numpy(x))["xyz"].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def loss_inputs(seed, flag_3d):
    rng = np.random.default_rng(seed)
    n, res = len(flag_3d), 8
    preds = {"h_map": rng.uniform(0, 1, (n, res, res, 21)).astype(np.float32),
             "d_map": rng.normal(0, 0.5, (n, res, res, 21, 3)).astype(np.float32),
             "l_map": rng.normal(0, 0.5, (n, res, res, 21, 3)).astype(np.float32)}
    return preds, targets(rng, n, res, flag_3d)


def both_losses(preds, tg):
    keys = ("hm", "dm", "lm", "hm_veil", "flag_3d")

    def jfn(p):
        return jloss.det_loss(p, *(jnp.asarray(tg[k]) for k in keys))

    (jtotal, jparts), jgrad = jax.value_and_grad(jfn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in preds.items()})
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in preds.items()}
    ttotal, tparts = tloss.det_loss(tp, *(torch.from_numpy(tg[k]) for k in keys))
    tgrad = torch.autograd.grad(ttotal, list(tp.values()))
    return (jparts, jgrad), (tparts, dict(zip(tp, tgrad)))


def test_det_loss_and_gradients_match_on_a_mixed_batch():
    """2 of 4 samples 3D: every part within rel 1e-5, the gradients within
    1e-5 of their largest (float32, the same arithmetic, sums' order)."""
    (jparts, jgrad), (tparts, tgrad) = both_losses(*loss_inputs(4, [1, 0, 1, 0]))
    for k in jparts:
        np.testing.assert_allclose(float(tparts[k].detach()), float(jparts[k]), rtol=1e-5,
                                   err_msg=k)
    for k in jgrad:
        w = np.asarray(jgrad[k])
        assert np.isfinite(w).all()
        np.testing.assert_allclose(tgrad[k].numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_all_2d_batch_gives_nan_gradients_in_both_packages():
    """The reference's fault, kept: with flag_3d 0 everywhere the sqrt of an
    exact 0 makes NaN gradients for d_map and l_map in both packages; the
    heatmap's stays finite and the loss itself is finite."""
    (jparts, jgrad), (tparts, tgrad) = both_losses(*loss_inputs(5, [0, 0, 0]))
    for k in ("d_map", "l_map"):
        assert np.isnan(np.asarray(jgrad[k])).all() and torch.isnan(tgrad[k]).all(), k
    assert np.isfinite(np.asarray(jgrad["h_map"])).all() and torch.isfinite(tgrad["h_map"]).all()
    assert np.isfinite(float(jparts["det_total"])) and torch.isfinite(tparts["det_total"]).item()


BN_VARIANTS = {"exact": {}, "stop_grad": {"bn_stop_gradient_stats": True},
               "fused": {"bn_fused": True}, "fused_pallas": {"bn_fused": "pallas"}}
LR, LR_HEAD, STEPS = 1e-5, 1e-4, 3
STATS_TOL, PARAMS_TOL = 2e-2, 0.15


@pytest.mark.parametrize("variant,strategy", [
    ("exact", "ULR"), ("exact", "DLR"), ("stop_grad", "ULR"), ("stop_grad", "DLR"),
    ("fused", "ULR"), ("fused", "DLR"), ("fused_pallas", "ULR"), ("fused_pallas", "DLR")])
def test_three_train_steps_match(det32, variant, strategy):
    """3 float32 steps at B = 4, 32x32 (fused_pallas: the port's plain
    reduces on the CPU, JAX's Pallas kernel in interpret mode), Adam with
    the trainer's staircase schedule at lr 1e-5 (DLR heads 1e-4). Step 0's
    parts within rel 1e-5 (measured <= 7.2e-7). Adam's first updates are
    about lr * sign(g): where a gradient nearly cancels, the sums' order
    flips its sign, and train-mode BatchNorm over 4 samples of 1x1 layer4
    maps carries that on, so steps 1-2 are held to rel 1e-3 (measured <=
    2.1e-4); after 3 steps each BatchNorm statistic within 2e-2 of its
    largest change (measured <= 6.0e-3), every parameter within 2 * 3 * lr
    of JAX's, and the parameters' difference within 0.15 of the norm of
    JAX's update (measured <= 7.0e-2)."""
    jm0, v0 = det32
    kw = BN_VARIANTS[variant]
    jm = JDetNet(resnet_size="18", hm_res=8, **kw)
    rng = np.random.default_rng(6)
    batches = [dict(targets(rng, B, 8, [1, 1, 0, 1]),
                    img=rng.uniform(-0.5, 0.5, (B, 32, 32, 3)).astype(np.float32))
               for _ in range(STEPS)]

    def jsched(lr):
        return optax.exponential_decay(lr, 50, 0.1, staircase=True)

    if strategy == "DLR":
        labels = {k: jax.tree.map(lambda _: "encoder" if k == "encoder" else "head", p)
                  for k, p in v0["params"].items()}
        tx = optax.multi_transform({"encoder": optax.adam(jsched(LR)),
                                    "head": optax.adam(jsched(LR_HEAD))}, labels)
    else:
        tx = optax.adam(jsched(LR))
    jstate = JState.create(apply_fn=jm.apply, params=v0["params"], tx=tx,
                           batch_stats=v0["batch_stats"])
    jstep = jmake_step(jm)

    model = port_model(v0, resnet_size="18", hm_res=8, **kw)
    if strategy == "DLR":
        head = [p for n, p in model.named_parameters() if not n.startswith("encoder.")]
        groups = [(list(model.encoder.parameters()), exponential_decay(LR, 50, 0.1, True)),
                  (head, exponential_decay(LR_HEAD, 50, 0.1, True))]
    else:
        groups = [(list(model.parameters()), exponential_decay(LR, 50, 0.1, True))]
    state = TrainState(model, Adam(groups))
    step = make_detnet_train_step(model)
    for batch in batches:
        jstate, jparts = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, parts = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k in jparts:
            np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                       rtol=1e-5 if state.step == 1 else 1e-3, err_msg=k)
    assert state.step == STEPS and state.optimizer.count == STEPS

    want = detnet_from_flax_variables(jax.device_get(jstate.params),
                                      jax.device_get(jstate.batch_stats))
    start = detnet_from_flax_variables(v0["params"], v0["batch_stats"])
    got = model.state_dict()
    lr_of = {n: (LR_HEAD if strategy == "DLR" and not n.startswith("encoder.") else LR)
             for n in want}
    stats_err, diff_sq, update_sq = 0.0, 0.0, 0.0
    for k, w in want.items():
        g, w = got[k].numpy(), w.numpy()
        if k.endswith(("running_mean", "running_var")):
            stats_err = max(stats_err, np.abs(g - w).max() / np.abs(w - start[k].numpy()).max())
        elif not k.endswith("num_batches_tracked"):
            d = np.abs(g - w)
            assert d.max() <= 2 * STEPS * lr_of[k], (k, d.max())
            diff_sq += float((d ** 2).sum())
            update_sq += float(((w - start[k].numpy()) ** 2).sum())
    assert stats_err <= STATS_TOL and np.sqrt(diff_sq / update_sq) <= PARAMS_TOL
