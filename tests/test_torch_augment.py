"""The port's augmentation on the card's path (``simhand_tpu_torch.data.augment``)
and the augmented train step against the JAX package on the CPU.

PyTorch's random streams cannot match ``jax.random``, so the JAX draws are
re-derived here from the JAX function's key exactly as
``simhand_tpu/data/augment.py:262-351`` draws them (``split(key, 12)``, the
sub-splits, ``bernoulli``, ``uniform``, ``randint``, ``normal``) and fed to
the port's applying half, then compared with JAX's ``device_augment`` on
that key.

Tolerances, on the 0-255 scale before normalisation (the images compared
are normalised, so each is divided by 255 * min(std) = 51.0 there):
- the elementwise ops (HSV pair, colour jitter, grayscale, sobel, cut-out,
  noise) and the blur: 1e-3 (TOL);
- the warp, and the whole chain that contains it: 0.05 (WARP_TOL). The
  warp's source coordinates differ by float32 rounding (the rotation's
  cosine and sine, which the port takes through float64; XLA may contract
  a * x + b into one FMA where PyTorch's eager ops round each product).
  A coordinate 1.5e-5 px off moves a bilinear sample between random uint8
  neighbours up to 255 apart by ~4e-3 per axis; measured at most 0.019
  over the chain's cases below;
- the whole chain: WARP_TOL on all but CHAIN_SHARE of the image elements
  (the noise's wrap modulo 256 and its clip at 0, where a value a rounding
  away from an integer lands 256 or 1 apart; measured share 7.6e-6 with
  every flag on, 0 with the main path's), the crop
  box (``origin``, ``side``, recorded jitter) and the angle exactly, the
  joints within 1e-3 px (measured 1.5e-5)."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simhand_tpu.core import geometry as jgeo
from simhand_tpu.data import augment as jaug
from simhand_tpu.data.augment_cv2 import AugmentFlags as JFlags
from simhand_tpu.data.augment_cv2 import AugmentParams as JParams
from simhand_tpu_torch.data import augment as taug
from simhand_tpu_torch.data.augment_cv2 import AugmentFlags, AugmentParams

torch.set_num_threads(2)
TOL = 1e-3                      # on the 0-255 scale
WARP_TOL = 0.05
CHAIN_SHARE = 1e-4              # share of the chain's image elements past WARP_TOL
NORM = 255.0 * min(taug.IMAGENET_STD)
MAIN = dict(crop=True, resize=True, rotate=True)
ALL = dict(color_drop=True, color_jitter=True, crop=True, cut_out=True, gaussian_blur=True,
           random_crop=True, resize=True, rotate=True, gaussian_noise=True,
           sobel_filter=True)


def jflags(kw):
    return JFlags(**kw)


def hands(rng, b, side):
    """(b, 21, 3) pixel-space hands: a wrist and five fingers of 4 joints,
    depth 1 (the cache sources' pseudo depth)."""
    wrist = rng.uniform(0.35, 0.65, (b, 1, 2))
    ang = rng.uniform(-np.pi, np.pi, (b, 5))
    seg = np.arange(1, 5)
    tips = wrist[:, :, None, :] + 0.08 * seg[None, None, :, None] * np.stack(
        [np.cos(ang), np.sin(ang)], -1)[:, :, None, :]           # (b, 5, 4, 2)
    j = np.concatenate([wrist, tips.transpose(0, 2, 1, 3).reshape(b, 20, 2)], 1)
    j = np.clip(j, 0.02, 0.98) * side
    return np.concatenate([j, np.ones((b, 21, 1))], -1).astype(np.float32)


def jax_draws(key, b, side, flags, params, out_size):
    """The draws of ``simhand_tpu.data.augment.device_augment`` on ``key``,
    re-derived in its order, as the port's AugmentDraws (numpy -> torch)."""
    keys = jax.random.split(key, 12)

    def coin(k):
        return jax.random.bernoulli(k, 0.5, (b,))

    d = {}
    if flags.sobel_filter:
        d["sobel"] = coin(keys[0])
    if flags.cut_out:
        k1, k2, k3 = jax.random.split(keys[1], 3)
        d["cut_ratio"] = jax.random.uniform(k1, (b,), minval=params.cut_out_fraction[0],
                                            maxval=params.cut_out_fraction[1])
        d["cut_joint"] = jax.random.randint(k2, (b,), 0, 20)
        d["cut_fill"] = jax.random.randint(k3, (b,), 0, 255).astype(jnp.float32)
        d["cut"] = coin(keys[2])
    if flags.gaussian_blur:
        d["blur_sigma"] = jax.random.uniform(keys[3], (b,), minval=0.1, maxval=2.0)
        d["blur"] = coin(keys[4])
    if flags.rotate:
        d["angle"] = jax.random.uniform(keys[5], (b,), minval=params.min_angle,
                                        maxval=params.max_angle)
    if flags.crop:
        d["jitter"] = jax.random.uniform(keys[6], (b, 2), minval=0.0,
                                         maxval=params.crop_box_jitter[1])
    if flags.random_crop:
        d["margin"] = jax.random.uniform(keys[7], (b,), minval=params.crop_margin_range[0],
                                         maxval=params.crop_margin_range[1])
    if flags.color_jitter:
        ck = jax.random.split(keys[8], 4)
        for k, name, rng in zip(ck, ("hue", "sat", "alpha", "beta"),
                                (params.hue_factor_range, params.sat_factor_range,
                                 params.value_factor_alpha_range,
                                 params.value_factor_beta_range)):
            d[name] = jax.random.uniform(k, (b,), minval=rng[0], maxval=rng[1])
    if flags.gaussian_noise:
        nk, ck = jax.random.split(keys[10])
        d["noise"] = jax.random.normal(nk, (b, out_size, out_size, 3))
        d["noisy"] = coin(ck)
    if flags.color_drop:
        d["drop"] = coin(keys[11])
    return taug.AugmentDraws(**{k: torch.from_numpy(np.array(v)) for k, v in d.items()})


def close_share(got, want, tol):
    """Share of elements of got further than tol from want."""
    return float((np.abs(np.asarray(got) - np.asarray(want)) > tol).mean())


# --------------------------------------------------------------------------
# each op
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, (6, 64, 64, 3)).astype(np.float32)


def test_affine_warp_matches(images):
    rng = np.random.default_rng(1)
    ang = rng.uniform(-45, 45, 6).astype(np.float32)
    rad = np.deg2rad(ang)
    scale = rng.uniform(0.4, 1.5, (6, 2, 1))
    mats = np.concatenate([np.stack([np.stack([np.cos(rad), np.sin(rad)], -1),
                                     np.stack([-np.sin(rad), np.cos(rad)], -1)], 1),
                           rng.uniform(-20, 20, (6, 2, 1))], -1) * scale
    mats = mats.astype(np.float32)
    want = np.asarray(jaug.affine_warp(jnp.asarray(images), jnp.asarray(mats), (48, 40)))
    got = taug.affine_warp(torch.from_numpy(images), torch.from_numpy(mats), (48, 40))
    np.testing.assert_allclose(got.numpy(), want, atol=WARP_TOL, rtol=0)
    # uint8 images are gathered as they are: the same values
    got8 = taug.affine_warp(torch.from_numpy(images.astype(np.uint8)), torch.from_numpy(mats),
                            (48, 40))
    assert torch.equal(got8, got)


def test_hsv_pair_and_color_jitter_match(images):
    x, tx = jnp.asarray(images), torch.from_numpy(images)
    hsv = np.array(jaug.rgb_to_hsv_cv2(x))
    np.testing.assert_allclose(taug.rgb_to_hsv_cv2(tx).numpy(), hsv, atol=TOL, rtol=0)
    np.testing.assert_allclose(taug.hsv_to_rgb_cv2(torch.from_numpy(hsv)).numpy(),
                               np.asarray(jaug.hsv_to_rgb_cv2(jnp.asarray(hsv))),
                               atol=TOL, rtol=0)
    rng = np.random.default_rng(2)
    f = [rng.uniform(lo, hi, 6).astype(np.float32)
         for lo, hi in ((0.01, 1.0), (0.01, 1.0), (0.5, 1.0), (5.0, 20.0))]
    want = np.asarray(jaug.color_jitter(x, *map(jnp.asarray, f)))
    got = taug.color_jitter(tx, *map(torch.from_numpy, f)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_grayscale_and_sobel_match(images):
    x, tx = jnp.asarray(images), torch.from_numpy(images)
    np.testing.assert_allclose(taug.grayscale_cv2_on_rgb(tx).numpy(),
                               np.asarray(jaug.grayscale_cv2_on_rgb(x)), atol=TOL, rtol=0)
    # sums of up to 8 terms of size ~255 * 2 in another order: a few ulps
    np.testing.assert_allclose(taug.sobel_filter(tx).numpy(),
                               np.asarray(jaug.sobel_filter(x)), atol=TOL, rtol=0)


def test_gaussian_blur_matches(images):
    sigma = np.random.default_rng(3).uniform(0.1, 2.0, 6).astype(np.float32)
    k = taug.blur_ksize(64)
    assert k == 7 and taug.blur_ksize(224) == 23
    want = np.asarray(jaug.gaussian_blur(jnp.asarray(images), jnp.asarray(sigma), k))
    got = taug.gaussian_blur(torch.from_numpy(images), torch.from_numpy(sigma), k).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_cut_out_and_noise_match_on_jaxs_draws(images):
    """cut_out and gaussian_noise fed the draws that JAX's own keys give."""
    b, side = images.shape[:2]
    joints = hands(np.random.default_rng(4), b, side)
    key = jax.random.key(5)
    k1, k2, k3 = jax.random.split(key, 3)
    ratio = jax.random.uniform(k1, (b,), minval=0.0, maxval=0.5)
    joint = jax.random.randint(k2, (b,), 0, 20)
    fill = jax.random.randint(k3, (b,), 0, 255).astype(jnp.float32)
    want = np.asarray(jaug.cut_out(jnp.asarray(images), jnp.asarray(joints[..., :2]), key,
                                   (0.0, 0.5)))
    got = taug.cut_out(torch.from_numpy(images), torch.from_numpy(joints[..., :2]),
                       *(torch.from_numpy(np.array(v)) for v in (ratio, joint, fill)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != images).any()

    nk = jax.random.key(6)
    noise = np.array(jax.random.normal(nk, images.shape))
    want = np.asarray(jaug.gaussian_noise(jnp.asarray(images), nk, 25.0))
    got = taug.gaussian_noise(torch.from_numpy(images), torch.from_numpy(noise), 25.0).numpy()
    # integer-valued results of one multiply, a clip, a round and a mod:
    # equal unless a product lands within rounding of a .5
    share = close_share(got, want, TOL)
    print(f"gaussian_noise: {share:.2e} of elements past {TOL}")
    assert share <= CHAIN_SHARE
    assert (want < images).any()        # some values wrapped past 255


# --------------------------------------------------------------------------
# the whole chain
# --------------------------------------------------------------------------

def raw_views(b, side=224, seed=7):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (b, side, side, 3), dtype=np.uint8), hands(rng, b, side)


@partial(jax.jit, static_argnames=("flags", "params", "out_size", "hw"))
def jax_warp_box(j, draws, flags, params, out_size, hw):
    """The crop box of simhand_tpu.data.augment.device_augment (:285-333),
    its lines as they are: (angle, origin, side, recorded jitter)."""
    b = j.shape[0]
    angle = jnp.floor(draws["angle"]) if flags.rotate else jnp.zeros((b,), jnp.float32)
    center = jnp.trunc(jnp.mean(j[..., :2], axis=1))
    rot = jgeo.opencv_rotation_matrix(center[:, 0], center[:, 1], angle)
    j_rot = jgeo.apply_affine_2d(j[..., :2], rot)
    jitter = jnp.trunc(draws["jitter"]) if flags.crop else jnp.zeros((b, 2))
    margin = draws["margin"] if flags.random_crop else jnp.full((b,), params.crop_margin)
    origin, side, rec_jitter = jgeo.crop_box_from_joints(j_rot, margin, jitter)
    return angle, origin, jnp.maximum(side, 1.0), rec_jitter


@pytest.mark.parametrize("which", ["main", "all"])
def test_device_augment_matches_on_jaxs_draws(which):
    """apply_augment on the draws of JAX's key against JAX's device_augment
    at 224 -> 128, B = 8 a view, over 4 keys: the crop box and the angle
    exactly, the recorded jitter exactly, the joints within 1e-3 px, the
    images within WARP_TOL on all but CHAIN_SHARE of their elements."""
    b, out = 8, 128
    kw = MAIN if which == "main" else ALL
    flags, params = AugmentFlags(**kw), AugmentParams()
    shares = []
    for seed in range(3):
        imgs, joints = raw_views(b, seed=seed)
        key = jax.random.key(11 + seed)
        draws = jax_draws(key, b, 224, flags, params, out)
        got = taug.apply_augment(torch.from_numpy(imgs), torch.from_numpy(joints), draws,
                                 flags, params, out)
        want = jaug.device_augment(jnp.asarray(imgs), jnp.asarray(joints), key, jflags(kw),
                                   JParams(), out)
        box = taug.warp_box(torch.from_numpy(joints), draws, flags, params, (224, 224), out)
        jdraws = {k: jnp.asarray(v.numpy()) for k, v in draws._asdict().items()
                  if k in ("angle", "jitter", "margin") and v is not None}
        wangle, worigin, wside, wjitter = jax_warp_box(jnp.asarray(joints), jdraws,
                                                       jflags(kw), JParams(), out, (224, 224))
        np.testing.assert_array_equal(box.origin.numpy(), np.asarray(worigin))
        np.testing.assert_array_equal(box.side.numpy(), np.asarray(wside))
        np.testing.assert_array_equal(box.jitter.numpy(), np.asarray(wjitter))
        np.testing.assert_array_equal(got.angle.numpy(), np.asarray(want.angle))
        np.testing.assert_array_equal(got.jitter_x.numpy(), np.asarray(want.jitter_x))
        np.testing.assert_array_equal(got.jitter_y.numpy(), np.asarray(want.jitter_y))
        np.testing.assert_allclose(got.joints.numpy(), np.asarray(want.joints), atol=1e-3,
                                   rtol=0)
        shares.append(close_share(got.images, want.images, WARP_TOL / NORM))
    print(f"device_augment[{which}]: {max(shares):.2e} of image elements past {WARP_TOL} "
          f"(allowed {CHAIN_SHARE})")
    assert max(shares) <= CHAIN_SHARE


# --------------------------------------------------------------------------
# both views, the step, the port's own draws
# --------------------------------------------------------------------------

def raw_batch(b, side, seed):
    """A raw pair batch: uint8 crops, pixel joints, normalised joints."""
    i1, j1 = raw_views(b, side, seed)
    i2, j2 = raw_views(b, side, seed + 100)
    return {"image1": i1, "image2": i2, "joints1": j1, "joints2": j2,
            "joints_raw1": j1 / side, "joints_raw2": j2 / side}


def jax_view_draws(key, raw, flags, params, out_size):
    """Both views' draws as simhand_tpu.data.augment.prepare_views splits
    its key (k1, k2)."""
    b, side = raw["image1"].shape[:2]
    return tuple(jax_draws(k, b, side, flags, params, out_size)
                 for k in jax.random.split(key))


def inject(monkeypatch, draws_by_call):
    """Makes the port's prepare_views take the given draws, one pair a call."""
    calls = iter(draws_by_call)
    monkeypatch.setattr(taug, "sample_views", lambda *a, **k: next(calls))


def assert_views_match(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k].numpy()
        if k.startswith("transformed"):
            np.testing.assert_allclose(g, w, atol=WARP_TOL / NORM, rtol=0, err_msg=k)
        elif "joints" in k:
            np.testing.assert_allclose(g, w, atol=1e-3, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("which", ["main", "all"])
def test_prepare_views_matches_on_jaxs_draws(monkeypatch, which):
    kw = MAIN if which == "main" else ALL
    flags, params = AugmentFlags(**kw), AugmentParams()
    raw = raw_batch(4, 64, 1)
    key = jax.random.key(3)
    inject(monkeypatch, [jax_view_draws(key, raw, flags, params, 32)])
    got = taug.prepare_views({k: torch.from_numpy(v) for k, v in raw.items()},
                             torch.Generator().manual_seed(0), flags, params, 32)
    want = jaug.prepare_views({k: jnp.asarray(v) for k, v in raw.items()}, key, jflags(kw),
                              JParams(), 32)
    assert_views_match(got, {k: np.asarray(v) for k, v in want.items()})


def test_augmented_train_step_matches(monkeypatch):
    """JAX's step with augment= (ResNet-18, 64 -> 32, B = 8 pairs, the dense
    route, float32; keys fold_in(key(0), step)) against the port's on the
    same raw batch and weights, the draws of JAX's keys injected through
    prepare_views' applying half. Two steps (the first at learning rate 0),
    then one eval step; the losses and the updated parameters within
    tests/test_torch_train_step.py's tolerances for the dense B = 8 step."""
    from simhand_tpu.models import ContrastiveModel as JModel
    from simhand_tpu.models.contrastive import ContrastiveConfig as JConfig
    from simhand_tpu.train import OptimizerConfig as JOpt
    from simhand_tpu.train import make_eval_step as jeval
    from simhand_tpu.train import make_train_step as jstep
    from simhand_tpu.train.loop import EVAL_AUGMENT_SEED as JEVAL_SEED
    from simhand_tpu.train.optimizer import make_optimizer
    from simhand_tpu.train.state import TrainState
    from simhand_tpu_torch.convert import from_flax_variables
    from simhand_tpu_torch.models import ContrastiveConfig as TConfig
    from simhand_tpu_torch.models import ContrastiveModel as TModel
    from simhand_tpu_torch.train import OptimizerConfig as TOpt
    from simhand_tpu_torch.train import create_train_state as tcreate
    from simhand_tpu_torch.train import make_eval_step as teval
    from simhand_tpu_torch.train import make_schedule as tschedule
    from simhand_tpu_torch.train import make_train_step as tstep
    from simhand_tpu_torch.train.loop import EVAL_AUGMENT_SEED
    from test_torch_train_step import OPT, assert_states_match, to_numpy

    assert EVAL_AUGMENT_SEED == JEVAL_SEED
    out, steps = 32, 2
    cfg = dict(experiment_type="simhand_w", augmentation=("crop", "rotate", "resize"),
               image_side=float(out))
    flags, params = AugmentFlags(**MAIN), AugmentParams()
    augment = (jflags(MAIN), JParams(), out)
    raw = raw_batch(8, 64, 2)

    jm = JModel(resnet_size="18")
    # create_train_state's lines with a jitted init (a third of its time)
    variables = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((2, out, out, 3)))
    jstate = TrainState.create(apply_fn=jm.apply, params=variables["params"],
                               tx=make_optimizer(JOpt(**OPT), variables["params"]),
                               batch_stats=variables["batch_stats"])
    init = from_flax_variables(to_numpy(jstate.params), to_numpy(jstate.batch_stats))
    jraw = {k: jnp.asarray(v) for k, v in raw.items()}
    step, jlosses = jstep(jm, JConfig(**cfg), augment=augment), []
    for _ in range(steps):
        jstate, metrics = step(jstate, jraw)
        jlosses.append(float(metrics["contrastive_loss"]))
    jeval_loss = float(jeval(jm, JConfig(**cfg), augment=augment)(jstate, jraw)
                       ["contrastive_loss"])
    want = from_flax_variables(to_numpy(jstate.params), to_numpy(jstate.batch_stats))

    keys = [jax.random.fold_in(jax.random.key(0), s) for s in range(steps)]
    keys.append(jax.random.key(EVAL_AUGMENT_SEED))
    inject(monkeypatch, [jax_view_draws(k, raw, flags, params, out) for k in keys])
    tm = TModel("18")
    tstate = tcreate(tm, TOpt(**OPT), 0, input_shape=(2, out, out, 3), device="cpu")
    tm.load_state_dict(init, strict=True)
    traw = {k: torch.from_numpy(v) for k, v in raw.items()}
    step, tlosses = tstep(tm, TConfig(**cfg), augment=(flags, params, out)), []
    for _ in range(steps):
        tstate, metrics = step(tstate, traw)
        tlosses.append(metrics["contrastive_loss"].item())
    teval_loss = teval(tm, TConfig(**cfg), augment=(flags, params, out))(
        tstate, traw)["contrastive_loss"].item()

    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert teval_loss == pytest.approx(jeval_loss, rel=5e-4)
    lrs = [tschedule(TOpt(**OPT))(i) for i in range(steps)]
    assert_states_match(init, want, tm.state_dict(), lrs, update_rtol=0.25, stats_rtol=3e-2,
                        bn_too=False)


def test_the_ports_draws_follow_the_step():
    """The train step's views come from (0, step): the same step gives the
    same views, another step others; the eval step's from EVAL_AUGMENT_SEED,
    the same at every call."""
    from simhand_tpu_torch.models import ContrastiveConfig as TConfig
    from simhand_tpu_torch.models import ContrastiveModel as TModel
    from simhand_tpu_torch.train import OptimizerConfig as TOpt
    from simhand_tpu_torch.train import create_train_state as tcreate
    from simhand_tpu_torch.train import make_eval_step as teval
    from simhand_tpu_torch.train.loop import EVAL_AUGMENT_SEED, _augmented

    flags, params = AugmentFlags(**ALL), AugmentParams()
    augment = (flags, params, 32)
    raw = {k: torch.from_numpy(v) for k, v in raw_batch(4, 64, 3).items()}

    def views(*key):
        return _augmented(raw, augment, *key)

    a, b, c = views(0, 5), views(0, 5), views(0, 6)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["transformed_image1"], c["transformed_image1"])
    assert not torch.equal(a["transformed_image1"], a["transformed_image2"])
    e1, e2 = views(EVAL_AUGMENT_SEED), views(EVAL_AUGMENT_SEED)
    assert torch.equal(e1["transformed_image1"], e2["transformed_image1"])
    assert not torch.equal(e1["transformed_image1"], a["transformed_image1"])

    model = TModel("18")
    state = tcreate(model, TOpt(), 0, input_shape=(2, 32, 32, 3), device="cpu")
    cfg = TConfig(experiment_type="simhand_w", augmentation=("crop", "rotate", "resize"),
                  image_side=32.0)
    ev = teval(model, cfg, augment=augment)
    assert ev(state, raw)["contrastive_loss"].item() == ev(state, raw)["contrastive_loss"].item()
