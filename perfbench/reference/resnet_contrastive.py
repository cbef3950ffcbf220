"""The plain reference of similarity-weighted contrastive pre-training with a
bottleneck ResNet (SiMHand's ``simhand_w``: linear MPJPE weights on positives
and negatives), in plain PyTorch operations and float32.

It imports nothing of the program under test. From a configuration file, the
initial weights the benchmark draws and the corpus on disk it computes the
first steps of training: the feed's order, the augmentation of both views on
the card, the encoder with train-mode BatchNorm, the projection head, PeCLR's
inverse transform, the weighted NT-Xent loss and its gradient, the LARS trust
ratio, Adam, the learning rate, and the BatchNorm running statistics.

It follows the published model (torchvision's ResNet, SiMHand's losses and
pl_bolts' LARS) with the numerics this repository's packages state:
  * 'SAME' padding (a stride-2 3x3 convolution of an even input pads (0, 1));
  * BatchNorm's running statistics move as flax's do, with momentum 0.9 and
    the biased batch variance (torchvision takes the unbiased one);
  * the optimizer chain LARS -> Adam -> learning rate of the optax chain,
    with weight decay as L2 in the gradient except on biases and BatchNorm;
  * the augmentation's draws come from a generator seeded from (0, step) on
    the card, in the order of the packages' ``sample_augment``.

``compute="fp8"`` computes in float8 with a per-tensor scale where the
configuration computes in bf16: every convolution's and dense layer's input
and weight, and every activation the program keeps in its compute dtype (a
convolution's output, a BatchNorm's, a block's), rounded to e4m3 forward and
their gradients to e5m2 backward: the control, one precision below the
configuration's. ``compute="bf16"`` rounds the same values to bf16, the
configuration's own precision: a second witness of what rounding alone does.
``half_batch=True`` takes only the first half of each batch's pairs: a fault.
"""
from __future__ import annotations

import json
import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_MOMENTUM, BN_EPS = 0.9, 1e-5
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
TRUNC_STD = 0.87962566103423978     # stddev of a unit normal truncated to [-2, 2]


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

def param_spec(cfg: dict) -> list[tuple[str, tuple, str, bool]]:
    """(name, shape, init, decayed) of every parameter and BatchNorm buffer,
    in torchvision's key layout under ``encoder.`` and ``projection_head.``.
    init: "lecun" (truncated normal, variance 1 / fan_in), "zeros", "ones";
    decayed: whether weight decay applies (buffers: False)."""
    spec = []

    def conv(name, cout, cin, k):
        spec.append((f"{name}.weight", (cout, cin, k, k), "lecun", True))

    def bn(name, c):
        spec.extend([(f"{name}.weight", (c,), "ones", False),
                     (f"{name}.bias", (c,), "zeros", False),
                     (f"{name}.running_mean", (c,), "zeros", False),
                     (f"{name}.running_var", (c,), "ones", False)])

    conv("encoder.conv1", 64, 3, 7)
    bn("encoder.bn1", 64)
    cin = 64
    for stage, blocks in enumerate(cfg["stage_sizes"]):
        width = 64 * 2 ** stage
        for b in range(blocks):
            p = f"encoder.layer{stage + 1}.{b}"
            conv(f"{p}.conv1", width, cin, 1)
            bn(f"{p}.bn1", width)
            conv(f"{p}.conv2", width, width, 3)
            bn(f"{p}.bn2", width)
            conv(f"{p}.conv3", 4 * width, width, 1)
            bn(f"{p}.bn3", 4 * width)
            if b == 0:
                conv(f"{p}.downsample.0", 4 * width, cin, 1)
                bn(f"{p}.downsample.1", 4 * width)
            cin = 4 * width
    hidden, out = int(cfg["projection_head_hidden_dim"]), int(cfg["output_dim"])
    spec.append(("projection_head.fc1.weight", (hidden, cin), "lecun", True))
    spec.append(("projection_head.fc1.bias", (hidden,), "zeros", False))
    bn("projection_head.bn1", hidden)
    spec.append(("projection_head.fc2.weight", (out, hidden), "lecun", True))
    return spec


def is_buffer(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


def draw_weights(spec, seed: int, device) -> dict[str, torch.Tensor]:
    """The initial weights of ``seed``, drawn on ``device`` in one call: a
    truncated unit normal for every "lecun" entry together, scaled to each
    one's std; zeros and ones for the rest."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [math.prod(shape) for _, shape, init, _ in spec if init == "lecun"]
    flat = torch.empty(sum(sizes), device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=g)
    out, start = {}, 0
    for name, shape, init, _ in spec:
        if init == "lecun":
            n = math.prod(shape)
            std = math.sqrt(1.0 / (n // shape[0])) / TRUNC_STD
            out[name] = flat[start:start + n].view(shape) * std
            start += n
        else:
            out[name] = (torch.zeros if init == "zeros" else torch.ones)(shape, device=device)
    return out


# --------------------------------------------------------------------------
# the feed: the corpus on disk, read in the order of the seed
# --------------------------------------------------------------------------

def raw_batches(corpus: str, seed: int, batch_pairs: int, steps: int, device) -> list[dict]:
    """The first ``steps`` raw batches of epoch 0: the indices shuffled by a
    generator of (seed, 0), each with its mined positive; uint8 crops and
    pixel joints (x, y, 0) with the normalised raw joints."""
    with open(os.path.join(corpus, "index.json")) as f:
        index = json.load(f)
    n, shard = index["num_samples"], index["shard_size"]
    meta = np.load(os.path.join(corpus, "meta.npz"))
    shards = [np.load(os.path.join(corpus, f"crops_{k:05d}.npy"), mmap_mode="r")
              for k in range(-(-n // shard))]
    order = np.arange(n)
    np.random.default_rng([seed, 0]).shuffle(order)
    out = []
    for b in range(steps):
        idx = order[b * batch_pairs:(b + 1) * batch_pairs]
        batch = {}
        for v, rows in ((1, idx), (2, meta["positive_idx"][idx])):
            crops = np.stack([shards[i // shard][i % shard] for i in rows])
            pix = meta["joints3d"][rows].astype(np.float32)
            pix[..., 2] = 0.0              # depth relative to the wrist, all at depth 1
            batch[f"image{v}"] = torch.from_numpy(crops).to(device)
            batch[f"joints{v}"] = torch.from_numpy(pix).to(device)
            batch[f"joints_raw{v}"] = torch.from_numpy(
                meta["joints_raw"][rows].astype(np.float32)).to(device)
        out.append(batch)
    return out


# --------------------------------------------------------------------------
# augmentation: rotate + crop + resize as one bilinear warp, HSV jitter
# --------------------------------------------------------------------------

def augment_draws(step: int, b: int, aug: dict, device) -> list[dict]:
    """Both views' draws for ``step``: a generator seeded from (0, step),
    angle, jitter, then hue, saturation, value alpha and beta, view 1 first."""
    seed = int(np.random.SeedSequence([0, step]).generate_state(1, np.uint64)[0])
    g = torch.Generator(device=device).manual_seed(seed)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=g, device=device)

    flags, p = aug["flags"], aug["params"]
    other = sorted(k for k, on in flags.items()
                   if on and k not in ("rotate", "crop", "color_jitter", "resize"))
    if other:
        raise NotImplementedError(f"the reference does not augment with {other}")
    views = []
    for _ in range(2):
        d = {}
        if flags["rotate"]:
            lo, hi = sorted((p["min_angle"], p["max_angle"]))
            d["angle"] = uniform(lo, hi, b)
        if flags["crop"]:
            d["jitter"] = uniform(0.0, p["crop_box_jitter"][1], b, 2)
        if flags["color_jitter"]:
            d["hue"] = uniform(*p["hue_factor_range"], b)
            d["sat"] = uniform(*p["sat_factor_range"], b)
            d["alpha"] = uniform(*p["value_factor_alpha_range"], b)
            d["beta"] = uniform(*p["value_factor_beta_range"], b)
        views.append(d)
    return views


def _mean_joints(xy: torch.Tensor) -> torch.Tensor:
    total = xy[..., 0, :]
    for i in range(1, xy.shape[-2]):
        total = total + xy[..., i, :]
    return total * float(np.float32(1.0) / np.float32(xy.shape[-2]))


def _affine(points: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    x, y = points[..., 0], points[..., 1]
    m = m[:, :, None, :]
    return torch.stack([m[:, 0, :, 0] * x + m[:, 0, :, 1] * y + m[:, 0, :, 2],
                        m[:, 1, :, 0] * x + m[:, 1, :, 1] * y + m[:, 1, :, 2]], dim=-1)


def _rotation(center: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    rad = (angle * (math.pi / 180.0)).double()
    a, s = torch.cos(rad).float(), torch.sin(rad).float()
    cx, cy = center[:, 0], center[:, 1]
    return torch.stack([torch.stack([a, s, (1.0 - a) * cx - s * cy], -1),
                        torch.stack([-s, a, s * cx + (1.0 - a) * cy], -1)], -2)


def _warp(images: torch.Tensor, m: torch.Tensor, out: int) -> torch.Tensor:
    """dst(x, y) = bilinear src(m^-1 (x, y)), zero outside."""
    b, h, w, c = images.shape
    det = m[:, 0, 0] * m[:, 1, 1] - m[:, 0, 1] * m[:, 1, 0]
    ia, ib = m[:, 1, 1] / det, -m[:, 0, 1] / det
    ic, idd = -m[:, 1, 0] / det, m[:, 0, 0] / det
    itx = -(ia * m[:, 0, 2] + ib * m[:, 1, 2])
    ity = -(ic * m[:, 0, 2] + idd * m[:, 1, 2])
    gy, gx = torch.meshgrid(torch.arange(out, dtype=torch.float32, device=images.device),
                            torch.arange(out, dtype=torch.float32, device=images.device),
                            indexing="ij")
    sx = ia[:, None, None] * gx + ib[:, None, None] * gy + itx[:, None, None]
    sy = ic[:, None, None] * gx + idd[:, None, None] * gy + ity[:, None, None]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = (sx - x0)[..., None], (sy - y0)[..., None]
    flat = images.reshape(b, h * w, c)

    def at(yi, xi):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = (yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long())
        vals = torch.gather(flat, 1, idx.reshape(b, -1, 1).expand(-1, -1, c))
        return vals.reshape(b, out, out, c).float() * inside[..., None]

    return (at(y0, x0) * (1 - wx) * (1 - wy) + at(y0, x0 + 1) * wx * (1 - wy)
            + at(y0 + 1, x0) * (1 - wx) * wy + at(y0 + 1, x0 + 1) * wx * wy)


def _rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    """OpenCV's 8-bit HSV of the crop read as BGR (the reference's quirk)."""
    r, g, b = img[..., 2], img[..., 1], img[..., 0]
    v = torch.maximum(torch.maximum(r, g), b)
    diff = v - torch.minimum(torch.minimum(r, g), b)
    s = torch.where(v > 0, 255.0 * diff / torch.clamp_min(v, 1e-6), 0.0)
    safe = torch.clamp_min(diff, 1e-6)
    h = torch.where(v == r, 30.0 * (g - b) / safe,
                    torch.where(v == g, 60.0 + 30.0 * (b - r) / safe,
                                120.0 + 30.0 * (r - g) / safe))
    return torch.stack([torch.where(h < 0, h + 180.0, h), s, v], dim=-1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h = torch.remainder(hsv[..., 0], 180.0) / 30.0
    s, v = hsv[..., 1] / 255.0, hsv[..., 2]
    i = torch.floor(h)
    f = h - i
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    sector = torch.remainder(i.to(torch.int32), 6)

    def pick(*choices):
        out = choices[-1]
        for k in range(len(choices) - 2, -1, -1):
            out = torch.where(sector == k, choices[k], out)
        return out

    r, g, b = pick(v, q, p, p, t, v), pick(t, v, v, q, p, p), pick(p, p, t, v, v, q)
    return torch.stack([b, g, r], dim=-1)


def augment_view(images, joints, d: dict, aug: dict, out: int) -> dict:
    """One view: rotate about the joints' centroid, crop a square around the
    rotated joints, resize to ``out`` (one warp), HSV jitter, normalise."""
    flags, p = aug["flags"], aug["params"]
    b, h, w, _ = images.shape
    j = joints.float()
    angle = torch.floor(d["angle"]) if flags["rotate"] else torch.zeros(b, device=j.device)
    rot = _rotation(torch.trunc(_mean_joints(j[..., :2])), angle)
    jr = _affine(j[..., :2], rot)
    jitter = torch.trunc(d["jitter"]) if flags["crop"] else torch.zeros(b, 2, device=j.device)
    center = torch.trunc(_mean_joints(jr))
    dd = jr - center[:, None, :]
    radius = torch.sqrt((dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1])
                        .amax(dim=-1).double()).float()
    half = torch.trunc(radius * p["crop_margin"])
    origin = torch.clamp_min(center - half[:, None] + jitter, 0.0)
    rec_jitter = center - half[:, None] - origin
    side = torch.clamp_min(2.0 * half, 1.0)
    wc = torch.clamp_min(torch.clamp_max(origin[:, 0] + side, w) - origin[:, 0], 1.0)
    hc = torch.clamp_min(torch.clamp_max(origin[:, 1] + side, h) - origin[:, 1], 1.0)
    shift = torch.zeros_like(rot)
    shift[:, :, 2] = origin
    mats = (rot - shift) * torch.stack([out / wc, out / hc], dim=1)[:, :, None]
    img = _warp(images, mats, out)
    if flags["color_jitter"]:
        hsv = _rgb_to_hsv(img)
        hsv = torch.stack([
            torch.clamp(hsv[..., 0] * d["hue"][:, None, None], 0, 255),
            torch.clamp(hsv[..., 1] * d["sat"][:, None, None], 0, 255),
            torch.clamp(hsv[..., 2] * d["alpha"][:, None, None] + d["beta"][:, None, None],
                        0, 255)], dim=-1)
        img = _hsv_to_rgb(hsv)
    mean = torch.tensor(IMAGENET_MEAN, device=img.device)
    std = torch.tensor(IMAGENET_STD, device=img.device)
    return {"image": (torch.clamp(img, 0.0, 255.0) / 255.0 - mean) / std,
            "angle": angle, "jitter": rec_jitter}


# --------------------------------------------------------------------------
# the network
# --------------------------------------------------------------------------

def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t rounded to ``dtype`` and back; a float8 type under a per-tensor
    scale that takes the largest magnitude to the type's largest."""
    if dtype == torch.bfloat16:
        return t.to(dtype).float()
    scale = t.abs().amax().clamp_min(1e-30) / torch.finfo(dtype).max
    return (t / scale).to(dtype).float() * scale


class _Round(torch.autograd.Function):
    """Rounds a value forward and its gradient backward, as a computation in
    a lower precision keeps both (float8: e4m3 forward, e5m2 backward)."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return _round(x.detach(), fwd)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.bwd), None, None


_ROUNDING = {"bf16": (torch.bfloat16, torch.bfloat16),
             "fp8": (torch.float8_e4m3fn, torch.float8_e5m2)}


class Net:
    """The encoder and head over a dict of float32 tensors. BatchNorm keeps
    the batch statistics it saw in ``stats`` (name -> (mean, biased var));
    a recomputation writes the same values again."""

    def __init__(self, cfg: dict, params: dict, compute: str = "float32"):
        self.cfg, self.p, self.compute = cfg, params, compute
        self.stop_grad = cfg.get("bn_variant", "exact") == "stop_grad"
        self.stats: dict[str, tuple] = {}

    def _q(self, t):
        if self.compute == "float32":
            return t
        return _Round.apply(t, *_ROUNDING[self.compute])

    def conv(self, x, name, stride=1, pad=None):
        w = self.p[f"{name}.weight"]
        k = w.shape[-1]
        if pad is None:                 # 'SAME'
            pads = []
            for size in (x.shape[-1], x.shape[-2]):
                total = max((-(-size // stride) - 1) * stride + k - size, 0)
                pads += [total // 2, total - total // 2]
            x = F.pad(x, pads)
            pad = 0
        return self._q(F.conv2d(self._q(x), self._q(w), stride=stride, padding=pad))

    def bn(self, x, name):
        # the stop-gradient variant is the encoder's; the head's stays exact
        stop = self.stop_grad and name.startswith("encoder.")
        dims = [d for d in range(x.dim()) if d != 1]
        mean = x.mean(dims)
        var = (x * x).mean(dims) - mean * mean if stop else \
            ((x - mean.view(1, -1, *[1] * (x.dim() - 2))) ** 2).mean(dims)
        var = torch.clamp_min(var, 0.0)
        self.stats[name] = (mean.detach(), var.detach())
        if stop:
            mean, var = mean.detach(), var.detach()
        shape = (1, -1, *[1] * (x.dim() - 2))
        inv = torch.rsqrt(var + BN_EPS) * self.p[f"{name}.weight"]
        return self._q((x - mean.view(shape)) * inv.view(shape)
                       + self.p[f"{name}.bias"].view(shape))

    def block(self, x, prefix, stride, first):
        y = torch.relu(self.bn(self.conv(x, f"{prefix}.conv1"), f"{prefix}.bn1"))
        y = torch.relu(self.bn(self.conv(y, f"{prefix}.conv2", stride), f"{prefix}.bn2"))
        y = self.bn(self.conv(y, f"{prefix}.conv3"), f"{prefix}.bn3")
        res = x
        if first:
            res = self.bn(self.conv(x, f"{prefix}.downsample.0", stride),
                          f"{prefix}.downsample.1")
        return self._q(torch.relu(y + res))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)
        x = torch.relu(self.bn(self.conv(x, "encoder.conv1", 2, pad=3), "encoder.bn1"))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage, blocks in enumerate(self.cfg["stage_sizes"]):
            for b in range(blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                # recomputed in the backward, so that a large batch fits
                x = checkpoint(self.block, x, f"encoder.layer{stage + 1}.{b}", stride,
                               b == 0, use_reentrant=False)
        emb = x.mean(dim=(2, 3))
        h = F.linear(self._q(emb), self._q(self.p["projection_head.fc1.weight"]),
                     self.p["projection_head.fc1.bias"])
        h = torch.relu(self.bn(h, "projection_head.bn1"))
        self.embeddings = emb.detach()
        return F.linear(self._q(h), self._q(self.p["projection_head.fc2.weight"]))


# --------------------------------------------------------------------------
# the loss
# --------------------------------------------------------------------------

def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=1e-24))


def inverse_transform(proj, jx, jy, angle, side: float):
    """PeCLR: the projections as 64 2-D points, shifted back by the crop
    jitter (scaled by each one's detached spread) and rotated back about
    their detached centroid; then re-normalised halves."""
    n, d = proj.shape
    b = n // 2
    z = torch.cat([_l2n(proj[:b]), _l2n(proj[b:])]).reshape(n, d // 2, 2)
    if jx is not None:
        spread = z.detach().amax(dim=1) - z.detach().amin(dim=1)
        z = torch.stack([z[..., 0] + (-jx / side * spread[:, 0])[:, None],
                         z[..., 1] + (-jy / side * spread[:, 1])[:, None]], dim=-1)
    if angle is not None:
        c = z.detach().mean(dim=1)
        rad = -angle * (math.pi / 180.0)
        a, s = torch.cos(rad), torch.sin(rad)
        x, y = z[..., 0], z[..., 1]
        tx = (1 - a) * c[:, 0] - s * c[:, 1]
        ty = s * c[:, 0] + (1 - a) * c[:, 1]
        z = torch.stack([a[:, None] * x + s[:, None] * y + tx[:, None],
                         -s[:, None] * x + a[:, None] * y + ty[:, None]], dim=-1)
    z = z.reshape(n, d)
    return _l2n(z[:b]), _l2n(z[b:])


def _mpjpe_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a[:, None] - b[None]).norm(dim=-1).mean(dim=-1)


def weighted_ntxent(z1, z2, j1, j2, temperature: float) -> torch.Tensor:
    """SiMHand's weighted NT-Xent with linear MPJPE weights on positives and
    negatives: the negative weights multiply the whole similarity matrix
    before the exp, and only the self pair leaves the denominator."""
    pos_d = (j1 - j2).norm(dim=-1).mean(dim=-1)
    pw = (pos_d.max() - pos_d) / (pos_d.max() - pos_d.min())
    j = torch.cat([j1, j2])
    d = torch.cat([_mpjpe_matrix(j, j[k:k + 512]) for k in range(0, len(j), 512)], dim=1)
    nw = (d.max() - d) / (d.max() - d.min())
    z = torch.cat([z1, z2])
    sim = (z @ z.T) * nw / temperature
    eye = torch.eye(len(z), dtype=torch.bool, device=z.device)
    neg = torch.where(eye, 0.0, torch.exp(sim)).sum(dim=-1)
    pos = torch.exp((z1 * z2).sum(-1) * pw / temperature)
    return torch.mean(-torch.log(torch.cat([pos, pos]) / neg))


# --------------------------------------------------------------------------
# the optimizer: LARS -> Adam -> learning rate
# --------------------------------------------------------------------------

def learning_rate(cfg: dict, count: int) -> float:
    base = np.float32(cfg["lr"] * math.sqrt(1024 * cfg.get("accumulate_grad_batches", 1)))
    iters = int(cfg["train_iters_per_epoch"])
    warm = int(cfg["warmup_epochs"]) * iters
    total = int(cfg["epochs"]) * iters
    if count < warm:
        return float(base * np.float32(count) / np.float32(warm))
    decay = max(total - warm, 1)
    c = np.float32(min(count - warm, decay))
    return float(base * (np.float32(0.5) * (np.float32(1) + np.cos(np.float32(np.pi) * c
                                                                   / np.float32(decay)))))


@torch.no_grad()
def lars_adam(params: dict, grads: dict, opt: dict, cfg: dict, decayed: dict) -> dict:
    """One update of every parameter in place; returns the LARS-scaled
    gradient of each (what Adam receives)."""
    lr = learning_rate(cfg, opt["count"])
    opt["count"] += 1
    t = opt["count"]
    f32 = np.float32           # optax's bias corrections, in float32
    bc1 = float(f32(1) - f32(ADAM_B1) ** f32(t))
    bc2 = float(f32(1) - f32(ADAM_B2) ** f32(t))
    scaled = {}
    for name, p in params.items():
        g = grads[name]
        wd = float(cfg["opt_weight_decay"]) if decayed[name] else 0.0
        pn, gn = p.norm(), g.norm()
        trust = float(cfg.get("lars_eta", 0.02)) * pn / (gn + pn * wd + 1e-8)
        trust = torch.clamp(trust / lr, max=1.0)
        if pn > 0 and gn > 0:
            g = (g + wd * p) * trust
        scaled[name] = g
        mu = opt["mu"][name].mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
        nu = opt["nu"][name].mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
        p.sub_(lr * (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS))
    return scaled


# --------------------------------------------------------------------------
# the steps and their readings
# --------------------------------------------------------------------------

def run_steps(cfg: dict, weights: dict, batches: list[dict], compute: str = "float32",
              half_batch: bool = False) -> dict:
    """Trains from ``weights`` on ``batches`` (one step each, step i
    augmented with the draws of (0, i)). Returns the readings: each step's
    loss, the norm of the first step's LARS-scaled gradient by parameter, and
    the norm of each parameter's and running statistic's change by the end.
    TF32 is off throughout. ``embeddings`` holds the encoder's output of the
    first step and ``batch_var`` each BatchNorm's batch variance there, on the
    host."""
    prior = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _run(cfg, weights, batches, compute, half_batch)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prior


def _run(cfg, weights, batches, compute, half_batch):
    spec = {name: decayed for name, _, _, decayed in param_spec(cfg)}
    params = {k: v.detach().clone().float() for k, v in weights.items() if not is_buffer(k)}
    buffers = {k: v.detach().clone().float() for k, v in weights.items() if is_buffer(k)}
    start = {k: v.clone() for k, v in {**params, **buffers}.items()}
    opt = {"count": 0, "mu": {k: torch.zeros_like(v) for k, v in params.items()},
           "nu": {k: torch.zeros_like(v) for k, v in params.items()}}
    aug = {"flags": cfg["augmentation_flags"], "params": cfg["augmentation_params"]}
    side = int(cfg["augmentation_params"]["resize_shape"][0])
    equivariant = cfg["experiment_type"] in ("peclr", "peclr_w", "simhand-base", "simhand",
                                             "simhand_w", "simhand_vis")
    losses, first_grad = [], None
    for step, raw in enumerate(batches):
        b = raw["image1"].shape[0]
        draws = augment_draws(step, b, aug, raw["image1"].device)
        keep = slice(0, b // 2 if half_batch else b)
        views = [augment_view(raw[f"image{v}"][keep], raw[f"joints{v}"][keep],
                              {k: t[keep] for k, t in draws[v - 1].items()}, aug, side)
                 for v in (1, 2)]
        for p in params.values():
            p.requires_grad_(True)
        net = Net(cfg, params, compute)
        proj = net.forward(torch.cat([views[0]["image"], views[1]["image"]]))
        jx = jy = angle = None
        if equivariant and aug["flags"]["crop"]:
            jx = torch.cat([views[0]["jitter"][:, 0], views[1]["jitter"][:, 0]])
            jy = torch.cat([views[0]["jitter"][:, 1], views[1]["jitter"][:, 1]])
        if equivariant and aug["flags"]["rotate"]:
            angle = torch.cat([views[0]["angle"], views[1]["angle"]])
        if equivariant:
            z1, z2 = inverse_transform(proj, jx, jy, angle, float(side))
        else:
            z1, z2 = _l2n(proj[:len(proj) // 2]), _l2n(proj[len(proj) // 2:])
        key = "joints_raw" if cfg["joints_type"] == "original" else None
        if key is None:
            raise NotImplementedError("the reference takes joints_type 'original'")
        j1 = raw["joints_raw1"][keep][..., :2] * float(side)
        j2 = raw["joints_raw2"][keep][..., :2] * float(side)
        loss = weighted_ntxent(z1, z2, j1, j2, float(cfg["temperature"]))
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))
        for p in params.values():
            p.requires_grad_(False)
        losses.append(float(loss.detach()))
        scaled = lars_adam(params, grads, opt, cfg, spec)
        if first_grad is None:
            first_grad = {k: float(v.norm()) for k, v in scaled.items()}
            first_emb = net.embeddings.cpu()
            batch_var = {name: var.cpu() for name, (_, var) in net.stats.items()}
        with torch.no_grad():
            for name, (mean, var) in net.stats.items():
                buffers[f"{name}.running_mean"].mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
                buffers[f"{name}.running_var"].mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)
        del net, proj, loss, grads, scaled
    now = {**params, **buffers}
    change = {k: float((now[k] - start[k]).norm()) for k in now}
    return {"losses": losses, "embeddings": first_emb, "batch_var": batch_var,
            "first_grad": first_grad,
            "change": change}
