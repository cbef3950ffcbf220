"""W8A8 int8-compute serving: the BatchNorm fold, the structural walk and its
float32 and int8 interpretations (counterpart of
``simhand_tpu/serving/int8_infer.py``; same module name, so a reader finds
it).

* **BN folding**: every frozen conv+BN pair of the port's ``ContrastiveModel``
  or ``DetNet`` collapses to one convolution with a per-output-channel bias,
  ``W' = W * gamma/sigma`` and ``b = beta - mu * gamma/sigma``, computed in
  float32 in the reference's order (``s = scale / sqrt(var + eps)``,
  ``b = bias - mean * s``, ``k * s``): every step is one correctly rounded
  IEEE operation, so the fold is bit-equal to the JAX package's (the
  square root is taken in float64 and rounded once, which is the correctly
  rounded float32 root; PyTorch's vectorized float32 ``sqrt`` on the CPU is
  not correctly rounded). The map keeps the reference's site keys
  (``"conv1"``, ``"layer4_1/conv2"``, ``"layer2_0/downsample"``,
  ``"hmap_0/project"``); its kernels are PyTorch's OIHW.
* **The walk** (``_walk_resnet``) visits the ResNet once over an ops object,
  in NCHW views with channels-last strides (the input's NHWC memory), so an
  activation's memory is its NHWC tensor: ``ops.bottleneck_block.
  FoldedBf16Ops`` hands it to the convolution kernel (``ops/conv_bias.py``)
  without a copy. Its ``block_override`` hook hands whole identity
  bottlenecks to kernel #12. ``_CalibOps`` interprets it in float32 (the
  fold's oracle, with ``maxes`` recording max|t| at every quantization
  point); ``FoldedBf16Ops`` in bf16; ``_QuantOps`` in int8.
* **W8A8** (``_QuantOps``): weights per-output-channel symmetric int8 of the
  folded kernel (``quantize_folded``), activations per-tensor symmetric int8
  with static scales from a float32 calibration pass (``_calibrate``, TF32
  off). A convolution is an im2col of the int8 NHWC activation (slices of
  the padded tensor; K padded with zeros to a multiple of 8, and 16 zero
  rows added where an image gives at most 16, as ``torch._int_mm`` needs on
  a card) times the int8 kernel, ``torch._int_mm`` -> int32, exact in any
  order. The float32 epilogue is the reference's chain as XLA's CPU
  backend computes it: it multiplies by the reciprocal of a scale where the
  reference divides by it (``rint(y * (1 / s))``, the reciprocal rounded to
  float32) and contracts ``float32(y) * c + d`` into one fused
  multiply-add. Each such FMA is computed in float64 (the product of two
  float32 values is exact there) and rounded to float32, on both devices
  (a float64 sum rounded twice can differ from the FMA's one rounding only
  at a float32 tie), so the
  card gives the CPU's int8 activations; the constants ``sx * sw / so`` and
  ``b / so`` are numpy float32 arrays built in the reference's order.
  Residual adds, global pool, the projection head, the deconvolutions and
  the 1x1 prediction convolutions stay float32.
* **Surfaces**: ``fold_encoder_f32`` / ``build_encoder_int8`` (embedding and
  projection, the head's BatchNorm folded into its first dense layer) and
  ``fold_detnet_f32`` / ``build_detnet_int8`` (the maps, uv, xyz, delta; the
  three map heads' 3x3 projections quantized). The int8 builders return an
  ``nn.Module`` that ``torch.export`` traces: the int8 kernels and the
  epilogue constants are buffers, the activation scales Python floats.

The float32 convolutions follow ``torch.backends.cudnn.allow_tf32``, which
is on by default on a card: turn it off for an exact oracle (``_calibrate``
does, inside its scope).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from simhand_tpu_torch.models.layers import same_pads

STAGE_SIZES = {
    "18": (2, 2, 2, 2),
    "34": (3, 4, 6, 3),
    "50": (3, 4, 6, 3),
    "101": (3, 4, 23, 3),
    "152": (3, 8, 36, 3),
}
_BOTTLENECK = ("50", "101", "152")
_HEADS = ("hmap_0", "dmap_0", "lmap_0")


# ---------------------------------------------------------------------------
# BN folding
# ---------------------------------------------------------------------------

def _sqrt(t):
    """The correctly rounded float32 square root of a float32 tensor."""
    return torch.sqrt(t.double()).float()


def _bn_scale_bias(bn, eps: float):
    s = bn.weight.detach().float() / _sqrt(bn.running_var.float() + eps)
    return s, bn.bias.detach().float() - bn.running_mean.float() * s


def fold_conv_bn(weight, bn, eps: float = 1e-5):
    """(O, I, kh, kw) conv weight + a frozen BatchNorm module -> (folded
    float32 weight, float32 bias)."""
    with torch.no_grad():
        s, b = _bn_scale_bias(bn, eps)
        return weight.detach().float() * s.view(-1, 1, 1, 1), b


def _fold_resnet(encoder, backbone: str) -> dict:
    """site name -> (folded float32 OIHW weight, float32 bias) for every
    conv+BN pair of the port's ResNet."""
    if not hasattr(encoder, "conv1"):
        raise NotImplementedError("int8 inference supports the conv7 stem only (no s2d)")
    fw = {"conv1": fold_conv_bn(encoder.conv1.weight, encoder.bn1)}
    bott = backbone in _BOTTLENECK
    for stage, n in enumerate(STAGE_SIZES[backbone]):
        layer = getattr(encoder, f"layer{stage + 1}")
        for b in range(n):
            name, block = f"layer{stage + 1}_{b}", layer[b]
            convs = ("conv1", "conv2", "conv3") if bott else ("conv1", "conv2")
            for i, c in enumerate(convs, start=1):
                fw[f"{name}/{c}"] = fold_conv_bn(getattr(block, c).weight,
                                                 getattr(block, f"bn{i}"))
            if block.downsample is not None:
                fw[f"{name}/downsample"] = fold_conv_bn(block.downsample[0].weight,
                                                        block.downsample[1])
    return fw


def quantize_folded(fw: dict) -> dict:
    """site -> (int8 OIHW kernel, float32 per-output-channel scale, float32
    bias), numpy, in the reference's order (bit-equal to its HWIO result)."""
    qw = {}
    for key, (w, b) in fw.items():
        w = w.detach().float().cpu().numpy()
        sw = np.max(np.abs(w), axis=(1, 2, 3))
        sw = np.maximum(sw / np.float32(127.0), np.float32(1e-12)).astype(np.float32)
        q = np.clip(np.rint(w / sw[:, None, None, None]), -127, 127).astype(np.int8)
        qw[key] = (q, sw, b.detach().float().cpu().numpy())
    return qw


# ---------------------------------------------------------------------------
# the float32 interpretation of the walk
# ---------------------------------------------------------------------------

def _conv(x, w, stride: int, padding):
    """NCHW convolution with XLA's padding: "SAME" or [(lo, hi), (lo, hi)]."""
    if padding == "SAME":
        padding = [same_pads(x.shape[-2], w.shape[-2], stride),
                   same_pads(x.shape[-1], w.shape[-1], stride)]
    (top, bottom), (left, right) = padding
    if top == bottom and left == right:
        return F.conv2d(x, w, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)


def _maxpool(x):
    """3x3, stride 2, padded by one -inf on each side (flax's max_pool)."""
    return F.max_pool2d(x, 3, 2, 1)


class _CalibOps:
    """float32 folded forward; records max|t| at every quantization point.

    Doubles as the folding oracle: with quantization points as identity,
    the output must equal the model's frozen forward.
    """

    def __init__(self, fw: dict):
        self.fw = fw
        self.maxes: dict = {}

    def _track(self, key, t):
        self.maxes[key] = t.abs().max().float()
        return t

    def input(self, key, x):
        return self._track(key, x.float())

    def conv_bias(self, key, x, stride, padding):
        w, b = self.fw[key]
        return _conv(x, w, stride, padding) + b.view(1, -1, 1, 1)

    def conv_bn_relu(self, key, x, stride, padding, out_f32=False):
        y = torch.relu(self.conv_bias(key, x, stride, padding))
        return y if out_f32 else self._track(key, y)

    def conv_bn(self, key, x, stride, padding):
        return self.conv_bias(key, x, stride, padding)

    def add_relu(self, key, y, shortcut):
        return self._track(key, torch.relu(y + shortcut))

    def maxpool(self, x):
        return _maxpool(x)

    def to_f32(self, x):
        return x

    def quantize(self, key, x):
        return self._track(key, x)


def _walk_resnet(ops, backbone: str, x, pool: bool):
    """The single structural walk all interpretations share. Mirrors
    ``models/resnet.py``; x is (N, H, W, 3), walked as its NCHW view.

    If ``ops`` exposes ``block_override(name, x, stride, cin, cout)`` and it
    returns non-None, that value replaces the whole residual block: the
    hook the whole-block kernel plugs into (``ops/bottleneck_block.py``).
    pool=True returns the float32 (N, C) mean over H and W, pool=False the
    (N, H/32, W/32, C) map."""
    bott = backbone in _BOTTLENECK
    override = getattr(ops, "block_override", None)
    x = ops.input("in", x.permute(0, 3, 1, 2))
    x = ops.conv_bn_relu("conv1", x, 2, [(3, 3), (3, 3)])
    x = ops.maxpool(x)
    cin = 64
    for stage, n in enumerate(STAGE_SIZES[backbone]):
        f = 64 * 2 ** stage
        cout = f * (4 if bott else 1)
        for b in range(n):
            stride = 2 if stage > 0 and b == 0 else 1
            name = f"layer{stage + 1}_{b}"
            if override is not None:
                y = override(name, x, stride, cin, cout)
                if y is not None:
                    x = y
                    cin = cout
                    continue
            shortcut = x
            if bott:
                y = ops.conv_bn_relu(f"{name}/conv1", x, 1, "SAME")
                y = ops.conv_bn_relu(f"{name}/conv2", y, stride, "SAME")
                y = ops.conv_bn(f"{name}/conv3", y, 1, "SAME")
            else:
                y = ops.conv_bn_relu(f"{name}/conv1", x, stride, "SAME")
                y = ops.conv_bn(f"{name}/conv2", y, 1, "SAME")
            if stride != 1 or cin != cout:
                shortcut = ops.conv_bn(f"{name}/downsample", x, stride, "SAME")
            x = ops.add_relu(f"{name}/out", y, shortcut)
            cin = cout
    feats = ops.to_f32(x)
    return feats.mean(dim=(2, 3)) if pool else feats.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# the int8 interpretation
# ---------------------------------------------------------------------------

def _f32(v) -> np.float32:
    return np.float32(v)


class _InputScales:
    """The walk on scales alone: records the scale of the int8 activation
    that enters each convolution (``sx`` of the reference's epilogue)."""

    def __init__(self, scales: dict):
        self.scales = scales
        self.sx: dict = {}

    def input(self, key, x):
        return self.scales[key]

    def conv_bn_relu(self, key, s, stride, padding):
        self.sx[key] = s
        return self.scales[key]

    def conv_bn(self, key, s, stride, padding):
        self.sx[key] = s

    def add_relu(self, key, y, shortcut):
        return self.scales[key]

    def maxpool(self, s):
        return s

    def to_f32(self, s):
        return torch.zeros(1, 1, 1, 1)


def _input_scales(scales: dict, backbone: str, heads: bool) -> dict:
    walk = _InputScales(scales)
    _walk_resnet(walk, backbone, torch.zeros(1, 1, 1, 3), pool=True)
    if heads:
        walk.sx.update({f"{h}/project": scales[f"{h}/in"] for h in _HEADS})
    return walk.sx


def _buffer_name(key: str, what: str) -> str:
    return f"{key.replace('/', '__')}__{what}"


def _round_int8(t, lo: int):
    """clip(rint(t), lo, 127) as int8 (round half to even, as ``rint``)."""
    return torch.round(t).clamp_(lo, 127).to(torch.int8)


def _fma(d, y, c):
    """float32(float32(y) * c + d) with one rounding of the exact sum, as
    XLA's contracted multiply-add gives it after its int32 -> float32
    convert: the product of two float32 values is exact in float64, the
    float64 sum is rounded once there and then to float32."""
    return torch.addcmul(d, y.to(torch.float32), c).to(torch.float32)


class _QuantOps(nn.Module):
    """int8 forward: activations travel as (int8 NHWC tensor, Python float
    scale). ``qw`` is ``quantize_folded``'s map, ``scales`` the calibrated
    activation scales, ``sx`` each convolution's input scale. A site that
    ``scales`` holds requantizes its output to int8 (``c = sx * sw / so``,
    ``d = b / so``); any other keeps it float32 (``c = sx * sw``, ``d = b``).
    Float results that leave the walk (``to_f32``, ``out_f32``) are NCHW
    views, as the float32 ops give them."""

    def __init__(self, qw: dict, scales: dict, sx: dict):
        super().__init__()
        self.scales = {k: float(v) for k, v in scales.items()}
        self.recip = {k: float(_f32(1.0) / _f32(v)) for k, v in scales.items()}
        self.kernel = {}
        for key, (q, sw, b) in qw.items():
            cout, cin, kh, kw = q.shape
            c = _f32(sx[key]) * sw
            d = b
            if key in scales:
                so = _f32(scales[key])
                c, d = c / so, b / so
            k = kh * kw * cin
            mat = np.zeros((cout, k + (-k) % 8), np.int8)
            mat[:, :k] = q.transpose(0, 2, 3, 1).reshape(cout, k)
            self.kernel[key] = (kh, kw, k)
            self.register_buffer(_buffer_name(key, "q"), torch.from_numpy(mat))
            self.register_buffer(_buffer_name(key, "c"), torch.from_numpy(c.astype(np.float64)))
            self.register_buffer(_buffer_name(key, "d"), torch.from_numpy(d.astype(np.float64)))

    def _requant(self, key, y, lo: int = -127):
        """clip(rint(y / s), lo, 127), the division as XLA computes it: a
        product with the float32 reciprocal (lo = 0 is the ReLU before it)."""
        return _round_int8(y * self.recip[key], lo), self.scales[key]

    def _int_conv(self, key, x, stride: int, padding):
        """(N, H, W, C) int8 -> (N, Ho, Wo, Cout) int32: im2col (rows ordered
        (kh, kw, C), as the kernel's K) times the kernel on ``_int_mm``."""
        kh, kw, k = self.kernel[key]
        q = getattr(self, _buffer_name(key, "q"))
        n, h, w, cin = x.shape
        if padding == "SAME":
            padding = [same_pads(h, kh, stride), same_pads(w, kw, stride)]
        (top, bottom), (left, right) = padding
        ho = (h + top + bottom - kh) // stride + 1
        wo = (w + left + right - kw) // stride + 1
        if top or bottom or left or right:
            x = F.pad(x, (0, 0, left, right, top, bottom))
        cols = [x[:, i:i + stride * (ho - 1) + 1:stride, j:j + stride * (wo - 1) + 1:stride]
                for i in range(kh) for j in range(kw)]
        if q.shape[1] > k:
            cols.append(x.new_zeros((n, ho, wo, q.shape[1] - k)))
        a = cols[0] if len(cols) == 1 else torch.cat(cols, dim=3)
        a = a.reshape(-1, q.shape[1])
        rows = a.shape[0]
        if ho * wo <= 16:   # _int_mm on a card takes more than 16 rows
            a = F.pad(a, (0, 0, 0, 16))
        return torch._int_mm(a, q.t())[:rows].view(-1, ho, wo, q.shape[0])

    def _epilogue(self, key, y32):
        c = getattr(self, _buffer_name(key, "c"))
        d = getattr(self, _buffer_name(key, "d"))
        return _fma(d, y32, c)

    def input(self, key, x):
        return self._requant(key, x.permute(0, 2, 3, 1).float())

    def conv_bn_relu(self, key, xq_s, stride, padding, out_f32=False):
        y = self._epilogue(key, self._int_conv(key, xq_s[0], stride, padding))
        if out_f32:
            return torch.relu(y).permute(0, 3, 1, 2)
        return _round_int8(y, 0), self.scales[key]

    def conv_bn(self, key, xq_s, stride, padding):
        return self._epilogue(key, self._int_conv(key, xq_s[0], stride, padding))

    def add_relu(self, key, y, shortcut):
        if isinstance(shortcut, tuple):  # identity shortcut: y + sq * s, contracted
            sq, s = shortcut
            y = torch.add(y.double(), sq, alpha=float(_f32(s))).to(torch.float32)
        else:
            y = y + shortcut
        return self._requant(key, y, 0)

    def maxpool(self, xq_s):
        # max commutes with the positive scale: pool the int8 values, in
        # float16 (exact for |q| <= 127) on every device
        xq, s = xq_s
        y = _maxpool(xq.permute(0, 3, 1, 2).to(torch.float16))
        return y.to(torch.int8).permute(0, 2, 3, 1), s

    def to_f32(self, xq_s):
        xq, s = xq_s
        return (xq.to(torch.float32) * s).permute(0, 3, 1, 2)

    def quantize(self, key, x):
        return self._requant(key, x.permute(0, 2, 3, 1))


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _tf32_off():
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def _calibrate(fw: dict, backbone: str, calib_batches, pool: bool, extra,
               device) -> tuple:
    """max|t| at every quantization point of the float32 walk (TF32 off)
    over ``calib_batches`` on ``device`` -> (scales, report)."""
    if calib_batches is None:
        raise ValueError(
            "int8 compute needs calibration batches (representative "
            "images); pass calib_batches=[...] or use "
            "random_calibration_batches() for smoke use")
    fw = {k: (w.to(device), b.to(device)) for k, (w, b) in fw.items()}
    maxes: dict = {}
    nb = 0
    with torch.no_grad(), _tf32_off():
        for batch in calib_batches:
            ops = _CalibOps(fw)
            x = torch.as_tensor(np.asarray(batch, np.float32)).to(device)
            feats = _walk_resnet(ops, backbone, x, pool=pool)
            if extra is not None:
                extra(ops, feats)
            values = torch.stack(list(ops.maxes.values())).tolist()
            for k, v in zip(ops.maxes, values):
                maxes[k] = max(maxes.get(k, 0.0), v)
            nb += 1
    scales = {k: max(v / 127.0, 1e-12) for k, v in maxes.items()}
    return scales, {"calib_batches": nb, "sites": len(scales), "scales": scales}


def random_calibration_batches(side: int = 128, batch: int = 32, n: int = 2, seed: int = 0):
    """ImageNet-normalized-range random images, numpy's draws as the
    reference makes them: smoke-grade calibration (real deployments pass
    real crops)."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(batch, side, side, 3)).astype(np.float32) for _ in range(n)]


def cache_calibration_batches(cache_dir: str, side: int = 128, batch: int = 32, n: int = 4,
                              seed: int = 0, device=None):
    """Calibration batches from a packed crop cache (``data/cache.py``),
    the reference's draw of crops, preprocessed as the serving input path
    does (``embed._preprocess_fn``: resize and ImageNet normalization, on
    ``device``): the activation scales then match what the artifact sees.
    Returns numpy float32 batches."""
    from simhand_tpu_torch.data.cache import CachedHand100MSource
    from simhand_tpu_torch.serving.embed import _preprocess_fn

    src = CachedHand100MSource(cache_dir)
    rng = np.random.default_rng(seed)
    total = min(batch * n, len(src))
    idx = rng.choice(len(src), size=total, replace=False)
    preprocess = _preprocess_fn(side, device)
    return [preprocess(src.gather_crops(np.sort(idx[lo:lo + batch]))).cpu().numpy()
            for lo in range(0, total, batch)]


# ---------------------------------------------------------------------------
# encoder surface
# ---------------------------------------------------------------------------

def _fold_projection(head):
    """The projection head with its BatchNorm folded into fc1: (w1f, b1f,
    w2), float32, as (in, out) matrices."""
    with torch.no_grad():
        bn = head.bn1
        s = bn.weight.float() / _sqrt(bn.running_var.float() + bn.eps)
        w1f = head.fc1.weight.float().T * s
        b1f = (head.fc1.bias.float() - bn.running_mean.float()) * s + bn.bias.float()
        return w1f, b1f, head.fc2.weight.float().T


def _projection_forward(emb, w1f, b1f, w2):
    return torch.relu(emb @ w1f + b1f) @ w2


def fold_encoder_f32(model):
    """The float32 folded forward of the port's ``ContrastiveModel`` (the
    oracle for tests; no quantization): images (N, H, W, 3) -> {"embedding":
    (N, C), "projection": (N, D)}, float32, on the model's device. The
    backbone is the model's (the reference takes it as an argument)."""
    backbone = model.resnet_size
    fw = _fold_resnet(model.encoder, backbone)
    head = _fold_projection(model.projection_head)
    device = model.encoder.conv1.weight.device

    def forward(images):
        with torch.no_grad():
            emb = _walk_resnet(_CalibOps(fw), backbone, images.to(device), pool=True)
            return {"embedding": emb, "projection": _projection_forward(emb, *head)}

    return forward


class Int8Encoder(nn.Module):
    """The W8A8 encoder forward: images (N, H, W, 3) float32 -> {"embedding",
    "projection"}, float32."""

    def __init__(self, ops: _QuantOps, backbone: str, head):
        super().__init__()
        self.ops, self.backbone = ops, backbone
        for name, t in zip(("w1f", "b1f", "w2"), head):
            self.register_buffer(name, t.detach().clone(memory_format=torch.contiguous_format))

    def forward(self, images):
        emb = _walk_resnet(self.ops, self.backbone, images, pool=True)
        return {"embedding": emb,
                "projection": _projection_forward(emb, self.w1f, self.b1f, self.w2)}


def _int8_encoder(model, scales: dict) -> Int8Encoder:
    backbone = model.resnet_size
    fw = _fold_resnet(model.encoder, backbone)
    ops = _QuantOps(quantize_folded(fw), scales, _input_scales(scales, backbone, heads=False))
    device = model.encoder.conv1.weight.device
    return Int8Encoder(ops, backbone, _fold_projection(model.projection_head)).to(device)


def build_encoder_int8(model, calib_batches=None, calib_device=None):
    """-> (``Int8Encoder`` on the model's device, report dict).

    calib_batches: iterable of (N, S, S, 3) float32 arrays for activation
    scale calibration (required). calib_device: where the float32
    calibration pass runs (the model's device by default). The backbone is
    the model's."""
    device = model.encoder.conv1.weight.device
    fw = _fold_resnet(model.encoder, model.resnet_size)
    scales, report = _calibrate(fw, model.resnet_size, calib_batches, pool=True, extra=None,
                                device=calib_device or device)
    return _int8_encoder(model, scales), report


# ---------------------------------------------------------------------------
# detnet surface
# ---------------------------------------------------------------------------

def _fold_detnet_heads(model) -> dict:
    """Folded map-head 3x3 project convs (the heavy head FLOPs)."""
    return {f"{head}/project": fold_conv_bn(getattr(model, head).project[0].weight,
                                            getattr(model, head).project[1])
            for head in _HEADS}


class _DetnetTail(nn.Module):
    """The float32 parts of the detnet tail as buffers: the three
    deconvolutions with their BatchNorm folded (``deconv{i}_w`` in PyTorch's
    flipped (I, O, kh, kw) layout, ``deconv{i}_b``) and the 1x1 predictions
    (``{head}_w``, ``{head}_b``)."""

    def __init__(self, model):
        super().__init__()
        with torch.no_grad():
            for i in range(3):
                s, b = _bn_scale_bias(model.deconv[3 * i + 1], 1e-5)
                w = model.deconv[3 * i].weight.detach().float() * s.view(1, -1, 1, 1)
                self.register_buffer(f"deconv{i}_w", w)
                self.register_buffer(f"deconv{i}_b", b)
            for head in _HEADS:
                pred = getattr(model, head).prediction
                self.register_buffer(f"{head}_w", pred.weight.detach().float().clone())
                self.register_buffer(f"{head}_b", pred.bias.detach().float().clone())


def _detnet_tail(ops, tail: _DetnetTail, feats, hm_res: int, njoints: int) -> dict:
    """Deconvolutions (float32, folded BN) + quantized map-head projections +
    float32 1x1 predictions, on NCHW views; mirrors ``finetune/detnet.py``."""
    from simhand_tpu_torch.finetune.detnet import gather_at_argmax, map_to_uv, pose_tile

    x = feats.permute(0, 3, 1, 2)
    for i in range(3):
        x = F.conv_transpose2d(x, getattr(tail, f"deconv{i}_w"), stride=2, padding=1)
        x = torch.relu(x + getattr(tail, f"deconv{i}_b").view(1, -1, 1, 1))
    n = x.shape[0]
    x = torch.cat([x, pose_tile(n, hm_res, torch.float32, x.device)], dim=1)
    maps = {}
    for head, sig in zip(_HEADS, (True, False, False)):
        hq = ops.quantize(f"{head}/in", x)
        h = ops.conv_bn_relu(f"{head}/project", hq, 1, "SAME", out_f32=True)
        y = F.conv2d(h, getattr(tail, f"{head}_w")) + getattr(tail, f"{head}_b").view(1, -1, 1, 1)
        maps[head] = torch.sigmoid(y) if sig else y
        x = torch.cat([x, maps[head]], dim=1)

    j, r = njoints, hm_res
    hmap = maps["hmap_0"].permute(0, 2, 3, 1)
    dmap = maps["dmap_0"].permute(0, 2, 3, 1).reshape(n, r, r, j, 3)
    lmap = maps["lmap_0"].permute(0, 2, 3, 1).reshape(n, r, r, j, 3)
    uv, idx = map_to_uv(hmap)
    return {"h_map": hmap, "d_map": dmap, "l_map": lmap,
            "delta": gather_at_argmax(dmap, idx), "xyz": gather_at_argmax(lmap, idx),
            "uv": uv}


def _detnet_fold(model, backbone: str) -> dict:
    return {**_fold_resnet(model.encoder.resnet, backbone), **_fold_detnet_heads(model)}


def fold_detnet_f32(model, backbone: str = "50"):
    """The float32 folded detnet forward of the port's ``DetNet`` (the
    fold and walk oracle for tests): images -> the maps dict, on the
    model's device. hm_res and njoints are the model's."""
    fw = _detnet_fold(model, backbone)
    tail = _DetnetTail(model)
    device = model.deconv[0].weight.device

    def forward(images):
        with torch.no_grad():
            ops = _CalibOps(fw)
            feats = _walk_resnet(ops, backbone, images.to(device), pool=False)
            return _detnet_tail(ops, tail, feats, model.hm_res, model.njoints)

    return forward


class Int8Detnet(nn.Module):
    """The W8A8 detnet forward: images -> {h_map, d_map, l_map, delta, xyz,
    uv}; the backbone and the map heads' projections in int8."""

    def __init__(self, ops: _QuantOps, backbone: str, tail: _DetnetTail, hm_res: int,
                 njoints: int):
        super().__init__()
        self.ops, self.tail, self.backbone = ops, tail, backbone
        self.hm_res, self.njoints = hm_res, njoints

    def forward(self, images):
        feats = _walk_resnet(self.ops, self.backbone, images, pool=False)
        return _detnet_tail(self.ops, self.tail, feats, self.hm_res, self.njoints)


def _int8_detnet(model, backbone: str, scales: dict) -> Int8Detnet:
    ops = _QuantOps(quantize_folded(_detnet_fold(model, backbone)), scales,
                    _input_scales(scales, backbone, heads=True))
    return Int8Detnet(ops, backbone, _DetnetTail(model), model.hm_res,
                      model.njoints).to(model.deconv[0].weight.device)


def build_detnet_int8(model, backbone: str = "50", calib_batches=None, calib_device=None):
    """-> (``Int8Detnet`` on the model's device, report). Quantizes the
    backbone and the three map-head 3x3 projections; the deconvolutions and
    1x1 predictions stay float32. hm_res and njoints are the model's."""
    device = model.deconv[0].weight.device
    fw = _detnet_fold(model, backbone)
    tail = _DetnetTail(model).to(calib_device or device)

    def extra(ops, feats):
        _detnet_tail(ops, tail, feats, model.hm_res, model.njoints)

    scales, report = _calibrate(fw, backbone, calib_batches, pool=False, extra=extra,
                                device=calib_device or device)
    return _int8_detnet(model, backbone, scales), report
