"""The BatchNorm fold and the structural walk of the frozen ResNet serving
forward (counterpart of ``simhand_tpu/serving/int8_infer.py``; same module
name, so a reader finds it).

* **BN folding**: every frozen conv+BN pair of the port's ``ContrastiveModel``
  collapses to one convolution with a per-output-channel bias,
  ``W' = W * gamma/sigma`` and ``b = beta - mu * gamma/sigma``, computed in
  float32 in the reference's order (``s = scale / sqrt(var + eps)``,
  ``b = bias - mean * s``, ``k * s``): every step is one correctly rounded
  IEEE operation, so the fold is bit-equal to the JAX package's (the
  square root is taken in float64 and rounded once, which is the correctly
  rounded float32 root; PyTorch's vectorized float32 ``sqrt`` on the CPU is
  not correctly rounded). The map
  keeps the reference's site keys (``"conv1"``, ``"layer4_1/conv2"``,
  ``"layer2_0/downsample"``); its kernels are PyTorch's OIHW.
* **The walk** (``_walk_resnet``) visits the ResNet once over an ops object,
  in NCHW views with channels-last strides (the input's NHWC memory, and
  every op keeps it), so an activation's memory is its NHWC tensor:
  ``ops.bottleneck_block.FoldedBf16Ops`` hands it to the convolution kernel
  (``ops/conv_bias.py``) without a copy, and that kernel raises on any other
  layout. Its ``block_override`` hook hands whole identity bottlenecks to
  kernel #12 (``ops/bottleneck_block.py``). ``_CalibOps`` interprets it in
  float32 (the fold's oracle, with ``maxes`` recording max|t| at every
  quantization point); ``FoldedBf16Ops`` in bf16, rounding once per
  convolution as the reference does.
* **The encoder surface**: ``fold_encoder_f32`` returns the embedding and
  the projection (the head's BatchNorm folded into its first dense layer).

The float32 convolutions follow ``torch.backends.cudnn.allow_tf32``, which
is on by default on a card: turn it off for an exact oracle.

Not in this module yet (no kernel runs there; ROADMAP Queue 1 item 13, W8A8
serving): ``_QuantOps``, ``quantize_folded``, ``build_encoder_int8``,
``_calibrate`` and the calibration batches, and the detnet surface with the
ops' ``quantize`` and ``out_f32`` that only it calls.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from simhand_tpu_torch.models.layers import same_pads

STAGE_SIZES = {
    "18": (2, 2, 2, 2),
    "34": (3, 4, 6, 3),
    "50": (3, 4, 6, 3),
    "101": (3, 4, 23, 3),
    "152": (3, 8, 36, 3),
}
_BOTTLENECK = ("50", "101", "152")


# ---------------------------------------------------------------------------
# BN folding
# ---------------------------------------------------------------------------

def _sqrt(t):
    """The correctly rounded float32 square root of a float32 tensor."""
    return torch.sqrt(t.double()).float()


def fold_conv_bn(weight, bn, eps: float = 1e-5):
    """(O, I, kh, kw) conv weight + a frozen BatchNorm module -> (folded
    float32 weight, float32 bias)."""
    with torch.no_grad():
        k = weight.detach().float()
        s = bn.weight.detach().float() / _sqrt(bn.running_var.float() + eps)
        b = bn.bias.detach().float() - bn.running_mean.float() * s
        return k * s.view(-1, 1, 1, 1), b


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


# ---------------------------------------------------------------------------
# the walk and its float32 interpretation
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

    def conv_bn_relu(self, key, x, stride, padding):
        return self._track(key, torch.relu(self.conv_bias(key, x, stride, padding)))

    def conv_bn(self, key, x, stride, padding):
        return self.conv_bias(key, x, stride, padding)

    def add_relu(self, key, y, shortcut):
        return self._track(key, torch.relu(y + shortcut))

    def maxpool(self, x):
        return _maxpool(x)

    def to_f32(self, x):
        return x


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
# encoder surface
# ---------------------------------------------------------------------------

def _projection_forward(emb, head):
    """The projection head with its BatchNorm folded into fc1, float32."""
    with torch.no_grad():
        bn = head.bn1
        s = bn.weight.float() / _sqrt(bn.running_var.float() + bn.eps)
        w1f = head.fc1.weight.float().T * s
        b1f = (head.fc1.bias.float() - bn.running_mean.float()) * s + bn.bias.float()
        z = torch.relu(emb @ w1f + b1f)
        return z @ head.fc2.weight.float().T


def fold_encoder_f32(model):
    """The float32 folded forward of the port's ``ContrastiveModel`` (the
    oracle for tests; no quantization): images (N, H, W, 3) -> {"embedding":
    (N, C), "projection": (N, D)}, float32, on the model's device. The
    backbone is the model's (the reference takes it as an argument)."""
    backbone = model.resnet_size
    fw = _fold_resnet(model.encoder, backbone)
    device = model.encoder.conv1.weight.device

    def forward(images):
        with torch.no_grad():
            emb = _walk_resnet(_CalibOps(fw), backbone, images.to(device), pool=True)
            return {"embedding": emb, "projection": _projection_forward(emb, model.projection_head)}

    return forward
