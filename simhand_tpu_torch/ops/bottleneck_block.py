"""One whole frozen bottleneck block, kernel #12 (counterpart of
``simhand_tpu/ops/bottleneck_block.py``), and the bf16 folded-BN serving
walk that runs every convolution on ``ops/conv_bias.py``'s kernel and hands
#12 the identity blocks it is told.

  bottleneck_block(x2d, w1, b1, w2, b2, w3, b3, hw=(H, W))
      h1 = bf16(relu(x2d @ w1.T + b1))
      h2 = bf16(relu(sum_t mask_t(shift_t(h1)) @ w2[:, t].T + b2))
      y  = bf16(relu((h2 @ w3.T + b3) + x2d))

x2d is the (M, C) bf16 plane of a channels-last activation, M = B*H*W
image-major. The weights are K-contiguous, as ``ops/conv1x1.py`` takes
them: w1 (Cm, C), w2 (Cm, 9, Cm) over ``TAPS`` (tap t = (dy + 1) * 3 + dx +
1, no kernel flip: ``W2[:, t] = conv2.weight[:, :, dy + 1, dx + 1]``), w3
(C, Cm); the biases are float32. ``fold_block_weights`` makes them from the
fold map once; the reference's (Cin, Cm), (9, Cm, Cm), (Cm, Cout) operands
are their transposes. Tap (dy, dx) of row r reads row r + dy*W + dx where
(py + dy, px + dx) lies inside r's image and zeros elsewhere, the 3x3
'SAME' padding; rows of another image are never read.

On CPU tensors the wrapper calls its plain version; on CUDA tensors it
runs the block as three launches of ``ops/conv_bias.conv_bias_act`` (the
kernel of ``csrc/conv_bias.cu``): the 1x1 with ReLU, the 3x3 'SAME' with
ReLU (w2's (Cm, 9, Cm) layout is already the kernel's tap-major K, and TMA's
zero fill of the taps outside the image is the mask), and the 1x1 with the
residual x and ReLU; or it raises. It adds one to
``bottleneck_block.launches`` per block run on the card. The kernel takes
bf16, C and Cm multiples of 8 and any number of images of any size.

``tap_mode``: the reference contracts the 3x3 as nine tap products
("loop") or one (M, 9*Cm) im2col product ("im2col"). Both add the same
9*Cm terms in the same tap-major order and differ only in float32
rounding, so the kernel has one K loop for both and the wrapper takes no
``tap_mode``; only the plain version keeps the two orders. The
reference's ``tile_rows`` (its VMEM row tile) has no counterpart either:
the kernel tiles whole images or image rows of its own size.

``FoldedBf16Ops`` is the bf16 interpretation of ``serving.int8_infer``'s
walk. Every convolution is ``conv_bias_act``: the float32 sum takes the
float32 bias (and ReLU) and is rounded once, as the reference's
``preferred_element_type=float32`` convolution does. ``add_relu`` adds the
rounded conv3 output and the shortcut in bf16 (float32 arithmetic, one
rounding), as the reference's walk does; blocks handed to #12 keep conv3's
sum in float32 up to the shortcut's add and round once.
"""
from __future__ import annotations

import torch

from simhand_tpu_torch.device import on_cpu
from simhand_tpu_torch.ops.conv_bias import conv_bias_act

TAPS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))


# --------------------------------------------------------------------------
# plain version (the reference's arithmetic, bottleneck_block.py:46-89)
# --------------------------------------------------------------------------

def _taps(h1, h: int, w: int):
    """The nine masked, row-shifted views of h1 in TAPS order."""
    pos = torch.arange(h1.shape[0], device=h1.device) % (h * w)
    py, px = pos // w, pos % w
    out = []
    for dy, dx in TAPS:
        off = dy * w + dx
        shifted = h1 if off == 0 else torch.roll(h1, -off, 0)
        valid = (py + dy >= 0) & (py + dy < h) & (px + dx >= 0) & (px + dx < w)
        out.append(torch.where(valid[:, None], shifted, torch.zeros_like(shifted)))
    return out


def bottleneck_block_plain(x2d, w1, b1, w2, b2, w3, b3, *, hw, tap_mode: str = "loop"):
    """The block in float32 products of x's dtype, rounded where the
    reference rounds; tap_mode "loop" or "im2col" picks the 3x3's order."""
    if tap_mode not in ("loop", "im2col"):
        raise ValueError(f"tap_mode must be 'loop' or 'im2col', got {tap_mode!r}")
    h, w = hw
    dt, cm = x2d.dtype, w1.shape[0]
    h1 = torch.relu(x2d.float() @ w1.float().T + b1).to(dt)
    taps = _taps(h1, h, w)
    if tap_mode == "im2col":
        acc = torch.cat(taps, 1).float() @ w2.float().reshape(cm, 9 * cm).T
    else:
        acc = torch.zeros(h1.shape, dtype=torch.float32, device=h1.device)
        for t, tap in enumerate(taps):
            acc += tap.float() @ w2[:, t].float().T
    h2 = torch.relu(acc + b2).to(dt)
    return torch.relu(h2.float() @ w3.float().T + b3 + x2d.float()).to(dt)


# --------------------------------------------------------------------------
# wrapper
# --------------------------------------------------------------------------

def _check(x2d, w1, b1, w2, b2, w3, b3):
    m, c = x2d.shape
    cm = w1.shape[0]
    shapes = {"x2d": (x2d, (m, c)), "w1": (w1, (cm, c)), "w2": (w2, (cm, 9, cm)),
              "w3": (w3, (c, cm))}
    for name, (t, shape) in shapes.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bfloat16, got {t.dtype}")
        if tuple(t.shape) != shape or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: expected a contiguous, 16-byte aligned {shape} tensor, "
                             f"got shape {tuple(t.shape)} strides {t.stride()}")
    for name, t, n in (("b1", b1, cm), ("b2", b2, cm), ("b3", b3, c)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,) or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous float32 ({n},) tensor")
    if c % 8 or cm % 8:
        raise ValueError(f"C={c} and Cm={cm} must be multiples of 8")


def three_convs(x2d, w1, b1, w2, b2, w3, b3, *, hw):
    """The block as three ``conv_bias_act`` calls, the kernel route's
    layouts: on CUDA tensors three launches, on CPU tensors their plain
    versions (so the CPU tests hold the composition)."""
    (h, w), (m, c), cm = hw, x2d.shape, w1.shape[0]
    x = x2d.view(m // (h * w), h, w, c)
    h1 = conv_bias_act(x, w1, b1, kernel=(1, 1), relu=True)
    h2 = conv_bias_act(h1, w2.view(cm, 9 * cm), b2, kernel=(3, 3), relu=True)
    return conv_bias_act(h2, w3, b3, kernel=(1, 1), relu=True, res=x).view(m, c)


def bottleneck_block(x2d, w1, b1, w2, b2, w3, b3, *, hw):
    """relu(x + conv1x1(relu(conv3x3(relu(conv1x1(x) + b1)) + b2)) + b3):
    identity shortcut (stride 1, C == Cout). See the module docstring for
    the layouts and the route on the card."""
    h, w = hw
    m, cin = x2d.shape
    if w3.shape[0] != cin:
        raise ValueError("identity-shortcut block needs Cin == Cout")
    img = h * w
    if m % img:
        raise ValueError(f"rows {m} not a multiple of H*W={img}")
    if on_cpu(x2d, w1, b1, w2, b2, w3, b3):
        return bottleneck_block_plain(x2d, w1, b1, w2, b2, w3, b3, hw=hw)
    _check(x2d, w1, b1, w2, b2, w3, b3)
    y = three_convs(x2d, w1, b1, w2, b2, w3, b3, hw=hw)
    bottleneck_block.launches += 1
    return y


bottleneck_block.launches = 0


def reset_launches() -> None:
    bottleneck_block.launches = 0


# ---------------------------------------------------------------------------
# folding + the bf16 serving walk
# ---------------------------------------------------------------------------

def fold_block_weights(fw: dict, name: str):
    """Folded (conv+BN) weights of one bottleneck block from the serving fold
    map (``int8_infer._fold_resnet``) -> the kernel's operands (w1, b1, w2,
    b2, w3, b3): bf16 weights, K-contiguous, float32 biases."""
    (k1, b1), (k2, b2), (k3, b3) = (fw[f"{name}/conv{i}"] for i in (1, 2, 3))
    cm = k1.shape[0]
    w1 = k1.reshape(cm, -1).to(torch.bfloat16).contiguous()
    # (Cm_out, Cm_in, 3, 3) -> (Cm_out, 9, Cm_in), tap t = ky * 3 + kx
    w2 = k2.permute(0, 2, 3, 1).reshape(cm, 9, cm).to(torch.bfloat16).contiguous()
    w3 = k3.reshape(k3.shape[0], cm).to(torch.bfloat16).contiguous()
    return w1, b1.float(), w2, b2.float(), w3, b3.float()


class FoldedBf16Ops:
    """bf16 folded-BN serving walk ops (the ``int8_infer._walk_resnet``
    interpretation): every convolution one ``conv_bias_act`` (float32 sum +
    bias, ReLU, one rounding), ``add_relu`` in bf16. The blocks of
    ``block_ops`` (name -> ``fold_block_weights`` operands) go to #12. The
    activations are NCHW views with channels-last strides, which the kernel
    takes as NHWC without a copy."""

    def __init__(self, fw: dict, block_ops: dict | None = None):
        # imported here, as the reference does: serving/ sits above ops/
        from simhand_tpu_torch.serving.int8_infer import _maxpool

        self._maxpool = _maxpool
        # OIHW -> (O, kh * kw * I), tap-major: the kernel's K order
        self.fw = {k: (w.permute(0, 2, 3, 1).reshape(w.shape[0], -1).to(torch.bfloat16)
                       .contiguous(), b.float(), tuple(w.shape[2:]))
                   for k, (w, b) in fw.items()}
        self.block_ops = block_ops or {}

    def input(self, key, x):
        return x.to(torch.bfloat16)

    def _conv(self, key, x, stride, padding, relu):
        w, b, kernel = self.fw[key]
        y = conv_bias_act(x.permute(0, 2, 3, 1), w, b, kernel=kernel, stride=stride,
                          padding=padding, relu=relu)
        return y.permute(0, 3, 1, 2)

    def conv_bn_relu(self, key, x, stride, padding):
        return self._conv(key, x, stride, padding, True)

    def conv_bn(self, key, x, stride, padding):
        return self._conv(key, x, stride, padding, False)

    def add_relu(self, key, y, shortcut):
        # a bf16 add sums in float32 and rounds once
        return torch.relu_(y + shortcut)

    def maxpool(self, x):
        return self._maxpool(x)

    def to_f32(self, x):
        return x.float()

    def block_override(self, name, x, stride, cin, cout):
        """Whole-block kernel takeover for registered identity blocks
        (``int8_infer._walk_resnet`` consults this hook); None for the
        others, a strided or projection block included."""
        ops = self.block_ops.get(name)
        if ops is None or stride != 1 or cin != cout:
            return None
        b, c, h, w = x.shape
        y = bottleneck_block(x.permute(0, 2, 3, 1).reshape(b * h * w, c), *ops, hw=(h, w))
        return y.view(b, h, w, c).permute(0, 3, 1, 2)


def make_folded_encoder_bf16(model, pallas_blocks: tuple = ()):
    """Frozen bf16 folded forward of the port's ``ContrastiveModel``'s
    encoder (embedding only): images (N, H, W, 3) -> (N, C) float32 on the
    model's device. The identity blocks named in ``pallas_blocks`` (the
    reference's name; e.g. ``("layer4_1", "layer4_2")``) run as kernel #12.
    The backbone is the model's; the reference's ``tap_mode`` and
    ``tile_rows`` select nothing on the card (module docstring)."""
    from simhand_tpu_torch.serving import int8_infer

    backbone = model.resnet_size
    fw = int8_infer._fold_resnet(model.encoder, backbone)
    ops = FoldedBf16Ops(fw, {name: fold_block_weights(fw, name) for name in pallas_blocks})
    device = model.encoder.conv1.weight.device

    def forward(images):
        with torch.no_grad():
            return int8_infer._walk_resnet(ops, backbone, images.to(device), pool=True)

    return forward
