"""One whole frozen bottleneck block in one kernel (counterpart of
``simhand_tpu/ops/bottleneck_block.py``), and the bf16 folded-BN serving
walk that hands it the identity blocks it is told.

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
launches kernel #12 from ``csrc/bottleneck_block.cu`` on the current stream
or raises, and adds one to ``bottleneck_block.launches`` at each launch and
nowhere else. The kernel takes bf16, C and Cm multiples of 64, and a block
of whole images whose h1 and h2 fit in shared memory with its tiles (227
KB): ResNet-50's layer4 and layer3 at 128x128 and 224x224 fit, layer1 at
128x128 (1,024 rows an image) does not and raises ``ValueError``.

``tap_mode``: the reference contracts the 3x3 as nine tap products
("loop") or one (M, 9*Cm) im2col product ("im2col"). Both add the same
9*Cm terms in the same tap-major order and differ only in float32
rounding, so the kernel has one K loop for both and the wrapper takes no
``tap_mode``; only the plain version keeps the two orders. The
reference's ``tile_rows`` (its VMEM row tile) has no counterpart either:
the kernel's block holds whole images and picks its own size.

``FoldedBf16Ops`` is the bf16 interpretation of ``serving.int8_infer``'s
walk. Its convolutions are bf16 ``F.conv2d`` (cuDNN on the card), which
round their float32 sums to bf16 before the float32 bias is added and the
result rounded again: one rounding more than the reference's
``preferred_element_type=float32`` convolution, and the fast route a
serving forward takes on this card. The tests state the tolerance this
costs against the JAX walk. Blocks handed to the kernel round their conv3
output once (in float32 up to the shortcut's add), where the walk rounds
it before ``add_relu``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from simhand_tpu_torch import native
from simhand_tpu_torch.device import on_cpu

TAPS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures."""
    lib = native.load("bottleneck_block")
    lib.bottleneck_block.argtypes = [_P] * 7 + [_I] * 6 + [_P, _P]
    lib.bottleneck_block.restype = ctypes.c_int
    lib.bottleneck_block_smem_bytes.argtypes = [_I, _I]
    lib.bottleneck_block_smem_bytes.restype = ctypes.c_size_t
    lib.bottleneck_block_smem_limit.argtypes = []
    lib.bottleneck_block_smem_limit.restype = ctypes.c_size_t
    lib.bottleneck_block_error_string.argtypes = [ctypes.c_int]
    lib.bottleneck_block_error_string.restype = ctypes.c_char_p
    return lib


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

def _block_rows(m: int, img: int) -> int:
    """A kernel block's rows: whole images, at least 32 rows where there are
    that many (the tensor cores' tile), no more than M."""
    return img * min(max(1, 32 // img), m // img)


def _launch(x2d, w1, b1, w2, b2, w3, b3, h: int, w: int):
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
    if c % 64 or cm % 64:
        raise ValueError(f"C={c} and Cm={cm} must be multiples of 64")
    lib = _library()
    rows = _block_rows(m, h * w)
    smem, limit = lib.bottleneck_block_smem_bytes(rows, cm), lib.bottleneck_block_smem_limit()
    if smem > limit:
        raise ValueError(
            f"a block of {rows // (h * w)} image(s) of {h}x{w} at Cm={cm} needs {smem} bytes of "
            f"shared memory for h1, h2 and its tiles; the limit is {limit} (227 KB)")
    y = torch.empty_like(x2d)
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        err = lib.bottleneck_block(x2d.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                                   b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), m, c, cm, h, w,
                                   rows, y.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bottleneck_block: CUDA error {err}: "
                           f"{lib.bottleneck_block_error_string(err).decode()}")
    return y


def bottleneck_block(x2d, w1, b1, w2, b2, w3, b3, *, hw):
    """relu(x + conv1x1(relu(conv3x3(relu(conv1x1(x) + b1)) + b2)) + b3) in
    one kernel: identity shortcut (stride 1, C == Cout). See the module
    docstring for the layouts."""
    h, w = hw
    m, cin = x2d.shape
    if w3.shape[0] != cin:
        raise ValueError("identity-shortcut block needs Cin == Cout")
    img = h * w
    if m % img:
        raise ValueError(f"rows {m} not a multiple of H*W={img}")
    if on_cpu(x2d, w1, b1, w2, b2, w3, b3):
        return bottleneck_block_plain(x2d, w1, b1, w2, b2, w3, b3, hw=hw)
    y = _launch(x2d, w1, b1, w2, b2, w3, b3, h, w)
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
    interpretation): bf16 convolutions, float32 bias, ReLU, back to bf16
    (the module docstring says where it rounds), two bf16 passes after each
    convolution. The blocks of ``block_ops`` (name -> ``fold_block_weights``
    operands) go to kernel #12."""

    def __init__(self, fw: dict, block_ops: dict | None = None):
        # imported here, as the reference does: serving/ sits above ops/
        from simhand_tpu_torch.serving.int8_infer import _conv, _maxpool

        self._conv, self._maxpool = _conv, _maxpool
        self.fw = {k: (w.to(torch.bfloat16), b.float()) for k, (w, b) in fw.items()}
        self.block_ops = block_ops or {}

    def input(self, key, x):
        return x.to(torch.bfloat16)

    def _conv_bias(self, key, x, stride, padding):
        """bf16(conv(x) + b): the float32 bias added in float32 and rounded
        once, in one pass (PyTorch computes a mixed add in float32 and
        casts on store)."""
        w, b = self.fw[key]
        y = self._conv(x, w, stride, padding)
        return torch.add(y, b.view(1, -1, 1, 1), out=torch.empty_like(y))

    def conv_bn_relu(self, key, x, stride, padding):
        # bf16(relu(v)) == relu(bf16(v)): rounding keeps the sign
        return torch.relu_(self._conv_bias(key, x, stride, padding))

    def conv_bn(self, key, x, stride, padding):
        return self._conv_bias(key, x, stride, padding)

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
