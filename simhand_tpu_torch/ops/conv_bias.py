"""A bf16 convolution whose float32 sum takes the bias, an optional residual
and ReLU before its one rounding (the reference's
``conv_general_dilated(..., preferred_element_type=float32) + b`` of
``simhand_tpu/ops/bottleneck_block.py:186-204``, and the three convolutions
of kernel #12).

  conv_bias_act(x, w, b, kernel=(kh, kw), stride=s, padding=p, relu=r, res=None)
      y = bf16(act(conv(x, w) + b (+ res)))

x is a channels-last (N, H, W, Cin) bf16 activation (contiguous), w the
(Cout, kh * kw * Cin) bf16 weight, tap-major with Cin innermost
(``conv.weight.permute(0, 2, 3, 1).reshape(Cout, -1)`` of an OIHW weight), b
a float32 (Cout,) bias and res an (N, OH, OW, Cout) bf16 tensor. ``padding``
is "SAME" (XLA's: a stride-2 3x3 on an even input pads (0, 1), not (1, 1))
or ((top, bottom), (left, right)); reads outside the image are zeros. The
result is a contiguous (N, OH, OW, Cout) tensor.

On CPU tensors the wrapper calls its plain version; on CUDA tensors it
launches the kernel of ``csrc/conv_bias.cu`` on the current stream or
raises, and adds one to ``conv_bias_act.launches`` at each launch and
nowhere else. The kernel takes stride 1 or 2 and Cin and Cout multiples of 8
(TMA needs 16-byte rows). An input whose Cin is not (the stem's 3 channels)
is first gathered into its (M, kh * kw * Cin) patches, padded to a multiple
of 8 columns (147 -> 152: the kernel's 64-wide K boxes read TMA's zeros
past them), which the kernel runs as a 1x1 convolution: a copy of bf16
values, exact.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from simhand_tpu_torch import native
from simhand_tpu_torch.device import on_cpu
from simhand_tpu_torch.models.layers import same_pads

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signature."""
    lib = native.load("conv_bias")
    lib.conv_bias_act.argtypes = [_P] * 5 + [_I] * 13 + [_P]
    lib.conv_bias_act.restype = ctypes.c_int
    lib.conv_bias_error_string.argtypes = [ctypes.c_int]
    lib.conv_bias_error_string.restype = ctypes.c_char_p
    return lib


def conv_pads(h: int, w: int, kernel, stride: int, padding):
    """((top, bottom), (left, right)) of "SAME" (XLA's) or of explicit pads."""
    kh, kw = kernel
    if padding == "SAME":
        return same_pads(h, kh, stride), same_pads(w, kw, stride)
    (pt, pb), (pl, pr) = padding
    if min(pt, pb, pl, pr) < 0:
        raise ValueError(f"padding must not be negative, got {padding}")
    return (pt, pb), (pl, pr)


def out_size(h: int, w: int, kernel, stride: int, pads) -> tuple[int, int]:
    (pt, pb), (pl, pr) = pads
    return (h + pt + pb - kernel[0]) // stride + 1, (w + pl + pr - kernel[1]) // stride + 1


def patches(x, kernel, stride: int, pads, width: int | None = None):
    """The (N * OH * OW, width) rows of x's kh x kw windows, tap-major with
    Cin innermost (the weight's K order), zeros where a window leaves the
    image; columns past kh * kw * Cin are zeros (width defaults to that)."""
    n, _, _, cin = x.shape
    (kh, kw), ((pt, pb), (pl, pr)) = kernel, pads
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    win = xp.unfold(1, kh, stride).unfold(2, kw, stride)   # (N, OH, OW, Cin, kh, kw)
    oh, ow = win.shape[1], win.shape[2]
    k = kh * kw * cin
    width = k if width is None else width
    out = x.new_empty((n, oh, ow, width))
    out[..., :k].view(n, oh, ow, kh, kw, cin).copy_(win.permute(0, 1, 2, 4, 5, 3))
    out[..., k:].zero_()
    return out.view(n * oh * ow, width)


# --------------------------------------------------------------------------
# plain version (float32 sums of the bf16 products, one rounding)
# --------------------------------------------------------------------------

def conv_bias_act_plain(x, w, b, *, kernel, stride: int = 1, padding="SAME", relu: bool = False,
                        res=None):
    """The float32 product of x's windows and w (products of bf16 values are
    exact in float32; a float32 matmul, which does not take TF32 unless
    ``torch.backends.cuda.matmul.allow_tf32`` is set), + b (+ res), ReLU,
    then one rounding to x's dtype."""
    n, h, w_, _ = x.shape
    pads = conv_pads(h, w_, kernel, stride, padding)
    oh, ow = out_size(h, w_, kernel, stride, pads)
    y = patches(x.float(), kernel, stride, pads) @ w.float().T + b
    if res is not None:
        y = y + res.reshape(y.shape).float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype).view(n, oh, ow, -1)


# --------------------------------------------------------------------------
# wrapper
# --------------------------------------------------------------------------

def _check(x, w, b, res, kernel, stride):
    for name, t, dim in (("x", x, 4), ("w", w, 2), ("res", res, 4)):
        if t is None:
            continue
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bfloat16, got {t.dtype}")
        if t.dim() != dim or not t.is_contiguous() or t.data_ptr() % 16:
            layout = " (an activation channels-last, as (N, H, W, C))" if dim == 4 else ""
            raise ValueError(f"{name}: expected a contiguous, 16-byte aligned {dim}-D "
                             f"tensor{layout}, got shape {tuple(t.shape)} strides {t.stride()}")
    cin, cout = x.shape[3], w.shape[0]
    k = kernel[0] * kernel[1] * cin
    if w.shape[1] != k:
        raise ValueError(f"w: expected ({cout}, {k}) for a {kernel[0]}x{kernel[1]} kernel over "
                         f"{cin} channels, got {tuple(w.shape)}")
    if cout % 8:
        raise ValueError(f"Cout={cout} must be a multiple of 8")
    if b.dtype != torch.float32 or tuple(b.shape) != (cout,) or not b.is_contiguous():
        raise ValueError(f"b: expected a contiguous float32 ({cout},) tensor")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")


def _launch(x, w, b, kernel, stride, pads, relu, res):
    _check(x, w, b, res, kernel, stride)
    n, h, w_, cin = x.shape
    oh, ow = out_size(h, w_, kernel, stride, pads)
    if res is not None and tuple(res.shape) != (n, oh, ow, w.shape[0]):
        raise ValueError(f"res: expected {(n, oh, ow, w.shape[0])}, got {tuple(res.shape)}")
    (pt, pb), (pl, pr) = pads
    y = x.new_empty((n, oh, ow, w.shape[0]))
    # (N, H, W, Cin, OH, OW) as the kernel sees them
    geo = (n, h, w_, cin, oh, ow)
    if cin % 8:
        # the stem: its patches are a 1x1 convolution's input, one long row
        width = -(-kernel[0] * kernel[1] * cin // 8) * 8
        x = patches(x, kernel, stride, pads, width)
        w = F.pad(w, (0, width - w.shape[1]))
        geo, kernel, stride, pt, pl = (1, 1, n * oh * ow, width, 1, n * oh * ow), (1, 1), 1, 0, 0
    elif kernel == (1, 1) and stride == 1 and pt == pb == pl == pr == 0:
        geo = (1, 1, n * h * w_, cin, 1, n * h * w_)   # one long row: full 128-pixel tiles
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv_bias_act(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                res.data_ptr() if res is not None else None, y.data_ptr(),
                                *geo, w.shape[0], *kernel, stride, pt, pl, int(relu), stream)
    if err != 0:
        raise RuntimeError(f"conv_bias_act: CUDA error {err}: "
                           f"{lib.conv_bias_error_string(err).decode()}")
    return y


def conv_bias_act(x, w, b, *, kernel, stride: int = 1, padding="SAME", relu: bool = False,
                  res=None):
    """bf16(act(conv(x, w) + b (+ res))): x (N, H, W, Cin) channels-last, w
    (Cout, kh * kw * Cin) tap-major, b float32 (Cout,), res (N, OH, OW,
    Cout); see the module docstring."""
    kernel = tuple(kernel)
    n, h, w_, _ = x.shape
    pads = conv_pads(h, w_, kernel, stride, padding)
    if on_cpu(*(t for t in (x, w, b, res) if t is not None)):
        return conv_bias_act_plain(x, w, b, kernel=kernel, stride=stride, padding=pads,
                                   relu=relu, res=res)
    y = _launch(x, w, b, kernel, stride, pads, relu, res)
    conv_bias_act.launches += 1
    return y


conv_bias_act.launches = 0


def reset_launches() -> None:
    conv_bias_act.launches = 0
