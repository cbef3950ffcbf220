"""1x1 convolution (a matrix product) with a BatchNorm-statistics epilogue
(counterpart of ``simhand_tpu/ops/conv1x1.py``).

  conv1x1_stats(x2d, w)               y = x2d @ w.T rounded to x's dtype;
                                      s1, s2 = the column sums of y and y^2
  conv1x1_bn_relu_stats(x2d, w, A, B) the same on relu(x2d * A + B), per
                                      input channel, rounded to x's dtype

x2d is the (M, Cin) plane of a channels-last activation and w the
(Cout, Cin) weight (the reference takes (Cin, Cout)); A and B are float32
(Cin,) vectors. The statistics are float32 and are those of the rounded y,
as the reference's epilogue takes them.

On CPU tensors a wrapper calls its plain version (any float dtype); on CUDA
tensors it launches its kernel from ``csrc/conv1x1.cu`` on the current
stream or raises, and adds one to its ``launches`` count at each launch and
nowhere else. The kernels take bf16 (a TMA + wgmma GEMM on a persistent grid
of two-CTA clusters) or float32 (a tiled GEMM on the CUDA cores, not TF32),
x and w of the same dtype: Cin and Cout multiples of 8 (TMA needs 16-byte
row strides), any M. Their column sums go through a float32 scratch of one
(2, Cout) row per row group of the grid, sized by the library.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from simhand_tpu_torch import native
from simhand_tpu_torch.device import on_cpu

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "conv1x1_stats": [_P, _P] + [_I] * 3 + [_P] * 4,
    "conv1x1_bn_relu_stats": [_P] * 4 + [_I] * 3 + [_P] * 4,
}
_SIGNATURES.update({f"{name}_f32": args for name, args in _SIGNATURES.items()})
# the kernels' dtypes and the suffix of their entry points
_DTYPES = {torch.bfloat16: "", torch.float32: "_f32"}


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernels' library, built at first use, with its C signatures."""
    lib = native.load("conv1x1")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    for name in ("conv1x1_partial_floats", "conv1x1_partial_floats_f32"):
        getattr(lib, name).argtypes = [_I, _I]
        getattr(lib, name).restype = ctypes.c_int
    lib.conv1x1_error_string.argtypes = [ctypes.c_int]
    lib.conv1x1_error_string.restype = ctypes.c_char_p
    return lib


# --------------------------------------------------------------------------
# plain versions (the reference's arithmetic, conv1x1.py:26-57)
# --------------------------------------------------------------------------

def conv1x1_stats_plain(x2d, w):
    y = (x2d.float() @ w.float().T).to(x2d.dtype)
    y32 = y.float()
    return y, y32.sum(0), (y32 * y32).sum(0)


def conv1x1_bn_relu_stats_plain(x2d, w, A, B):
    return conv1x1_stats_plain(torch.relu(x2d.float() * A + B).to(x2d.dtype), w)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def _check(x2d, w, consts):
    if x2d.dtype not in _DTYPES or w.dtype != x2d.dtype:
        raise TypeError(f"x2d, w: the kernels take bfloat16 or float32, both alike; got "
                        f"{x2d.dtype} and {w.dtype}")
    for name, t in (("x2d", x2d), ("w", w)):
        if t.dim() != 2 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: expected a contiguous, 16-byte aligned row-major "
                             f"matrix, got shape {tuple(t.shape)} strides {t.stride()}")
    (m, cin), (cout, k) = x2d.shape, w.shape
    if k != cin or m == 0:
        raise ValueError(f"w: expected ({cout}, {cin}) for x2d of shape {tuple(x2d.shape)}, "
                         f"got {tuple(w.shape)}")
    if cin % 8 or cout % 8:
        raise ValueError(f"Cin={cin} and Cout={cout} must be multiples of 8")
    for name, t in consts.items():
        if t.dtype != torch.float32 or tuple(t.shape) != (cin,) or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous float32 ({cin},) tensor")


def _launch(name, x2d, w, consts):
    _check(x2d, w, consts)
    m, cout = x2d.shape[0], w.shape[0]
    y = x2d.new_empty((m, cout))
    out = x2d.new_empty((2, cout), dtype=torch.float32)
    lib = _library()
    suffix = _DTYPES[x2d.dtype]
    name += suffix
    with torch.cuda.device(x2d.device):
        # one (2, Cout) row per row group of the grid; freed on return (the
        # caching allocator hands it only to work queued later on this
        # stream, which runs after both passes)
        floats = getattr(lib, "conv1x1_partial_floats" + suffix)(m, cout)
        if floats < 0:
            raise RuntimeError(f"{name}: cannot read the device's cluster occupancy")
        partial = out.new_empty(floats)
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        err = getattr(lib, name)(x2d.data_ptr(), w.data_ptr(),
                                 *[t.data_ptr() for t in consts.values()],
                                 m, cout, x2d.shape[1], y.data_ptr(), partial.data_ptr(),
                                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}: {lib.conv1x1_error_string(err).decode()}")
    return y, out[0], out[1]


def conv1x1_stats(x2d, w):
    """(y, s1, s2): y = x2d @ w.T in x's dtype, s1/s2 the float32 column sums
    of y and y^2. w is (Cout, Cin)."""
    if on_cpu(x2d, w):
        return conv1x1_stats_plain(x2d, w)
    out = _launch("conv1x1_stats", x2d, w, {})
    conv1x1_stats.launches += 1
    return out


def conv1x1_bn_relu_stats(x2d, w, A, B):
    """conv1x1_stats of relu(x2d * A + B) (float32 A, B per input channel)."""
    if on_cpu(x2d, w, A, B):
        return conv1x1_bn_relu_stats_plain(x2d, w, A, B)
    out = _launch("conv1x1_bn_relu_stats", x2d, w, dict(A=A, B=B))
    conv1x1_bn_relu_stats.launches += 1
    return out


KERNELS = (conv1x1_stats, conv1x1_bn_relu_stats)
for _fn in KERNELS:
    _fn.launches = 0


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0
