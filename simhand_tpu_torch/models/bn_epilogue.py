"""Fused train-mode BatchNorm + ReLU (and + residual + ReLU) with a kernel
backward (counterpart of ``simhand_tpu/models/bn_epilogue.py``).

The forward is plain PyTorch: one-pass float32 statistics
(``var = E[x^2] - mu^2``), the per-channel affine ``y = A x + B`` with A and
B rounded to the compute dtype, then ReLU. The backward never holds the
ReLU mask from the forward: the reduces recompute it in float32 from the
saved ``x`` (``A x + B (+ r) > 0``, with A and B in float32, so near 0 it
may disagree with the forward's bf16 output: that is the reference's
semantics). Per channel c over the M = N*H*W rows, the four kernels compute

  masked_dual_reduce      sum(dy), sum(dy * xhat)         dy = g * mask
  masked_dx               dx = P (dy - k1 - xhat k2)      xhat = C x + D
  masked_dual_reduce_res  the same sums with y = A x + B + r, and dres = dy
  masked_dx_res           dx from dres and x

with A = scale*inv, B = bias - mu*A, C = inv, D = -mu*inv, P = scale*inv,
k1 = sum(dy)/M and k2 = sum(dy*xhat)/M; dscale = sum(dy*xhat) and dbias =
sum(dy) in float32. The residual pair moves 7 (M, C) planes: the reduce
reads g, x and r and writes dres (dy is g or 0, so dres holds it exactly);
the dx pass reads dres and x and writes dx. All four are bound by memory.

Each wrapper takes its plain version's tensors with the channel on dim 1:
(M, C) planes or NCHW activations with channels-last strides, whose memory
is the row-major (M, C) plane. On CPU tensors it calls the plain version;
on CUDA tensors it launches its kernel from ``csrc/bn_epilogue.cu`` on the
current stream or raises, and adds one to its ``launches`` count at each
launch and nowhere else.

With an ``axis`` (``parallel.mesh``; set by ``ContrastiveModel.
sync_batch_norms`` for the FSDP step), the statistics are those of the
global batch, as in the reference's GSPMD step: the forward's (sum x,
sum x^2) are all-reduced in one collective of 2C float32 values a site and
divided by the global row count; in the backward the reduce (#5 or #7, or
its plain version) sums this rank's rows, one collective all-reduces its
(sum dy, sum dy*xhat), and the dx pass (#6 or #8) takes k1 and k2 over the
global rows. dres is elementwise and stays local, and so do the parameter
gradients (this rank's sums; the FSDP step sums them over the ranks).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from simhand_tpu_torch import native
from simhand_tpu_torch.device import on_cpu
from simhand_tpu_torch.models.layers import BatchNorm2d, update_running_stats

_CTAS_PER_SM = 2       # the persistent grid of #5-#9
_MIN_CTA_BYTES = 16384  # fewest bytes of a plane a CTA of that grid walks
_RING_SPAN = 2048      # channels of a CTA's row lane on the ring: C divides it
_STAGE_PLANE = 8192    # bytes of a plane in a stage of the ring
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "masked_dual_reduce": [_P] * 6 + [_I] * 5 + [_P, _P, _P],
    "masked_dx": [_P] * 9 + [_I] * 5 + [_P, _P],
    "masked_dual_reduce_res": [_P] * 7 + [_I] * 5 + [_P, _P, _P, _P],
    "masked_dx_res": [_P] * 7 + [_I] * 5 + [_P, _P],
    # kernel #9 of models/fused_bn.py, in the same source
    "dual_reduce": [_P] * 4 + [_I] * 5 + [_P, _P, _P],
}


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernels' library, built at first use, with its C signatures."""
    lib = native.load("bn_epilogue")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.bn_epilogue_error_string.argtypes = [ctypes.c_int]
    lib.bn_epilogue_error_string.restype = ctypes.c_char_p
    lib.bn_ring_fits.argtypes = [_I, _I, ctypes.POINTER(_P), _I]
    lib.bn_ring_fits.restype = ctypes.c_int
    return lib


# --------------------------------------------------------------------------
# plain versions over (M, C) planes, float32 arithmetic in the reference's
# order (the impl="xla" branches of bn_epilogue.py:225-235 and :357-368)
# --------------------------------------------------------------------------

def _dy_xhat(g2d, x2d, r2d, A, B, C, D):
    x32 = x2d.float()
    y = x32 * A + B
    if r2d is not None:
        y = y + r2d.float()
    dy = torch.where(y > 0, g2d.float(), 0.0)
    return dy, x32 * C + D


def _dx(dy, xhat, P, k1, k2, dtype):
    return (P * (dy - k1 - xhat * k2)).to(dtype)


def masked_dual_reduce_plain(g2d, x2d, A, B, C, D):
    dy, xhat = _dy_xhat(g2d, x2d, None, A, B, C, D)
    return dy.sum(0), (dy * xhat).sum(0)


def masked_dx_plain(g2d, x2d, A, B, C, D, P, k1, k2):
    dy, xhat = _dy_xhat(g2d, x2d, None, A, B, C, D)
    return _dx(dy, xhat, P, k1, k2, x2d.dtype)


def masked_dual_reduce_res_plain(g2d, x2d, r2d, A, B, C, D):
    dy, xhat = _dy_xhat(g2d, x2d, r2d, A, B, C, D)
    return dy.sum(0), (dy * xhat).sum(0), dy.to(r2d.dtype)


def masked_dx_res_plain(dres2d, x2d, C, D, P, k1, k2):
    return _dx(dres2d.float(), x2d.float() * C + D, P, k1, k2, x2d.dtype)


# --------------------------------------------------------------------------
# layout: channel on dim 1, memory channels-last
# --------------------------------------------------------------------------

def as_rows(t: torch.Tensor) -> torch.Tensor:
    """The (M, C) plane of a tensor with its channel on dim 1: a view for a
    channels-last tensor, a copy otherwise."""
    return t.movedim(1, -1).reshape(-1, t.shape[1])


def from_rows(t2d: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The (M, C) plane back in ``like``'s shape, with channels-last strides."""
    return t2d.reshape(like.movedim(1, -1).shape).movedim(-1, 1)


def _plane(t: torch.Tensor, name: str, like: torch.Tensor | None = None) -> torch.Tensor:
    """The row-major (M, C) view the kernels read; raises on a dtype or a
    layout they do not take."""
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name}: expected float32 or bfloat16, got {t.dtype}")
    if like is not None and (t.dtype != like.dtype or t.shape != like.shape):
        raise ValueError(f"{name}: expected {like.dtype} {tuple(like.shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if t.dim() < 2 or t.numel() == 0:
        raise ValueError(f"{name}: expected a non-empty (M, C) or NCHW tensor")
    rows = t.movedim(1, -1)
    if not rows.is_contiguous():
        raise ValueError(f"{name}: must be channels-last contiguous "
                         "(an (M, C) plane or torch.channels_last)")
    return rows.view(-1, t.shape[1])


def _gradient_plane(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    # a copy when autograd hands the gradient in another layout (the mean
    # pool's backward, for one, hands an expanded tensor)
    return _plane(g.movedim(1, -1).contiguous().movedim(-1, 1), "g", x)


def _consts(consts, c: int):
    for name, t in consts.items():
        if t.dtype != torch.float32 or tuple(t.shape) != (c,) or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous float32 ({c},) tensor")
    return [t.data_ptr() for t in consts.values()]


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _persistent_grid(m: int, c: int, esize: int, device: torch.device) -> tuple[int, int]:
    """(rows a CTA walks, CTAs) of #5-#9: _CTAS_PER_SM per SM,
    each taking one contiguous share of the rows, at least _MIN_CTA_BYTES of
    a plane."""
    ctas = max(1, min(_CTAS_PER_SM * _sm_count(device), m * c * esize // _MIN_CTA_BYTES))
    rows = math.ceil(m / ctas)
    return rows, math.ceil(m / rows)


def _call(name: str, *args) -> None:
    lib = _library()
    err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(
            f"{name}: CUDA error {err}: {lib.bn_epilogue_error_string(err).decode()}")


def _launch(name: str, planes, consts, grid, outs) -> None:
    """Launches ``name`` on the current stream of the planes' device with
    the pointers of the planes (checked (M, C) planes of one dtype) and the
    constants, M, C, the dtype, the grid and the outputs' pointers."""
    m, c = planes[0].shape
    ptrs = _consts(consts, c)
    device = planes[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _call(name, *[t.data_ptr() for t in planes], *ptrs, m, c, _DTYPES[planes[0].dtype],
              *grid, *[t.data_ptr() for t in outs], stream)


def ring_fits(c: int, esize: int, *ptrs: int) -> bool:
    """Whether #5-#9 take the bulk-copy ring for C channels of
    esize bytes with planes at the base addresses ptrs, or else the
    per-element walk; mirrors ``bn_ring_fits`` of csrc/bn_epilogue.cu."""
    return (c % 8 == 0 and _RING_SPAN % c == 0 and c * esize <= _STAGE_PLANE
            and all(p % 16 == 0 for p in ptrs))


def kernel_ring_fits(c: int, dtype: torch.dtype, *ptrs: int) -> bool:
    """The same question put to the built library (needs nvcc)."""
    arr = (_P * len(ptrs))(*ptrs)
    return bool(_library().bn_ring_fits(c, _DTYPES[dtype], arr, len(ptrs)))


def _reduce(name: str, planes, consts, *more_outs) -> torch.Tensor:
    """Launches the reduce ``name`` (#5, #7 or #9) on the persistent grid of
    planes[1]; returns its (2, C) sums. The (ctas, 2, C) partial sums are
    freed on return (the caching allocator hands them only to work queued
    later on this stream, which runs after both passes)."""
    m, c = planes[1].shape
    grid = _persistent_grid(m, c, planes[1].element_size(), planes[1].device)
    out = planes[1].new_empty((2, c), dtype=torch.float32)
    partial = out if grid[1] == 1 else out.new_empty((grid[1], 2, c))
    _launch(name, planes, consts, grid, [partial, out, *more_outs])
    return out


def _dx_launch(name: str, src, x2d, consts) -> torch.Tensor:
    """Launches the dx kernel ``name`` (#6 from g, #8 from dres) on the
    persistent grid of x2d; returns its (M, C) dx."""
    dx = torch.empty_like(x2d)
    _launch(name, [src, x2d], consts,
            _persistent_grid(*x2d.shape, x2d.element_size(), x2d.device), [dx])
    return dx


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def masked_dual_reduce(g, x, A, B, C, D):
    """(sum dy, sum dy*xhat) per channel, float32; dy = g*[A x + B > 0]."""
    if on_cpu(g, x, A, B, C, D):
        return masked_dual_reduce_plain(as_rows(g), as_rows(x), A, B, C, D)
    x2d = _plane(x, "x")
    out = _reduce("masked_dual_reduce", [_gradient_plane(g, x), x2d], dict(A=A, B=B, C=C, D=D))
    masked_dual_reduce.launches += 1
    return out[0], out[1]


def masked_dx(g, x, A, B, C, D, P, k1, k2):
    """dx = P (dy - k1 - xhat k2) in x's dtype, shape and layout."""
    if on_cpu(g, x, A, B, C, D, P, k1, k2):
        return from_rows(masked_dx_plain(as_rows(g), as_rows(x), A, B, C, D, P, k1, k2), x)
    x2d = _plane(x, "x")
    dx = _dx_launch("masked_dx", _gradient_plane(g, x), x2d,
                    dict(A=A, B=B, C=C, D=D, P=P, k1=k1, k2=k2))
    masked_dx.launches += 1
    return from_rows(dx, x)


def masked_dual_reduce_res(g, x, r, A, B, C, D):
    """(sum dy, sum dy*xhat, dres = dy) with the mask of A x + B + r > 0;
    dres in r's dtype, shape and layout."""
    if on_cpu(g, x, r, A, B, C, D):
        sum_dy, sum_dyx, dres = masked_dual_reduce_res_plain(as_rows(g), as_rows(x),
                                                             as_rows(r), A, B, C, D)
        return sum_dy, sum_dyx, from_rows(dres, r)
    x2d = _plane(x, "x")
    planes = [_gradient_plane(g, x), x2d, _plane(r, "residual", x)]
    dres = torch.empty_like(x2d)
    out = _reduce("masked_dual_reduce_res", planes, dict(A=A, B=B, C=C, D=D), dres)
    masked_dual_reduce_res.launches += 1
    return out[0], out[1], from_rows(dres, r)


def masked_dx_res(dres, x, C, D, P, k1, k2):
    """dx = P (dres - k1 - xhat k2) in x's dtype, shape and layout; dres is
    masked_dual_reduce_res's."""
    if on_cpu(dres, x, C, D, P, k1, k2):
        return from_rows(masked_dx_res_plain(as_rows(dres), as_rows(x), C, D, P, k1, k2), x)
    x2d = _plane(x, "x")
    dx = _dx_launch("masked_dx_res", _plane(dres, "dres", x), x2d,
                    dict(C=C, D=D, P=P, k1=k1, k2=k2))
    masked_dx_res.launches += 1
    return from_rows(dx, x)


KERNELS = (masked_dual_reduce, masked_dx, masked_dual_reduce_res, masked_dx_res)
for _fn in KERNELS:
    _fn.launches = 0


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


# --------------------------------------------------------------------------
# the autograd Functions: plain forward, kernel (or plain) backward
# --------------------------------------------------------------------------

def _channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (C,) vector broadcast along dim 1 of x."""
    return v.view(1, -1, *([1] * (x.dim() - 2)))


def rows(x: torch.Tensor, axis=None) -> int:
    """The rows a BatchNorm of x reduces over: this rank's, times the ranks."""
    return x.numel() // x.shape[1] * (1 if axis is None else axis.size)


def batch_stats(x: torch.Tensor, eps: float, axis=None):
    """(mu, var, inv) per channel in float32, var = E[x^2] - mu^2; with an
    axis over the global batch: the ranks' (sum x, sum x^2) in one
    all-reduce, over the global row count."""
    dims = [d for d in range(x.dim()) if d != 1]
    x32 = x.float()
    if axis is None:
        mu = x32.mean(dims)
        var = (x32 * x32).mean(dims) - mu * mu
    else:
        sums = axis.reduce_raw(torch.stack([x32.sum(dims), (x32 * x32).sum(dims)]), "sum")
        mu, m2 = sums / rows(x, axis)
        var = m2 - mu * mu
    return mu, var, torch.rsqrt(var + eps)


def global_sums(axis, sum_dy: torch.Tensor, sum_dyx: torch.Tensor):
    """The ranks' (sum dy, sum dy*xhat): one all-reduce of 2C float32 values
    (the sums themselves without an axis)."""
    if axis is None:
        return sum_dy, sum_dyx
    return axis.reduce_raw(torch.stack([sum_dy, sum_dyx]), "sum").unbind()


def _affine_consts(mu, inv, scale, bias):
    """y = A x + B, xhat = C x + D (all float32)."""
    A = scale.float() * inv
    return A, bias.float() - mu * A, inv, -mu * inv


def bn_affine(x, mu, inv, scale, bias):
    """The affine of flax-numerics BatchNorm: A = inv*scale and B = bias -
    mu*A in float32, rounded to x's dtype, then y = x*A + B (two roundings
    in bf16)."""
    A = inv * scale.float()
    B = bias.float() - mu * A
    return x * _channel(A.to(x.dtype), x) + _channel(B.to(x.dtype), x)


def _bn_apply(x, mu, inv, scale, bias, residual=None):
    y = bn_affine(x, mu, inv, scale, bias)
    if residual is not None:
        y = y + residual
    return torch.relu(y)


class BNReluTrain(torch.autograd.Function):
    """y = relu(bn(x)) in train mode; returns (y, mu, var). impl="kernel"
    runs the backward through the kernel wrappers, impl="plain" through the
    plain versions on any device; an axis takes the global batch's
    statistics."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, impl, axis=None):
        mu, var, inv = batch_stats(x, eps, axis)
        ctx.save_for_backward(x, mu, inv, scale, bias)
        ctx.impl, ctx.axis = impl, axis
        ctx.mark_non_differentiable(mu, var)
        return _bn_apply(x, mu, inv, scale, bias), mu, var

    @staticmethod
    def backward(ctx, g, _dmu, _dvar):
        x, mu, inv, scale, bias = ctx.saved_tensors
        m = rows(x, ctx.axis)
        A, B, C, D = _affine_consts(mu, inv, scale, bias)
        P = scale.float() * inv
        if ctx.impl == "kernel":
            sum_dy, sum_dyx = masked_dual_reduce(g, x, A, B, C, D)
            k_dy, k_dyx = global_sums(ctx.axis, sum_dy, sum_dyx)
            dx = masked_dx(g, x, A, B, C, D, P, k_dy / m, k_dyx / m)
        else:
            g2d, x2d = as_rows(g), as_rows(x)
            sum_dy, sum_dyx = masked_dual_reduce_plain(g2d, x2d, A, B, C, D)
            k_dy, k_dyx = global_sums(ctx.axis, sum_dy, sum_dyx)
            dx = from_rows(masked_dx_plain(g2d, x2d, A, B, C, D, P, k_dy / m, k_dyx / m), x)
        return dx, sum_dyx.to(scale.dtype), sum_dy.to(bias.dtype), None, None, None


class BNAddReluTrain(torch.autograd.Function):
    """y = relu(bn(x) + residual) in train mode; returns (y, mu, var)."""

    @staticmethod
    def forward(ctx, x, residual, scale, bias, eps, impl, axis=None):
        mu, var, inv = batch_stats(x, eps, axis)
        ctx.save_for_backward(x, residual, mu, inv, scale, bias)
        ctx.impl, ctx.axis = impl, axis
        ctx.mark_non_differentiable(mu, var)
        return _bn_apply(x, mu, inv, scale, bias, residual), mu, var

    @staticmethod
    def backward(ctx, g, _dmu, _dvar):
        x, r, mu, inv, scale, bias = ctx.saved_tensors
        m = rows(x, ctx.axis)
        A, B, C, D = _affine_consts(mu, inv, scale, bias)
        P = scale.float() * inv
        if ctx.impl == "kernel":
            sum_dy, sum_dyx, dres = masked_dual_reduce_res(g, x, r, A, B, C, D)
            k_dy, k_dyx = global_sums(ctx.axis, sum_dy, sum_dyx)
            dx = masked_dx_res(dres, x, C, D, P, k_dy / m, k_dyx / m)
        else:
            x2d = as_rows(x)
            sum_dy, sum_dyx, dres2d = masked_dual_reduce_res_plain(as_rows(g), x2d, as_rows(r),
                                                                   A, B, C, D)
            k_dy, k_dyx = global_sums(ctx.axis, sum_dy, sum_dyx)
            dx = from_rows(masked_dx_res_plain(dres2d, x2d, C, D, P, k_dy / m, k_dyx / m), x)
            dres = from_rows(dres2d, r)
        return dx, dres, sum_dyx.to(scale.dtype), sum_dy.to(bias.dtype), None, None, None


class BNRelu(BatchNorm2d):
    """relu(bn(x)) or relu(bn(x) + residual) with flax BatchNorm numerics
    and the kernel backward (``impl="kernel"``) or its plain version
    (``impl="plain"``, the reference's ``impl="xla"``).

    A BatchNorm2d, so its state-dict keys, the weight-decay mask and the
    initialisation are those of the exact BatchNorm. The output has the
    input's dtype; statistics are float32. Its ``axis`` (None until
    ``ContrastiveModel.sync_batch_norms`` sets one) gives train mode the
    global batch's statistics.
    """

    def __init__(self, c: int, momentum: float = 0.9, eps: float = 1e-5,
                 impl: str = "kernel"):
        super().__init__(c, momentum, eps)
        if impl not in ("kernel", "plain"):
            raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
        self.impl = impl

    def forward(self, x: torch.Tensor, residual: torch.Tensor | None = None):
        if residual is not None:
            residual = residual.to(x.dtype)
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps)
            return _bn_apply(x, self.running_mean, inv, self.weight, self.bias, residual)
        if residual is None:
            y, mu, var = BNReluTrain.apply(x, self.weight, self.bias, self.eps, self.impl,
                                           self.axis)
        else:
            y, mu, var = BNAddReluTrain.apply(x, residual, self.weight, self.bias,
                                              self.eps, self.impl, self.axis)
        update_running_stats(self, mu, var)
        return y
