"""The four NT-Xent kernels, their plain versions, and the two losses built
on them (counterpart of ``simhand_tpu/losses/pallas_ntxent.py``).

Each wrapper takes a plain version's arguments. On CPU tensors it calls the
plain version. On CUDA tensors it launches its kernel from
``csrc/ntxent.cu`` on the current stream, or raises; it adds one to its
``launches`` count at each launch and nowhere else. The general signature
``(z_rows, z_cols, row_ids, ...)`` takes a shard of rows against all
columns, with ``row_ids`` the global ids that mask the self pair.

``nt_xent_kernel`` and ``weighted_nt_xent_kernel`` are the single-device
losses with a kernel forward and a kernel backward (the custom VJPs of
``pallas_ntxent.py:267-425``); neither ever holds a (2B, 2B) plane on the
card.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from simhand_tpu_torch import native

D = 128          # projection width the kernels are built for
_BM, _BN = 64, 64  # row block and column tile of csrc/ntxent.cu

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "ntxent_denominator": [_P, _P, _P, _I, _I, _F, _I, _P, _P, _P],
    "weighted_ntxent_denominator": [_P] * 6 + [_I, _I, _F, _I, _P, _P, _P],
    "ntxent_grad": [_P] * 5 + [_I, _I, _F, _I, _P, _P, _P],
    "weighted_grad_rows": [_P] * 8 + [_I, _I, _F, _I, _P, _P, _P],
}


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernels' library, built at first use, with its C signatures."""
    lib = native.load("ntxent")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.ntxent_error_string.argtypes = [ctypes.c_int]
    lib.ntxent_error_string.restype = ctypes.c_char_p
    return lib


# --------------------------------------------------------------------------
# plain versions: dense matmul, exp, mask, sum
# --------------------------------------------------------------------------

def _self_mask(row_ids: torch.Tensor, n_cols: int) -> torch.Tensor:
    cols = torch.arange(n_cols, device=row_ids.device)
    return cols[None, :] == row_ids[:, None].long()


def _weights_plain(j_rows, j_cols, d_max, d_min) -> torch.Tensor:
    """w_ij = (d_max - d_ij) / (d_max - d_min), d the mean joint distance."""
    jr = j_rows.reshape(j_rows.shape[0], 21, 2)
    jc = j_cols.reshape(j_cols.shape[0], 21, 2)
    dist = jr.new_zeros((jr.shape[0], jc.shape[0]))
    for k in range(21):
        dx = jr[:, k, 0, None] - jc[None, :, k, 0]
        dy = jr[:, k, 1, None] - jc[None, :, k, 1]
        dist = dist + torch.sqrt(dx * dx + dy * dy)
    return (d_max - dist * (1.0 / 21.0)) / (d_max - d_min)


def ntxent_denominator_plain(z_rows, z_cols, row_ids, temperature=0.5):
    sim = torch.exp((z_rows @ z_cols.T) / temperature)
    return torch.where(_self_mask(row_ids, z_cols.shape[0]), 0.0, sim).sum(dim=1)


def weighted_ntxent_denominator_plain(z_rows, z_cols, j_rows, j_cols, row_ids,
                                      d_max, d_min, temperature=0.5):
    w = _weights_plain(j_rows, j_cols, d_max, d_min)
    sim = torch.exp((z_rows @ z_cols.T) * w / temperature)
    return torch.where(_self_mask(row_ids, z_cols.shape[0]), 0.0, sim).sum(dim=1)


def ntxent_grad_plain(z_rows, z_cols, inv_rows, inv_cols, row_ids, temperature=0.5):
    s = torch.exp((z_rows @ z_cols.T) / temperature)
    g = s * (inv_rows[:, None] + inv_cols[None, :])
    g = torch.where(_self_mask(row_ids, z_cols.shape[0]), 0.0, g)
    return g @ z_cols


def weighted_grad_rows_plain(z_rows, z_cols, j_rows, j_cols, inv_rows, inv_cols,
                             row_ids, d_max, d_min, temperature=0.5):
    w = _weights_plain(j_rows, j_cols, d_max, d_min)
    g = torch.exp((z_rows @ z_cols.T) * w / temperature) * w * (
        inv_rows[:, None] + inv_cols[None, :]
    )
    g = torch.where(_self_mask(row_ids, z_cols.shape[0]), 0.0, g)
    return g @ z_cols


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU; raises on a mix of devices
    or on a device that is neither the CPU nor CUDA."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cpu"


def _check(t: torch.Tensor, name: str, shape: tuple, dtype=torch.float32):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_z(z_rows, z_cols) -> tuple[int, int]:
    m, n = z_rows.shape[0], z_cols.shape[0]
    if m == 0 or n == 0:
        raise ValueError("the kernels need at least one row and one column")
    _check(z_rows, "z_rows", (m, D))
    _check(z_cols, "z_cols", (n, D))
    if z_rows.data_ptr() % 16 or z_cols.data_ptr() % 16:
        raise ValueError("z_rows and z_cols must be 16-byte aligned (float4 loads)")
    return m, n


def _minmax(d_max: torch.Tensor, d_min: torch.Tensor) -> torch.Tensor:
    _check(d_max, "d_max", ())
    _check(d_min, "d_min", ())
    return torch.stack([d_max, d_min])


def _splits(m: int, n: int, device: torch.device) -> int:
    """Column splits of the grid: enough for about two blocks per SM when the
    row blocks alone are too few, but at most one per column tile (so 8 x 8
    = 64 blocks at 512 x 512). The partials are added in a second pass."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    row_blocks = math.ceil(m / _BM)
    return max(1, min(math.ceil(n / _BN), math.ceil(2 * sms / row_blocks)))


def _launch(name: str, inputs: list, m: int, n: int, temperature: float,
            out: torch.Tensor) -> None:
    lib = _library()
    splits = _splits(m, n, out.device)
    # partial (and the caller's temporaries) may be freed once this returns:
    # the caching allocator hands their memory only to work queued later on
    # the same stream, which runs after both kernels
    partial = out if splits == 1 else out.new_empty((splits, *out.shape))
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = getattr(lib, name)(
            *[t.data_ptr() for t in inputs], m, n, float(temperature), splits,
            partial.data_ptr(), out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{name}: CUDA error {err}: {lib.ntxent_error_string(err).decode()}"
        )


def ntxent_denominator(z_rows, z_cols, row_ids, temperature: float = 0.5):
    """neg_i = sum_{j != row_ids[i]} exp(z_i . z_j / T) -> (M,) float32."""
    if _on_cpu(z_rows, z_cols, row_ids):
        return ntxent_denominator_plain(z_rows, z_cols, row_ids, temperature)
    m, n = _check_z(z_rows, z_cols)
    _check(row_ids, "row_ids", (m,), torch.int32)
    out = z_rows.new_empty((m,))
    _launch("ntxent_denominator", [z_rows, z_cols, row_ids], m, n, temperature, out)
    ntxent_denominator.launches += 1
    return out


def weighted_ntxent_denominator(z_rows, z_cols, j_rows, j_cols, row_ids,
                                d_max, d_min, temperature: float = 0.5):
    """neg_i = sum_{j != row_ids[i]} exp(z_i . z_j * w_ij / T) -> (M,).

    j_rows (M, 21, 2) or (M, 42) and j_cols likewise are interleaved 2-D
    joints; d_max and d_min are 0-d tensors on the same device.
    """
    if _on_cpu(z_rows, z_cols, j_rows, j_cols, row_ids, d_max, d_min):
        return weighted_ntxent_denominator_plain(
            z_rows, z_cols, j_rows, j_cols, row_ids, d_max, d_min, temperature)
    m, n = _check_z(z_rows, z_cols)
    j_rows, j_cols = j_rows.reshape(m, 42), j_cols.reshape(n, 42)
    _check(j_rows, "j_rows", (m, 42))
    _check(j_cols, "j_cols", (n, 42))
    _check(row_ids, "row_ids", (m,), torch.int32)
    minmax = _minmax(d_max, d_min)
    out = z_rows.new_empty((m,))
    _launch("weighted_ntxent_denominator",
            [z_rows, z_cols, j_rows, j_cols, row_ids, minmax], m, n,
            temperature, out)
    weighted_ntxent_denominator.launches += 1
    return out


def ntxent_grad(z_rows, z_cols, inv_rows, inv_cols, row_ids,
                temperature: float = 0.5):
    """G_m = sum_{j != row_ids[m]} exp(z_m . z_j / T)(inv_m + inv_j) z_j
    -> (M, 128) float32."""
    if _on_cpu(z_rows, z_cols, inv_rows, inv_cols, row_ids):
        return ntxent_grad_plain(z_rows, z_cols, inv_rows, inv_cols, row_ids,
                                 temperature)
    m, n = _check_z(z_rows, z_cols)
    _check(inv_rows, "inv_rows", (m,))
    _check(inv_cols, "inv_cols", (n,))
    _check(row_ids, "row_ids", (m,), torch.int32)
    out = z_rows.new_empty((m, D))
    _launch("ntxent_grad", [z_rows, z_cols, inv_rows, inv_cols, row_ids], m, n,
            temperature, out)
    ntxent_grad.launches += 1
    return out


def weighted_grad_rows(z_rows, z_cols, j_rows, j_cols, inv_rows, inv_cols,
                       row_ids, d_max, d_min, temperature: float = 0.5):
    """G_m = sum_{j != row_ids[m]} exp(c_mj w_mj / T) w_mj (inv_m + inv_j) z_j
    -> (M, 128) float32, with w recomputed from the joints."""
    if _on_cpu(z_rows, z_cols, j_rows, j_cols, inv_rows, inv_cols, row_ids,
               d_max, d_min):
        return weighted_grad_rows_plain(z_rows, z_cols, j_rows, j_cols, inv_rows,
                                        inv_cols, row_ids, d_max, d_min,
                                        temperature)
    m, n = _check_z(z_rows, z_cols)
    j_rows, j_cols = j_rows.reshape(m, 42), j_cols.reshape(n, 42)
    _check(j_rows, "j_rows", (m, 42))
    _check(j_cols, "j_cols", (n, 42))
    _check(inv_rows, "inv_rows", (m,))
    _check(inv_cols, "inv_cols", (n,))
    _check(row_ids, "row_ids", (m,), torch.int32)
    minmax = _minmax(d_max, d_min)
    out = z_rows.new_empty((m, D))
    _launch("weighted_grad_rows",
            [z_rows, z_cols, j_rows, j_cols, inv_rows, inv_cols, row_ids, minmax],
            m, n, temperature, out)
    weighted_grad_rows.launches += 1
    return out


KERNELS = (ntxent_denominator, weighted_ntxent_denominator, ntxent_grad,
           weighted_grad_rows)
for _fn in KERNELS:
    _fn.launches = 0


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


# --------------------------------------------------------------------------
# the losses: kernel forward, kernel backward
# --------------------------------------------------------------------------

def _ids(n: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


class _NTXentKernelLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z1, z2, temperature):
        z = torch.cat([z1, z2], dim=0).contiguous()
        neg = ntxent_denominator(z, z, _ids(z.shape[0], z.device), temperature)
        pos = torch.sum(z1 * z2, dim=-1) / temperature
        loss = torch.mean(torch.log(neg) - torch.cat([pos, pos]))
        ctx.save_for_backward(z, neg)
        ctx.temperature = temperature
        return loss

    @staticmethod
    def backward(ctx, g):
        z, neg = ctx.saved_tensors
        n, b, t = z.shape[0], z.shape[0] // 2, ctx.temperature
        inv = 1.0 / neg
        denom_grad = ntxent_grad(z, z, inv, inv, _ids(n, z.device), t)
        # dL/dz_m = (denom_grad_m - 2 z_partner(m)) / (2B T)
        partner = torch.cat([z[b:], z[:b]], dim=0)
        dz = (denom_grad - 2.0 * partner) / (n * t) * g
        return dz[:b], dz[b:], None


class _WeightedNTXentKernelLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z1, z2, joints, pos_weights, minmax, temperature):
        z = torch.cat([z1, z2], dim=0).contiguous()
        n = z.shape[0]
        joints = joints.reshape(n, 42).contiguous()
        neg = weighted_ntxent_denominator(
            z, z, joints, joints, _ids(n, z.device), minmax[0], minmax[1],
            temperature)
        pos = torch.sum(z1 * z2, dim=-1) * pos_weights / temperature
        loss = torch.mean(torch.log(neg) - torch.cat([pos, pos]))
        ctx.save_for_backward(z, joints, pos_weights, minmax, neg)
        ctx.temperature = temperature
        return loss

    @staticmethod
    def backward(ctx, g):
        z, joints, pos_weights, minmax, neg = ctx.saved_tensors
        n, b, t = z.shape[0], z.shape[0] // 2, ctx.temperature
        inv = 1.0 / neg
        denom_grad = weighted_grad_rows(
            z, z, joints, joints, inv, inv, _ids(n, z.device), minmax[0],
            minmax[1], t)
        partner = torch.cat([z[b:], z[:b]], dim=0)
        pw2 = torch.cat([pos_weights, pos_weights])[:, None]
        dz = (denom_grad - 2.0 * pw2 * partner) / (n * t) * g
        return dz[:b], dz[b:], None, None, None, None


def nt_xent_kernel(z1: torch.Tensor, z2: torch.Tensor,
                   temperature: float = 0.5) -> torch.Tensor:
    """SimCLR NT-Xent through the kernels, forward and backward; the same
    function as ``losses.contrastive.nt_xent``."""
    return _NTXentKernelLoss.apply(z1, z2, temperature)


def weighted_nt_xent_kernel(z1, z2, joints, pos_weights, minmax,
                            temperature: float = 0.5) -> torch.Tensor:
    """The simhand_w weighted NT-Xent through the kernels.

    joints: (2B, 21, 2) stacked [joints1; joints2]; pos_weights: (B,);
    minmax: (2,) [d_max, d_min] of the pairwise joint distances. Gradients
    flow to z1 and z2 only.
    """
    return _WeightedNTXentKernelLoss.apply(z1, z2, joints, pos_weights, minmax,
                                           temperature)
