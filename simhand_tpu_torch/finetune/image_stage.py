"""The detnet sample builder's image stage on the batch's device: the same
function as the ``cv2`` calls of ``simhand_tpu/finetune/datasets.py``
(``photometric_augment``'s blur and colour jitter, then
``transform_img_cv2``'s crop), batched in torch, with no ``cv2``.

The 8-bit steps whose arithmetic OpenCV defines exactly are reproduced bit
for bit:

* ``GaussianBlur(ksize=(0, 0), sigmaX=r)`` on uint8, its fixed-point path:
  ``ksize = round(6r + 1) | 1``, the taps rounded to 8 fraction bits with
  error diffusion (their sum exactly 256), a horizontal pass of exact
  integer sums, a vertical one rounded half up at 16 fraction bits,
  ``BORDER_REFLECT_101``.
* ``cvtColor(COLOR_RGB2HSV)`` on uint8, its integer path (12-bit reciprocal
  tables, H in [0, 180)), in the true channel order.

The float steps are the reference's arithmetic written once, in float32:
the luma weights as one product and sum, the contrast op's mean in float64
rounded to float32, ``COLOR_HSV2RGB`` as ``v (1 - s x)`` times 255
truncated, and ``warpAffine``'s bilinear (zero border) from cv2's inverse
map, rounded half to even. numpy, OpenBLAS and OpenCV order and fuse these
steps as their build's vector code does, so the images agree with the JAX
builder's to a stated limit (``tests/test_torch_finetune_data.py``), and
the stage gives the same bits on the card and on the CPU.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

# photometric_augment's ops, in the order the reference defines them
BRIGHTNESS, SATURATION, HUE, CONTRAST = range(4)
BLUR_TAPS = 5          # the widest kernel a blur radius <= 0.5 gives
_LUMA = tuple(float(np.float32(w)) for w in (0.299, 0.587, 0.114))


class ImageDraws(NamedTuple):
    """One sample's image stage, drawn on the host.

    ``inverse``: cv2's inverse map of the crop's affine, float32 (6,).
    ``blur``: the fixed-point blur kernel, int32 (BLUR_TAPS,) summing to 256
    (the identity when there is no blur). ``factors``: the brightness,
    saturation and contrast factors and the hue shift in cv2's hue units,
    (4,), or None without photometric ops. ``order``: the op indices in the
    order they run.
    """

    inverse: np.ndarray
    blur: Optional[np.ndarray] = None
    factors: Optional[tuple] = None
    order: tuple = ()


def identity_kernel() -> np.ndarray:
    k = np.zeros(BLUR_TAPS, np.int32)
    k[BLUR_TAPS // 2] = 256
    return k


def gaussian_kernel_u8(sigma: float) -> np.ndarray:
    """cv2's bit-exact 8-bit gaussian for ``ksize=(0, 0)``, centred in
    BLUR_TAPS taps: float64 taps exp(-x^2 / (2 sigma^2)) normalised, then
    rounded to 8 fraction bits with error diffusion from the edges in, the
    centre taking what makes the sum 256."""
    n = int(np.rint(sigma * 3 * 2 + 1)) | 1
    if n > BLUR_TAPS:
        raise ValueError(f"sigma {sigma} needs {n} taps, more than {BLUR_TAPS}")
    out = identity_kernel()
    if n == 1:
        return out
    half = (n - 1) // 2
    scale = -0.125 / (sigma * sigma)
    values = [math.exp(float(x * x) * scale) for x in range(1 - n, 0, 2)]
    norm = 1.0 / (2.0 * sum(values) + 1.0)
    err, total = 0.0, 0
    off = BLUR_TAPS // 2 - half
    for i, v in enumerate(values):
        adj = v * norm * 256.0 + err
        q = int(np.rint(adj))
        err = adj - q
        out[off + i] = out[off + n - 1 - i] = q
        total += q
    out[BLUR_TAPS // 2] = 256 - 2 * total
    return out


def _reflect101(n: int, pad: int, device) -> torch.Tensor:
    i = torch.arange(-pad, n + pad, device=device)
    i = torch.where(i < 0, -i, i)
    return torch.where(i >= n, 2 * n - 2 - i, i)


def blur_u8(frames: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """cv2.GaussianBlur of uint8 (B, H, W, C) frames, each by its own
    fixed-point kernel (B, BLUR_TAPS) int32; uint8 out."""
    B, H, W, _ = frames.shape
    pad = BLUR_TAPS // 2
    k = kernels.to(torch.int32)[:, :, None, None, None]
    x = frames.to(torch.int32)
    cols = x[:, :, _reflect101(W, pad, x.device)]
    h = sum(k[:, j] * cols[:, :, j:j + W] for j in range(BLUR_TAPS))
    rows = h[:, _reflect101(H, pad, x.device)]
    v = sum(k[:, j] * rows[:, j:j + H] for j in range(BLUR_TAPS))
    return ((v + 32768) >> 16).clamp(0, 255).to(torch.uint8)


def rgb_to_hsv_u8(img: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(COLOR_RGB2HSV) of uint8 (..., 3): integer (..., 3)."""
    x = img.to(torch.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = torch.maximum(torch.maximum(b, g), r)
    diff = v - torch.minimum(torch.minimum(b, g), r)
    # cv2's 12-bit reciprocal tables, 0 at 0 (rounded half to even, as
    # cvRound does), made on the host
    i = torch.arange(256, dtype=torch.float64)
    sdiv = torch.where(i > 0, torch.round((255 << 12) / i), 0.0).to(torch.int32).to(x.device)
    hdiv = torch.where(i > 0, torch.round((180 << 12) / (6.0 * i)), 0.0)
    hdiv = hdiv.to(torch.int32).to(x.device)
    s = (diff * sdiv[v] + 2048) >> 12
    h = torch.where(v == r, g - b, torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + 2048) >> 12
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb_u8(hsv: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(COLOR_HSV2RGB) of 8-bit HSV (..., 3) (H in [0, 180)):
    uint8 (..., 3), the float path with its result times 255 truncated."""
    f = hsv.float()
    h = f[..., 0] * float(np.float32(6.0 / 180))
    s = f[..., 1] * float(np.float32(1 / 255))
    v = f[..., 2] * float(np.float32(1 / 255))
    sector = torch.floor(h)
    h = h - sector
    tab = torch.stack([v, v * (1 - s), v * (1 - s * h), v * (1 - s * (1 - h))], dim=-1)
    # (b, g, r) taken from tab by sector
    sectors = torch.tensor([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]],
                           device=hsv.device)
    pick = sectors[sector.long() % 6]
    rgb = torch.gather(tab, -1, pick).flip(-1) * 255.0
    return torch.trunc(rgb).clamp(0, 255).to(torch.uint8)


def gray_f32(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``x @ float32([0.299, 0.587, 0.114])`` of float32
    (..., 3): the three products summed in order."""
    w0, w1, w2 = _LUMA
    return (x[..., 0] * w0 + x[..., 1] * w1) + x[..., 2] * w2


def mean_f32(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``mean()`` of each row of float32 (R, n): summed and
    divided in float64, rounded to float32 (the same bits on every device
    but for a double rounding, with a chance of about 2^-29 a row)."""
    return x.double().mean(dim=1).float()


def _per(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None, None]


def photometric_op(op: int, x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """One of photometric_augment's jitter ops on float32 (N, H, W, 3), each
    sample by its factor (N,) (the hue op: its shift in cv2's hue units)."""
    if op == BRIGHTNESS:
        return x * _per(factor)
    if op == SATURATION:
        gray = gray_f32(x)[..., None]
        return gray + (x - gray) * _per(factor)
    if op == HUE:
        hsv = rgb_to_hsv_u8(x.clamp(0, 255).to(torch.uint8))
        hue = torch.remainder(hsv[..., 0] + _per(factor.to(torch.int32))[..., 0], 180)
        return hsv_to_rgb_u8(torch.stack([hue, hsv[..., 1], hsv[..., 2]], dim=-1)).float()
    if op == CONTRAST:
        mean = mean_f32(gray_f32(x).reshape(x.shape[0], -1))
        return _per(mean) + (x - _per(mean)) * _per(factor)
    raise ValueError(f"unknown photometric op {op}")


def photometric(frames: torch.Tensor, draws: Sequence[ImageDraws]) -> torch.Tensor:
    """photometric_augment on uint8 (B, H, W, 3) frames: the blur, then each
    sample's ops in its own order; uint8 out."""
    dev = frames.device
    kernels = torch.from_numpy(np.stack([d.blur for d in draws])).to(dev)
    x = blur_u8(frames, kernels).float()
    factors = torch.tensor([d.factors for d in draws], dtype=torch.float64)
    for rnd in range(max(len(d.order) for d in draws)):
        for op in range(4):
            rows = [b for b, d in enumerate(draws) if len(d.order) > rnd and d.order[rnd] == op]
            if not rows:
                continue
            f = factors[rows, op]
            f = f.to(torch.int32) if op == HUE else f.float()
            idx = torch.tensor(rows, device=dev)
            x[idx] = photometric_op(op, x[idx], f.to(dev))
    return x.clamp(0, 255).to(torch.uint8)


def cv2_inverse_map(affine: np.ndarray) -> np.ndarray:
    """The inverse map cv2.warpAffine derives in float64 from the float32
    forward affine (2, 3), as float32 (6,)."""
    m = affine[:2].astype(np.float32).astype(np.float64).reshape(-1).copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m.astype(np.float32)


def warp_affine_u8(frames: torch.Tensor, inverse: torch.Tensor, out_hw) -> torch.Tensor:
    """cv2.warpAffine of uint8 (B, H, W, C) frames by float32 inverse maps
    (B, 6) into uint8 (B, out_h, out_w, C): bilinear, zero outside."""
    B, H, W, C = frames.shape
    out_h, out_w = out_hw
    dev = frames.device
    m = [inverse[:, i][:, None, None] for i in range(6)]
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)[None, None, :]
    sx = m[0] * xs + (ys * m[1] + m[2])
    sy = m[3] * xs + (ys * m[4] + m[5])
    fx, fy = torch.floor(sx), torch.floor(sy)
    ax, ay = (sx - fx)[..., None], (sy - fy)[..., None]
    x0, y0 = fx.long(), fy.long()
    flat = frames.reshape(B, H * W, C)

    def tap(yi, xi):
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(B, -1, 1).expand(-1, -1, C)
        vals = torch.gather(flat, 1, idx).reshape(B, out_h, out_w, C)
        return vals.float() * inside[..., None]

    p00, p01, p10, p11 = tap(y0, x0), tap(y0, x0 + 1), tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    top = p00 + ax * (p01 - p00)
    bottom = p10 + ax * (p11 - p10)
    return torch.round(top + ay * (bottom - top)).clamp(0, 255).to(torch.uint8)


def image_stage(frames: Sequence[np.ndarray], draws: Sequence[ImageDraws], inp_res: int,
                device) -> torch.Tensor:
    """The builder's images of one batch: photometric ops where drawn, the
    crop to inp_res^2, then ``/255 - 0.5``; float32 (B, inp_res, inp_res, 3)
    on ``device``. Frames of one shape go through the stage together."""
    out = torch.empty((len(frames), inp_res, inp_res, 3), dtype=torch.float32, device=device)
    # float32(v) / 255 - 0.5 for every 8-bit v, divided on the host (CUDA
    # divides a tensor by a host scalar as a product with its reciprocal)
    normalized = (torch.arange(256, dtype=torch.float32) / 255.0 - 0.5).to(device)
    groups: dict = {}
    for i, f in enumerate(frames):
        groups.setdefault(f.shape, []).append(i)
    for rows in groups.values():
        x = torch.from_numpy(np.stack([frames[i] for i in rows])).to(device)
        group = [draws[i] for i in rows]
        jitter = [d.factors is not None for d in group]
        if any(jitter):
            if not all(jitter):
                raise ValueError("a batch mixes samples with and without photometric ops")
            x = photometric(x, group)
        inverse = torch.from_numpy(np.stack([d.inverse for d in group])).to(device)
        img = warp_affine_u8(x, inverse, (inp_res, inp_res))
        out[torch.tensor(rows, device=device)] = normalized[img.long()]
    return out
