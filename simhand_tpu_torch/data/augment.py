"""The augmentation of both views on the card (counterpart of
``simhand_tpu/data/augment.py``): the production input path's first stage.

The host hands over fixed 224x224 uint8 crops; everything else runs
batched on the images' device, as plain PyTorch ops:

  sobel -> cut-out -> gaussian blur -> [rotate + crop + resize as ONE
  inverse affine bilinear warp] -> HSV colour jitter -> gaussian noise ->
  colour drop -> ImageNet normalisation

``device_augment`` is split at its draws. PyTorch's random streams can
never match ``jax.random``, so ``sample_augment`` draws everything the JAX
function draws from its 12 keys (from an explicit ``torch.Generator`` on
the images' device, never the global one), and ``apply_augment`` is a pure
function of the images, the joints and those draws. The CPU tests feed
``apply_augment`` the draws that JAX's keys give and hold it against the
JAX function.

The crop box is computed in JAX's order and dtype, and the rotation's
cosine and sine (and the box's square root) through float64, so the box is
the same integer box on every device.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from simhand_tpu_torch.core.geometry import crop_box_from_joints, joint_mean
from simhand_tpu_torch.data.augment_cv2 import AugmentFlags, AugmentParams

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class AugmentedBatch(NamedTuple):
    images: torch.Tensor        # (B, out, out, 3) float32, ImageNet-normalised
    joints: torch.Tensor        # (B, 21, 3) post-augmentation 2.5D joints
    angle: torch.Tensor         # (B,)
    jitter_x: torch.Tensor      # (B,)
    jitter_y: torch.Tensor      # (B,)


class AugmentDraws(NamedTuple):
    """What ``device_augment`` draws from its 12 keys, for one view of B
    samples. A field whose flag is off is None. Coins are bool (B,)."""

    sobel: Optional[torch.Tensor] = None          # keys[0]
    cut_ratio: Optional[torch.Tensor] = None      # keys[1]: uniform(cut_out_fraction)
    cut_joint: Optional[torch.Tensor] = None      #          randint(0, 20)
    cut_fill: Optional[torch.Tensor] = None       #          randint(0, 255), float32
    cut: Optional[torch.Tensor] = None            # keys[2]
    blur_sigma: Optional[torch.Tensor] = None     # keys[3]: uniform(0.1, 2.0)
    blur: Optional[torch.Tensor] = None           # keys[4]
    angle: Optional[torch.Tensor] = None          # keys[5]: uniform(min, max) angle
    jitter: Optional[torch.Tensor] = None         # keys[6]: (B, 2) uniform(0, jitter max)
    margin: Optional[torch.Tensor] = None         # keys[7]: uniform(crop_margin_range)
    hue: Optional[torch.Tensor] = None            # keys[8], split in four
    sat: Optional[torch.Tensor] = None
    alpha: Optional[torch.Tensor] = None
    beta: Optional[torch.Tensor] = None
    noise: Optional[torch.Tensor] = None          # keys[10]: (B, out, out, 3) normal
    noisy: Optional[torch.Tensor] = None          #           and its coin
    drop: Optional[torch.Tensor] = None           # keys[11]


# --------------------------------------------------------------------------
# geometry: fused inverse-affine bilinear warp
# --------------------------------------------------------------------------

def affine_warp(images: torch.Tensor, mats: torch.Tensor, out_hw: tuple[int, int]
                ) -> torch.Tensor:
    """Warps (B, H, W, C) images by forward affines (B, 2, 3) into float32
    (B, out_h, out_w, C), bilinear, zero outside (``cv2.warpAffine``:
    dst(x, y) = src(A_inv @ (x, y))). uint8 images are gathered as they are
    and converted after, which gives the same values."""
    B, H, W, C = images.shape
    out_h, out_w = out_hw

    a, b, tx = mats[:, 0, 0], mats[:, 0, 1], mats[:, 0, 2]
    c, d, ty = mats[:, 1, 0], mats[:, 1, 1], mats[:, 1, 2]
    det = a * d - b * c
    ia, ib = d / det, -b / det
    ic, id_ = -c / det, a / det
    itx = -(ia * tx + ib * ty)
    ity = -(ic * tx + id_ * ty)

    dev = images.device
    gy, gx = torch.meshgrid(torch.arange(out_h, dtype=torch.float32, device=dev),
                            torch.arange(out_w, dtype=torch.float32, device=dev),
                            indexing="ij")

    def per(v):
        return v[:, None, None]

    sx = per(ia) * gx + per(ib) * gy + per(itx)
    sy = per(ic) * gx + per(id_) * gy + per(ity)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = (sx - x0)[..., None]
    wy = (sy - y0)[..., None]
    flat = images.reshape(B, H * W, C)

    def sample(yi, xi):
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        xi_c = xi.clamp(0, W - 1).long()
        yi_c = yi.clamp(0, H - 1).long()
        idx = (yi_c * W + xi_c).reshape(B, -1, 1).expand(-1, -1, C)
        vals = torch.gather(flat, 1, idx).reshape(B, out_h, out_w, C)
        return vals.float() * inside[..., None]

    v00 = sample(y0, x0)
    v01 = sample(y0, x0 + 1)
    v10 = sample(y0 + 1, x0)
    v11 = sample(y0 + 1, x0 + 1)
    return (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
            + v10 * (1 - wx) * wy + v11 * wx * wy)


def _rotation(center: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """``cv2.getRotationMatrix2D`` about (B, 2) centres by (B,) degrees, as
    ``core.geometry.opencv_rotation_matrix`` builds it, with the cosine and
    sine taken in float64 and rounded once: every device then gives the same
    float32 matrix."""
    rad = (angle * (math.pi / 180.0)).double()
    alpha, beta = torch.cos(rad).float(), torch.sin(rad).float()
    cx, cy = center[:, 0], center[:, 1]
    row0 = torch.stack([alpha, beta, (1.0 - alpha) * cx - beta * cy], dim=-1)
    row1 = torch.stack([-beta, alpha, beta * cx + (1.0 - alpha) * cy], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def _affine_points(points: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """(B, N, 2) points by (B, 2, 3) affines, one elementwise op at a time
    (a matmul sums in a device's own order)."""
    x, y = points[..., 0], points[..., 1]
    m = mat[:, :, None, :]
    return torch.stack([m[:, 0, :, 0] * x + m[:, 0, :, 1] * y + m[:, 0, :, 2],
                        m[:, 1, :, 0] * x + m[:, 1, :, 1] * y + m[:, 1, :, 2]], dim=-1)


# --------------------------------------------------------------------------
# photometric ops (batched, float [0, 255])
# --------------------------------------------------------------------------

def _select(i: torch.Tensor, choices: list) -> torch.Tensor:
    """choices[i] elementwise, for integer i in [0, len(choices))."""
    out = choices[-1]
    for k in range(len(choices) - 2, -1, -1):
        out = torch.where(i == k, choices[k], out)
    return out


def rgb_to_hsv_cv2(img: torch.Tensor) -> torch.Tensor:
    """OpenCV's 8-bit HSV ranges: H in [0, 180), S and V in [0, 255]. The
    reference converts RGB crops with COLOR_BGR2HSV, so channel 0 is taken
    as blue: the channels are reversed first."""
    bgr_as_rgb = img.flip(-1)
    r, g, b = bgr_as_rgb[..., 0], bgr_as_rgb[..., 1], bgr_as_rgb[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = v - mn
    s = torch.where(v > 0, 255.0 * diff / torch.clamp_min(v, 1e-6), 0.0)
    safe = torch.clamp_min(diff, 1e-6)
    h = torch.where(v == r, 30.0 * (g - b) / safe,
                    torch.where(v == g, 60.0 + 30.0 * (b - r) / safe,
                                120.0 + 30.0 * (r - g) / safe))
    h = torch.where(h < 0, h + 180.0, h)
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb_cv2(hsv: torch.Tensor) -> torch.Tensor:
    """Inverse of ``rgb_to_hsv_cv2`` (the same RGB-as-BGR layout)."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    h = torch.remainder(h, 180.0) / 30.0
    s = s / 255.0
    i = torch.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = torch.remainder(i.to(torch.int32), 6)
    r = _select(i, [v, q, p, p, t, v])
    g = _select(i, [t, v, v, q, p, p])
    b = _select(i, [p, p, t, v, v, q])
    return torch.stack([r, g, b], dim=-1).flip(-1)


def color_jitter(img: torch.Tensor, h_f: torch.Tensor, s_f: torch.Tensor,
                 a_f: torch.Tensor, b_f: torch.Tensor) -> torch.Tensor:
    """hue * h, saturation * s, value * a + b, each clipped to [0, 255]."""
    hsv = rgb_to_hsv_cv2(img)

    def per(v):
        return v[:, None, None]

    h = torch.clamp(hsv[..., 0] * per(h_f), 0, 255)
    s = torch.clamp(hsv[..., 1] * per(s_f), 0, 255)
    v = torch.clamp(hsv[..., 2] * per(a_f) + per(b_f), 0, 255)
    return hsv_to_rgb_cv2(torch.stack([h, s, v], dim=-1))


def grayscale_cv2_on_rgb(img: torch.Tensor) -> torch.Tensor:
    """cv2's BGR2GRAY applied to RGB data (the reference's quirk):
    0.114 R + 0.587 G + 0.299 B, on all three channels."""
    gray = 0.114 * img[..., 0] + 0.587 * img[..., 1] + 0.299 * img[..., 2]
    return gray[..., None].expand(*gray.shape, 3)


def sobel_filter(img: torch.Tensor) -> torch.Tensor:
    """Sobel x + Sobel y of the grayscale image (one 3x3 kernel, kx + kx.T,
    as a cross-correlation with 'SAME' zero padding), on all three
    channels."""
    gray = grayscale_cv2_on_rgb(img)[..., 0][:, None]            # (B, 1, H, W)
    kx = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=torch.float32,
                      device=img.device)
    out = F.conv2d(gray, (kx + kx.T)[None, None], padding=1)
    return out[:, 0, :, :, None].expand(-1, -1, -1, 3)


def gaussian_blur(img: torch.Tensor, sigma: torch.Tensor, ksize: int) -> torch.Tensor:
    """Separable gaussian with a per-sample sigma: horizontal, then vertical,
    'SAME' zero padding, as one grouped convolution over the B * C planes."""
    B, H, W, C = img.shape
    half = ksize // 2
    x = torch.arange(-half, half + 1, dtype=torch.float32, device=img.device)
    kern = torch.exp(-(x[None, :] ** 2) / (2 * sigma[:, None] ** 2))
    kern = kern / kern.sum(dim=1, keepdim=True)                  # (B, k)
    kern = kern.repeat_interleave(C, dim=0)                      # (B * C, k)
    planes = img.permute(0, 3, 1, 2).reshape(1, B * C, H, W)
    out = F.conv2d(planes, kern[:, None, None, :], padding=(0, half), groups=B * C)
    out = F.conv2d(out, kern[:, None, :, None], padding=(half, 0), groups=B * C)
    return out.reshape(B, C, H, W).permute(0, 2, 3, 1)


def cut_out(img: torch.Tensor, joints_xy: torch.Tensor, ratio: torch.Tensor,
            joint_idx: torch.Tensor, fill: torch.Tensor) -> torch.Tensor:
    """A rectangle around joint ``joint_idx`` (of side ratio * H by ratio *
    W) filled with ``fill``. The reference anchors it with x on dim 0 and y
    on dim 1, and so does this."""
    B, H, W, _ = img.shape
    idx = joint_idx.long()[:, None]
    cx = torch.gather(joints_xy[..., 0], 1, idx)[:, 0]
    cy = torch.gather(joints_xy[..., 1], 1, idx)[:, 0]
    d0 = (H * ratio).to(torch.int32)
    d1 = (W * ratio).to(torch.int32)
    top0 = (cx - d0 / 2).to(torch.int32)
    top1 = (cy - d1 / 2).to(torch.int32)
    rows = torch.arange(H, device=img.device)[None, :, None]
    cols = torch.arange(W, device=img.device)[None, None, :]

    def per(v):
        return v[:, None, None]

    mask = ((rows >= per(top0)) & (rows < per(top0 + d0))
            & (cols >= per(top1)) & (cols < per(top1 + d1)))
    return torch.where(mask[..., None], fill.to(img.dtype)[:, None, None, None], img)


def gaussian_noise(img: torch.Tensor, normal: torch.Tensor, std: float) -> torch.Tensor:
    """``cv2.randn`` into uint8: the noise (a standard normal plane times
    std) saturates at [0, 255], the add wraps modulo 256."""
    noise = torch.clamp(normal * std, 0.0, 255.0)
    return torch.remainder(img + torch.round(noise), 256.0)


# --------------------------------------------------------------------------
# the draws and the chain
# --------------------------------------------------------------------------

def sample_augment(generator: torch.Generator, B: int, H: int, flags: AugmentFlags,
                   params: AugmentParams, out_size: int = 128) -> AugmentDraws:
    """Everything ``device_augment`` draws for B samples of side H, from
    ``generator`` on its device, in the JAX function's key order. No draw
    depends on H (the blur's kernel size, which does, is set where the
    draws are applied); the noise plane is drawn at the output size."""
    dev = generator.device

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=generator, device=dev)

    def coin():
        return torch.rand(B, generator=generator, device=dev) < 0.5

    def randint(hi):
        return torch.randint(0, hi, (B,), generator=generator, device=dev, dtype=torch.int32)

    d = {}
    if flags.sobel_filter:
        d["sobel"] = coin()
    if flags.cut_out:
        d["cut_ratio"] = uniform(*params.cut_out_fraction, B)
        d["cut_joint"] = randint(20)
        d["cut_fill"] = randint(255).float()
        d["cut"] = coin()
    if flags.gaussian_blur:
        d["blur_sigma"] = uniform(0.1, 2.0, B)
        d["blur"] = coin()
    if flags.rotate:
        d["angle"] = uniform(params.min_angle, params.max_angle, B)
    if flags.crop:
        d["jitter"] = uniform(0.0, params.crop_box_jitter[1], B, 2)
    if flags.random_crop:
        d["margin"] = uniform(*params.crop_margin_range, B)
    if flags.color_jitter:
        d["hue"] = uniform(*params.hue_factor_range, B)
        d["sat"] = uniform(*params.sat_factor_range, B)
        d["alpha"] = uniform(*params.value_factor_alpha_range, B)
        d["beta"] = uniform(*params.value_factor_beta_range, B)
    if flags.gaussian_noise:
        d["noise"] = torch.randn(B, out_size, out_size, 3, generator=generator, device=dev)
        d["noisy"] = coin()
    if flags.color_drop:
        d["drop"] = coin()
    return AugmentDraws(**d)


class WarpBox(NamedTuple):
    angle: torch.Tensor         # (B,) degrees, integer-valued
    origin: torch.Tensor        # (B, 2) the crop box's corner, integer-valued
    side: torch.Tensor          # (B,) its side, integer-valued, >= 1
    jitter: torch.Tensor        # (B, 2) the recorded jitter
    mats: torch.Tensor          # (B, 2, 3) the warp: rotate, crop, resize


def warp_box(joints: torch.Tensor, draws: AugmentDraws, flags: AugmentFlags,
             params: AugmentParams, hw: tuple[int, int], out_size: int) -> WarpBox:
    """Rotate about the joints' centroid, crop a box around the rotated
    joints, resize to out_size: the one affine of the warp, for (B, 21, 3)
    float32 joints in an H x W image."""
    B, (H, W) = joints.shape[0], hw
    dev = joints.device
    if flags.rotate:
        angle = torch.floor(draws.angle)
    else:
        angle = torch.zeros(B, dtype=torch.float32, device=dev)
    rot = _rotation(torch.trunc(joint_mean(joints[..., :2])), angle)
    j_rot = _affine_points(joints[..., :2], rot)
    if flags.crop:
        jitter = torch.trunc(draws.jitter)
    else:
        jitter = torch.zeros(B, 2, dtype=torch.float32, device=dev)
    margin = draws.margin if flags.random_crop else params.crop_margin
    origin, side, rec_jitter = crop_box_from_joints(j_rot, margin, jitter)
    side = torch.clamp_min(side, 1.0)
    # the reference's crop is a numpy slice, truncated at the right and
    # bottom edges, and its resize stretches what is left with a scale per
    # axis
    w_c = torch.clamp_min(torch.clamp_max(origin[:, 0] + side, W) - origin[:, 0], 1.0)
    h_c = torch.clamp_min(torch.clamp_max(origin[:, 1] + side, H) - origin[:, 1], 1.0)
    scale_xy = torch.stack([out_size / w_c, out_size / h_c], dim=1)      # (B, 2)
    shift = torch.zeros_like(rot)
    shift[:, :, 2] = origin
    return WarpBox(angle, origin, side, rec_jitter, (rot - shift) * scale_xy[:, :, None])


def blur_ksize(side: int) -> int:
    """The blur's kernel: 10% of the image side, rounded up to odd."""
    k = int(side * 0.1)
    return k + 1 if k % 2 == 0 else k


def apply_augment(images: torch.Tensor, joints: torch.Tensor, draws: AugmentDraws,
                  flags: AugmentFlags, params: AugmentParams, out_size: int = 128
                  ) -> AugmentedBatch:
    """One view's augmentation chain on (B, H, W, 3) uint8 or float RGB
    images and (B, 21, 3) pixel-space 2.5D joints, given its draws."""
    B, H, W, _ = images.shape
    j = joints.float()
    img = images
    if flags.sobel_filter or flags.cut_out or flags.gaussian_blur:
        img = img.float()

    def pick(coin, a, b):
        return torch.where(coin[:, None, None, None], a, b)

    if flags.sobel_filter:
        img = pick(draws.sobel, sobel_filter(img), img)
    if flags.cut_out:
        cut = cut_out(img, j[..., :2], draws.cut_ratio, draws.cut_joint, draws.cut_fill)
        img = pick(draws.cut, cut, img)
    if flags.gaussian_blur:
        img = pick(draws.blur, gaussian_blur(img, draws.blur_sigma, blur_ksize(H)), img)

    box = warp_box(j, draws, flags, params, (H, W), out_size)
    img = affine_warp(img, box.mats, (out_size, out_size))
    j_aug = torch.cat([_affine_points(j[..., :2], box.mats), j[..., 2:]], dim=-1)

    if flags.color_jitter:
        img = color_jitter(img, draws.hue, draws.sat, draws.alpha, draws.beta)
    if flags.gaussian_noise:
        img = pick(draws.noisy, gaussian_noise(img, draws.noise, params.noise_std), img)
    if flags.color_drop:
        img = pick(draws.drop, grayscale_cv2_on_rgb(img), img)

    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=img.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=img.device)
    img = (torch.clamp(img, 0.0, 255.0) / 255.0 - mean) / std
    return AugmentedBatch(images=img, joints=j_aug, angle=box.angle,
                          jitter_x=box.jitter[:, 0], jitter_y=box.jitter[:, 1])


def device_augment(images: torch.Tensor, joints: torch.Tensor, generator: torch.Generator,
                   flags: AugmentFlags, params: AugmentParams, out_size: int = 128
                   ) -> AugmentedBatch:
    """One view's full augmentation chain, batched on the images' device."""
    B, H = images.shape[:2]
    draws = sample_augment(generator, B, H, flags, params, out_size)
    return apply_augment(images, joints, draws, flags, params, out_size)


def sample_views(generator: torch.Generator, raw: dict, flags: AugmentFlags,
                 params: AugmentParams, out_size: int = 128
                 ) -> tuple[AugmentDraws, AugmentDraws]:
    """The draws of view 1, then of view 2, from one generator (as the JAX
    function splits its key into k1 and k2)."""
    return tuple(sample_augment(generator, *raw[f"image{v}"].shape[:2], flags, params,
                                out_size) for v in (1, 2))


def apply_views(raw: dict, draws: tuple[AugmentDraws, AugmentDraws], flags: AugmentFlags,
                params: AugmentParams, out_size: int = 128) -> dict:
    """Raw batch -> the train step's batch, both views augmented with their
    draws. ``raw`` holds image{1,2} (B, 224, 224, 3) uint8, joints{1,2}
    (B, 21, 3) pixel-space 2.5D joints and joints_raw{1,2} (B, 21, 3)
    normalised joints."""
    v1, v2 = (apply_augment(raw[f"image{v}"], raw[f"joints{v}"], d, flags, params, out_size)
              for v, d in zip((1, 2), draws))

    def ori(jr):
        j = jr.float().clone()
        j[..., :2] *= float(out_size)
        return j

    return {
        "transformed_image1": v1.images, "transformed_image2": v2.images,
        "joints1_aug": v1.joints, "joints2_aug": v2.joints,
        "joints1_ori": ori(raw["joints_raw1"]), "joints2_ori": ori(raw["joints_raw2"]),
        "angle_1": v1.angle, "angle_2": v2.angle,
        "jitter_x_1": v1.jitter_x, "jitter_x_2": v2.jitter_x,
        "jitter_y_1": v1.jitter_y, "jitter_y_2": v2.jitter_y,
    }


def prepare_views(raw: dict, generator: torch.Generator, flags: AugmentFlags,
                  params: AugmentParams, out_size: int = 128) -> dict:
    """Raw batch -> the train step's batch, both views augmented on the
    generator's device. Same-image experiment types carry the same crop in
    both slots."""
    return apply_views(raw, sample_views(generator, raw, flags, params, out_size),
                       flags, params, out_size)


def seeded_generator(device, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integers ``key``, e.g. (0,
    step) for the train step's draws. Seeding sets the generator's state on
    the host; it waits for nothing on the card."""
    seed = int(np.random.SeedSequence(list(key)).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)
