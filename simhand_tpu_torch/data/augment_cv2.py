"""The augmentation flags and parameters, and the host augmenter with the
reference's OpenCV semantics (counterpart of
``simhand_tpu/data/augment_cv2.py``).

``HostAugmenter.transform`` is the parity path: it applies the reference
chain on the host, in its fixed order

  sobel -> cut_out -> gaussian_blur -> rotate -> crop -> resize ->
  color_jitter -> gaussian_noise -> color_drop

drawing from the caller's ``np.random.Generator`` in the JAX package's
order, so a seed gives the JAX package's outputs bit for bit. The
reference's quirks are kept:
  * rotation angle = floor(uniform(min, max)) about the *joint centroid*;
  * crop box: square of side 2*int(max_joint_radius * margin) anchored at
    max(centroid - side + jitter, 0); the recorded jitter is
    centroid - side - origin;
  * color jitter converts with COLOR_BGR2HSV although frames are RGB;
  * gaussian noise is added into uint8 with wraparound; sobel/color-drop
    write float results into the uint8 frame with C-cast truncation.

``cv2`` is imported inside ``transform``: the flags and parameters, and
everything the card's path needs, import without it.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class AugmentFlags:
    color_drop: bool = False
    color_jitter: bool = False
    crop: bool = False
    cut_out: bool = False
    gaussian_blur: bool = False
    random_crop: bool = False
    resize: bool = True
    rotate: bool = False
    gaussian_noise: bool = False
    sobel_filter: bool = False


@dataclasses.dataclass(frozen=True)
class AugmentParams:
    crop_margin: float = 1.25
    crop_margin_range: tuple = (0.9, 1.5)
    cut_out_fraction: tuple = (0.0, 0.16)
    hue_factor_range: tuple = (0.01, 1.0)
    min_angle: float = -45.0
    max_angle: float = 45.0
    resize_shape: tuple = (128, 128)
    sat_factor_range: tuple = (0.01, 1.0)
    value_factor_alpha_range: tuple = (0.5, 1.0)
    value_factor_beta_range: tuple = (5.0, 20.0)
    crop_box_jitter: tuple = (0.0, 15.0)
    sobel_kernel: int = 3
    noise_std: float = 25.0


@dataclasses.dataclass
class AppliedParams:
    """Random parameters actually applied to one view (the reference's
    get_random_augment_param contract, data_set.py:804-838)."""

    angle: float | None = None
    jitter_x: float | None = None
    jitter_y: float | None = None
    h: float | None = None
    s: float | None = None
    a: float | None = None
    b: float | None = None
    blur_flag: bool = False
    crop_margin_scale: float = 1.5


class HostAugmenter:
    def __init__(self, flags: AugmentFlags, params: AugmentParams):
        self.flags = flags
        self.params = params

    # -- geometry helpers ---------------------------------------------------

    def _crop_geometry(self, joints, jitter, crop_margin, rng):
        p = self.params
        if crop_margin is None:
            if self.flags.random_crop:
                crop_margin = float(rng.uniform(*p.crop_margin_range))
            else:
                crop_margin = p.crop_margin
        center_x = int(np.mean(joints[:, 0]))
        center_y = int(np.mean(joints[:, 1]))
        side = int(
            np.sqrt(
                np.max((joints[:, 1] - center_y) ** 2 + (joints[:, 0] - center_x) ** 2)
            )
            * crop_margin
        )
        if jitter is None:
            jitter = [
                int(rng.uniform(0, p.crop_box_jitter[1])),
                int(rng.uniform(0, p.crop_box_jitter[1])),
            ]
        origin_x = max(center_x - side + jitter[0], 0)
        origin_y = max(center_y - side + jitter[1], 0)
        rec_x = center_x - side - origin_x
        rec_y = center_y - side - origin_y
        return origin_x, origin_y, 2 * side, rec_x, rec_y, crop_margin

    # -- the chain ----------------------------------------------------------

    def transform(
        self,
        image: np.ndarray,
        joints: np.ndarray,
        rng: np.random.Generator,
        override_angle: float | None = None,
        override_jitter: list | None = None,
    ):
        """Returns (image, joints, 3x3 transform matrix, AppliedParams)."""
        import cv2

        p = self.params
        f = self.flags
        img = image.copy()
        j = np.asarray(joints, dtype=np.float32).copy()
        T = np.identity(3)
        applied = AppliedParams()

        if f.sobel_filter and rng.integers(0, 2):
            gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
            sx = cv2.Sobel(gray, cv2.CV_64F, 1, 0, ksize=p.sobel_kernel)
            sy = cv2.Sobel(gray, cv2.CV_64F, 0, 1, ksize=p.sobel_kernel)
            img[:, :, :] = (sx + sy).reshape(list(img.shape[:2]) + [1])

        if f.cut_out and rng.integers(0, 2):
            center_joint = int(rng.integers(0, 20))
            ratio = float(rng.uniform(*p.cut_out_fraction))
            c0 = int(j[center_joint, 0] - img.shape[0] * ratio / 2)
            c1 = int(j[center_joint, 1] - img.shape[1] * ratio / 2)
            d0, d1 = int(img.shape[0] * ratio), int(img.shape[1] * ratio)
            b0 = np.clip([c0, c0 + d0], 0, img.shape[0])
            b1 = np.clip([c1, c1 + d1], 0, img.shape[1])
            img[b0[0] : b0[1], b1[0] : b1[1]] = np.uint8(rng.integers(0, 255))

        if f.gaussian_blur and rng.integers(0, 2):
            applied.blur_flag = True
            ksize = tuple(
                i + 1 if i % 2 == 0 else i
                for i in (np.array(img.shape[:2]) * 0.1).astype(int)
            )
            sigma = float(rng.uniform(0.1, 2.0))
            img = cv2.GaussianBlur(img, ksize, sigma)

        if f.rotate or override_angle is not None:
            angle = (
                float(rng.uniform(p.min_angle, p.max_angle)) // 1
                if override_angle is None
                else override_angle
            )
            applied.angle = angle
            # rotate about the joint centroid (crop geometry w/ margin 0).
            cx, cy = int(np.mean(j[:, 0])), int(np.mean(j[:, 1]))
            rot = cv2.getRotationMatrix2D((cx, cy), angle, 1.0)
            h, w = img.shape[:2]
            img = cv2.warpAffine(img, rot, (w, h))
            homo = np.concatenate([j[:, :2], np.ones((len(j), 1))], axis=1)
            j[:, :2] = homo @ rot.T
            T = np.concatenate([rot, np.array([[0, 0, 1]])]) @ T

        if f.crop or override_jitter is not None:
            ox, oy, side, rec_x, rec_y, margin = self._crop_geometry(
                j, override_jitter, None, rng
            )
            applied.jitter_x = float(rec_x)
            applied.jitter_y = float(rec_y)
            applied.crop_margin_scale = margin
            j[:, 0] -= ox
            j[:, 1] -= oy
            img = img[oy : oy + side, ox : ox + side, :]
            T[0, -1] -= ox
            T[1, -1] -= oy

        if f.resize:
            h, w = img.shape[:2]
            if h > 0 and w > 0:
                img = cv2.resize(img, p.resize_shape, interpolation=cv2.INTER_AREA)
                fx = p.resize_shape[0] / w
                fy = p.resize_shape[1] / h
                j[:, 0] *= fx
                j[:, 1] *= fy
                T[0] *= fx
                T[1] *= fy

        if f.color_jitter:
            applied.h = float(rng.uniform(*p.hue_factor_range))
            applied.s = float(rng.uniform(*p.sat_factor_range))
            applied.a = float(rng.uniform(*p.value_factor_alpha_range))
            applied.b = float(rng.uniform(*p.value_factor_beta_range))
            hue, sat, val = cv2.split(cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
            hue = np.clip(hue * applied.h, 0, 255)
            sat = np.clip(sat * applied.s, 0, 255)
            val = np.clip(val * applied.a + applied.b, 0, 255)
            img = cv2.cvtColor(
                cv2.merge([hue, sat, val]).astype(np.uint8), cv2.COLOR_HSV2BGR
            )

        if f.gaussian_noise and rng.integers(0, 2):
            # same distribution as the reference's cv2.randn (normal
            # saturating-cast to uint8: negatives clip to 0) but drawn
            # from the explicit Generator — cv2's per-thread global RNG
            # would break (seed, epoch, idx) reproducibility
            noise = np.clip(
                rng.normal(0.0, p.noise_std, img.shape), 0, 255
            ).astype(np.uint8)
            img = img + noise  # uint8 wraparound, as in the reference

        if f.color_drop and rng.integers(0, 2):
            img[:, :, :] = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY).reshape(
                list(img.shape[:2]) + [1]
            )

        return img, j, T, applied
