"""The augmentation flags and parameters (counterpart of
``simhand_tpu/data/augment_cv2.py:38-67``).

The host augmenter of that module (``HostAugmenter``, ``AppliedParams``)
reads and writes through ``cv2`` and is not ported yet; nothing here
imports ``cv2``.
"""
from __future__ import annotations

import dataclasses


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
