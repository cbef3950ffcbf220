"""The sample-pair figure (counterpart of ``simhand_tpu/utils/plots.py:23-55``;
the other plots are not ported yet). ``matplotlib`` is imported inside the
function that draws."""
from __future__ import annotations

import numpy as np

# AIT-order skeleton: wrist -> each finger's mcp -> pip -> dip -> tip
BONES = [
    (0, 1), (1, 6), (6, 11), (11, 16),
    (0, 2), (2, 7), (7, 12), (12, 17),
    (0, 3), (3, 8), (8, 13), (13, 18),
    (0, 4), (4, 9), (9, 14), (14, 19),
    (0, 5), (5, 10), (10, 15), (15, 20),
]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def denormalize(img: np.ndarray) -> np.ndarray:
    """ImageNet-normalized float image -> displayable [0, 1]."""
    return np.clip(np.asarray(img) * IMAGENET_STD + IMAGENET_MEAN, 0, 1)


def _draw_skeleton(ax, joints_2d, color="lime"):
    for a, b in BONES:
        ax.plot(
            [joints_2d[a, 0], joints_2d[b, 0]],
            [joints_2d[a, 1], joints_2d[b, 1]],
            color=color, linewidth=1,
        )
    ax.scatter(joints_2d[:, 0], joints_2d[:, 1], s=6, c="red")


def plot_pair_images(img1, img2, joints1=None, joints2=None, title=""):
    """Side-by-side view pair; returns the matplotlib figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(6, 3))
    for ax, img, joints in zip(axes, (img1, img2), (joints1, joints2)):
        ax.imshow(denormalize(img) if np.asarray(img).dtype != np.uint8 else img)
        if joints is not None:
            _draw_skeleton(ax, np.asarray(joints)[:, :2])
        ax.axis("off")
    fig.suptitle(title)
    fig.tight_layout()
    return fig
