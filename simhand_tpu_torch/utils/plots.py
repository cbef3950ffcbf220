"""Plot helpers (counterpart of ``simhand_tpu/utils/plots.py``; reference:
src/visualization/visualize.py): the sample-pair figure, truth against
prediction, the encodings' heatmaps and the PCK curve. Each returns a
matplotlib figure (``heatmaps_vis`` the paths it saved); ``matplotlib`` is
imported inside the function that draws, on its ``Agg`` backend."""
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


def plot_truth_vs_prediction(pred_joints, true_joints, image, title=""):
    """2D overlay of predicted vs ground-truth keypoints on the input."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(4, 4))
    ax.imshow(denormalize(image) if np.asarray(image).dtype != np.uint8 else image)
    _draw_skeleton(ax, np.asarray(true_joints)[:, :2], color="lime")
    _draw_skeleton(ax, np.asarray(pred_joints)[:, :2], color="cyan")
    ax.axis("off")
    ax.set_title(title or "green: truth / cyan: prediction")
    fig.tight_layout()
    return fig


def heatmaps_vis(batch_idx, batch, encodings, save_path, vis_type="IO",
                 cmap="viridis"):
    """Save per-view encoding heatmaps next to their input images.

    Reference: src/visualization/hp_vis.py:8 ``heatmaps_vis`` — a legacy
    debugging visualizer (unused by the 8 experiment types) that renders
    each view's spatial encoding as a colormapped heatmap beside the
    original image under ``<save_path>/batch_idx_<i>/combined_<n>.png``.
    Only the "IO" (Individual + Original) mode is implemented in the
    reference (its docstring lists I/IO/P/PO but the body handles IO);
    we mirror that and raise on the others.

    ``batch`` carries ``transformed_image{1,2}`` as NHWC (or HWC) numpy
    arrays; ``encodings`` is a length-2 stack of 2-D spatial maps.
    """
    import os

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if vis_type != "IO":
        raise NotImplementedError(
            f"vis_type={vis_type!r}: the reference implements only 'IO'"
        )
    folder = os.path.join(save_path, f"batch_idx_{batch_idx}")
    os.makedirs(folder, exist_ok=True)
    img1 = np.asarray(batch["transformed_image1"])
    img2 = np.asarray(batch["transformed_image2"])
    n_imgs = (img1.shape[0] if img1.ndim == 4 else 1) + (
        img2.shape[0] if img2.ndim == 4 else 1
    )
    encodings = np.asarray(encodings)
    assert n_imgs == encodings.shape[0] == 2, (
        f"The first dimensions of transformed_image:{n_imgs} and "
        f"encodings:{encodings.shape[0]} do not equal 2."
    )
    paths = []
    for i, (img, enc) in enumerate(zip((img1, img2), encodings)):
        img_np = np.squeeze(np.asarray(img, np.float32))
        if img_np.max() > 1:
            img_np = img_np / img_np.max()
        img_np = np.clip(img_np, 0, 1)
        fig, axs = plt.subplots(1, 2, figsize=(12, 6))
        axs[0].imshow(img_np)
        axs[0].set_title(f"Original Image {i + 1}")
        axs[0].axis("off")
        im = axs[1].imshow(np.squeeze(enc), cmap=cmap)
        axs[1].set_title(f"Heatmap {i + 1}")
        axs[1].axis("off")
        fig.colorbar(im, ax=axs[1], fraction=0.046, pad=0.04)
        out = os.path.join(folder, f"combined_{i + 1}.png")
        fig.savefig(out)
        plt.close(fig)
        paths.append(out)
    return paths


def plot_pck_curve(curve, thresholds, title="PCK"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(4, 3))
    ax.plot(thresholds, curve)
    ax.set_xlabel("threshold")
    ax.set_ylabel("PCK")
    ax.set_ylim(0, 1.0)
    ax.grid(alpha=0.3)
    ax.set_title(title)
    fig.tight_layout()
    return fig
