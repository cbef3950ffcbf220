"""Ground-truth map generation for detnet training (a copy of
``simhand_tpu/finetune/maps.py``; the numpy maps are kept bit for bit,
``xyz2uvd`` / ``uvd2xyz`` are torch functions).

Replicates minimal-hand's targets (handataset.py:305-358,
utils/heatmaputils.py:6-49):

  * Gaussian heatmaps at integer keypoint coords, sigma=1, window 6s+1,
    validity flag 0 when the gaussian falls fully outside;
  * location maps: root-relative, ref-bone-scale-normalized joints tiled
    over the 32x32 grid;
  * delta maps: unit vectors down the SNAP_PARENT kinematic chain, tiled.

Host-side (numpy) for the loader.
"""
from __future__ import annotations

import numpy as np
import torch

SNAP_PARENT = [
    0, 0, 1, 2, 3, 0, 5, 6, 7, 0, 9, 10, 11, 0, 13, 14, 15, 0, 17, 18, 19
]
# reference bone: wrist (0) -> middle_mcp (9), freihand/minimal-hand order
REF_BONE_LINK = (0, 9)
# location/delta maps and the eval alignment are rooted at the WRIST
# (reference handataset.py:81 joint_root_idx = 0, align.py:13 root_idx=0;
# middle_mcp (9) is only the CENTER_ID / ref-bone endpoint)
JOINT_ROOT_IDX = 0


def gen_heatmap(img: np.ndarray, pt, sigma: float = 1.0):
    """Writes a gaussian centered at int(pt)=(x, y) into img (H, W)."""
    pt = np.asarray(pt).astype(np.int32)
    ul = [int(pt[0] - 3 * sigma), int(pt[1] - 3 * sigma)]
    br = [int(pt[0] + 3 * sigma + 1), int(pt[1] + 3 * sigma + 1)]
    if ul[0] >= img.shape[1] or ul[1] >= img.shape[0] or br[0] < 0 or br[1] < 0:
        return img, 0
    size = int(6 * sigma + 1)
    x = np.arange(0, size, 1, float)
    y = x[:, np.newaxis]
    x0 = y0 = size // 2
    g = np.exp(-((x - x0) ** 2 + (y - y0) ** 2) / (2 * sigma**2))
    g_x = max(0, -ul[0]), min(br[0], img.shape[1]) - ul[0]
    g_y = max(0, -ul[1]), min(br[1], img.shape[0]) - ul[1]
    img_x = max(0, ul[0]), min(br[0], img.shape[1])
    img_y = max(0, ul[1]), min(br[1], img.shape[0])
    img[img_y[0]:img_y[1], img_x[0]:img_x[1]] = g[g_y[0]:g_y[1], g_x[0]:g_x[1]]
    return img, 1


def gen_heatmaps(kp2d: np.ndarray, inp_res: int, hm_res: int, sigma: float = 1.0):
    """All 21 heatmaps + veil from input-space keypoints (21, 2)."""
    hm = np.zeros((hm_res, hm_res, 21), np.float32)
    veil = np.ones(21, np.float32)
    for i in range(kp2d.shape[0]):
        kp = ((kp2d[i] / inp_res) * hm_res).astype(np.int32)
        plane, ok = gen_heatmap(hm[:, :, i], kp, sigma)
        hm[:, :, i] = plane
        veil[i] = ok
    return hm, veil


def joint_maps(joint: np.ndarray, hm_res: int = 32):
    """(21, 3) camera-space joints -> (location_map, delta_map), each
    (hm_res, hm_res, 21, 3), plus (root, bone) for de-normalization."""
    bone = 0.0
    for a, b in zip(REF_BONE_LINK[:-1], REF_BONE_LINK[1:]):
        bone += np.linalg.norm(joint[b] - joint[a])
    root = joint[JOINT_ROOT_IDX]
    jr = joint - root[None]
    jrs = jr / bone

    loc = np.broadcast_to(jrs[None, None], (hm_res, hm_res, 21, 3)).copy()

    kin = np.stack([jrs[i] - jrs[SNAP_PARENT[i]] for i in range(21)])
    kin_len = np.linalg.norm(kin, axis=-1, keepdims=True)
    kin[1:] = kin[1:] / np.maximum(kin_len[1:], 1e-12)
    delta = np.broadcast_to(kin[None, None], (hm_res, hm_res, 21, 3)).copy()
    return loc.astype(np.float32), delta.astype(np.float32), root, np.float32(bone)


def xyz_from_maps(xyz_norm: np.ndarray, root: np.ndarray, bone: float) -> np.ndarray:
    """Inverse of the location-map normalization."""
    return xyz_norm * bone + root[None]


# normalized-depth window for uvd encodings
# (reference: minimal-hand/config.py:1-2)
DEPTH_RANGE = 3.0
DEPTH_MIN = -1.5


def _focal_centre(intr: torch.Tensor):
    f = torch.stack([intr[:, 0, 0], intr[:, 1, 1]], dim=-1)[:, None, :]
    c = torch.stack([intr[:, 0, 2], intr[:, 1, 2]], dim=-1)[:, None, :]
    return f, c


def xyz2uvd(xyz, joint_root, joint_bone, intr, inp_res: int = 256) -> torch.Tensor:
    """Camera-space (B, J, 3) xyz -> normalized (B, J, 3) uvd: uv in [0, 1]
    of ``inp_res``, depth root-relative and bone-scaled then mapped through
    the [DEPTH_MIN, DEPTH_MIN+DEPTH_RANGE] window
    (reference: minimal-hand/utils/handutils.py:134-176).

    Args:
      xyz: (B, J, 3) camera coordinates.
      joint_root: (B, 3) root joint (its z is the root depth).
      joint_bone: (B,) or (B, 1) reference bone length.
      intr: (B, 3, 3) intrinsics.
    """
    xyz, joint_root, joint_bone, intr = map(torch.as_tensor, (xyz, joint_root, joint_bone, intr))
    z = xyz[..., 2]
    xy = xyz[..., :2] / z[..., None]
    root_depth = joint_root[:, 2][:, None]
    bone = joint_bone.reshape(-1, 1)
    depth = (z - root_depth) / bone
    f, c = _focal_centre(intr)
    uv = (xy * f + c) / inp_res
    depth = (depth - DEPTH_MIN) / DEPTH_RANGE
    return torch.cat([uv, depth[..., None]], dim=-1)


def uvd2xyz(uvd, joint_root, joint_bone, intr, inp_res: int = 256) -> torch.Tensor:
    """Inverse of :func:`xyz2uvd`
    (reference: minimal-hand/utils/handutils.py:95-131)."""
    uvd, joint_root, joint_bone, intr = map(torch.as_tensor, (uvd, joint_root, joint_bone, intr))
    uv = uvd[..., :2] * inp_res
    depth = uvd[..., 2] * DEPTH_RANGE + DEPTH_MIN
    root_depth = joint_root[:, 2][:, None]
    bone = joint_bone.reshape(-1, 1)
    z = depth * bone + root_depth
    f, c = _focal_centre(intr)
    xy = (uv - c) / f * z[..., None]
    return torch.cat([xy, z[..., None]], dim=-1)
