"""Joint-order registry and index remaps between hand-keypoint conventions
(a copy of ``simhand_tpu/core/joints.py``; the port imports nothing of the
JAX package).

The canonical internal order is "ait": wrist, then all five MCPs, PIPs,
DIPs and tips grouped by joint type (thumb→pinky within each group). The
index tables are the JAX package's, so annotations and checkpoints
interoperate bit for bit. Remaps are plain gather index arrays.
"""
from __future__ import annotations

import numpy as np

JOINT_NAMES = (
    "wrist",
    "thumb_mcp", "index_mcp", "middle_mcp", "ring_mcp", "pinky_mcp",
    "thumb_pip", "index_pip", "middle_pip", "ring_pip", "pinky_pip",
    "thumb_dip", "index_dip", "middle_dip", "ring_dip", "pinky_dip",
    "thumb_tip", "index_tip", "middle_tip", "ring_tip", "pinky_tip",
)

NUM_JOINTS = 21

# name -> index per convention
_CONVENTIONS: dict[str, dict[str, int]] = {
    "ait": {name: i for i, name in enumerate(JOINT_NAMES)},
    "freihand": {
        "wrist": 0,
        "thumb_mcp": 1, "thumb_pip": 2, "thumb_dip": 3, "thumb_tip": 4,
        "index_mcp": 5, "index_pip": 6, "index_dip": 7, "index_tip": 8,
        "middle_mcp": 9, "middle_pip": 10, "middle_dip": 11, "middle_tip": 12,
        "ring_mcp": 13, "ring_pip": 14, "ring_dip": 15, "ring_tip": 16,
        "pinky_mcp": 17, "pinky_pip": 18, "pinky_dip": 19, "pinky_tip": 20,
    },
    "interhand": {
        "thumb_tip": 0, "thumb_dip": 1, "thumb_pip": 2, "thumb_mcp": 3,
        "index_tip": 4, "index_dip": 5, "index_pip": 6, "index_mcp": 7,
        "middle_tip": 8, "middle_dip": 9, "middle_pip": 10, "middle_mcp": 11,
        "ring_tip": 12, "ring_dip": 13, "ring_pip": 14, "ring_mcp": 15,
        "pinky_tip": 16, "pinky_dip": 17, "pinky_pip": 18, "pinky_mcp": 19,
        "wrist": 20,
    },
    "mano": {
        "wrist": 0,
        "index_mcp": 1, "index_pip": 2, "index_dip": 3,
        "middle_mcp": 4, "middle_pip": 5, "middle_dip": 6,
        "pinky_mcp": 7, "pinky_pip": 8, "pinky_dip": 9,
        "ring_mcp": 10, "ring_pip": 11, "ring_dip": 12,
        "thumb_mcp": 13, "thumb_pip": 14, "thumb_dip": 15,
        "thumb_tip": 16, "index_tip": 17, "middle_tip": 18,
        "ring_tip": 19, "pinky_tip": 20,
    },
}

# The scale bone: wrist -> index_mcp (reference: src/data_loader/utils.py:16-17).
PARENT_JOINT = _CONVENTIONS["ait"]["wrist"]        # 0
CHILD_JOINT = _CONVENTIONS["ait"]["index_mcp"]     # 2


def remap_index(src: str, dst: str) -> np.ndarray:
    """Gather indices ``g`` such that ``joints_dst = joints_src[g]``.

    ``g[i]`` is the index in the *src* convention of the joint whose index
    in the *dst* convention is ``i``.
    """
    s, d = _CONVENTIONS[src], _CONVENTIONS[dst]
    g = np.zeros(NUM_JOINTS, dtype=np.int32)
    for name in JOINT_NAMES:
        g[d[name]] = s[name]
    return g


class JointMap:
    """Convenience wrapper bundling the common remaps.

    All remaps are static numpy gathers.
    """

    def __init__(self) -> None:
        self.freihand_to_ait_idx = remap_index("freihand", "ait")
        self.ait_to_freihand_idx = remap_index("ait", "freihand")
        self.interhand_to_ait_idx = remap_index("interhand", "ait")
        self.ait_to_interhand_idx = remap_index("ait", "interhand")
        self.mano_to_ait_idx = remap_index("mano", "ait")
        self.ait_to_mano_idx = remap_index("ait", "mano")
        # fine-tune stack canonical order is freihand/snap
        # (minimal-hand convention, datasets/__init__.py:88-110)
        self.mano_to_freihand_idx = remap_index("mano", "freihand")
        self.freihand_to_mano_idx = remap_index("freihand", "mano")
        self.interhand_to_freihand_idx = remap_index("interhand", "freihand")

    def freihand_to_ait(self, joints):
        return joints[..., self.freihand_to_ait_idx, :]

    def ait_to_freihand(self, joints):
        return joints[..., self.ait_to_freihand_idx, :]

    def interhand_to_ait(self, joints):
        return joints[..., self.interhand_to_ait_idx, :]

    def mano_to_ait(self, joints):
        return joints[..., self.mano_to_ait_idx, :]

    def ait_to_mano(self, joints):
        return joints[..., self.ait_to_mano_idx, :]

    def mano_to_freihand(self, joints):
        return joints[..., self.mano_to_freihand_idx, :]

    def freihand_to_mano(self, joints):
        return joints[..., self.freihand_to_mano_idx, :]

    def interhand_to_freihand(self, joints):
        return joints[..., self.interhand_to_freihand_idx, :]


# MANO's fingertip vertex ids (thumb, index, middle, ring, pinky), which
# complete its 16 regressed joints to 21 (simhand_tpu/finetune/mano.py:25)
TIP_VERTEX_IDS = (744, 320, 443, 555, 672)

# AssemblyHands -> MANO remap (reference: src/data_loader/utils.py:459-487).
# joints_mano[AH_TO_MANO[i]] = joints_ah[i]
AH_TO_MANO = np.array(
    [4, 3, 2, 1, 8, 7, 6, 5, 12, 11, 10, 9, 16, 15, 14, 13, 20, 19, 18, 17, 0],
    dtype=np.int32,
)


def ah_to_mano(joints: np.ndarray) -> np.ndarray:
    """Reorders AssemblyHands joints into MANO order."""
    out = np.zeros_like(joints)
    out[..., AH_TO_MANO, :] = joints
    return out
