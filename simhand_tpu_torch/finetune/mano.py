"""The MANO hand layer in PyTorch (the JAX package's ``finetune/mano.py``).

The MANO forward model (Romero et al., SIGGRAPH Asia 2017): shape blend ->
pose blend -> kinematic chain -> linear blend skinning. Pose input is 16
rotation matrices (root + 15 joints), which is what the analytic IK
produces, so no axis-angle round trip is needed.

Requires the MANO model pickle (MANO_RIGHT.pkl) from the official site,
which is not redistributable. The pickle holds chumpy arrays; a stub
unpickler turns them into numpy without chumpy installed.

The parameters are float32 buffers on the device the model is built on
(``cuda`` unless the caller passes ``device="cpu"``).
"""
from __future__ import annotations

import pickle

import numpy as np
import torch
from torch import nn

from simhand_tpu_torch.core.joints import TIP_VERTEX_IDS
from simhand_tpu_torch.device import resolve_device

# the 16 skeleton joints' parents and the reference's order of the 15 bones
# (minimal-hand/model/shape_net.py:49-81 new_cal_ref_bone)
BONE_PARENT = (0, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)
BONE_REORDER = (13, 14, 15, 1, 2, 3, 4, 5, 6, 10, 11, 12, 7, 8, 9)


def _chumpy_tolerant_load(path: str) -> dict:
    class _Stub:
        def __setstate__(self, state):
            self.__dict__.update(state)

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if module.startswith("chumpy"):
                return _Stub
            return super().find_class(module, name)

    with open(path, "rb") as f:
        data = _Unpickler(f, encoding="latin1").load()

    def to_np(x):
        if isinstance(x, _Stub):
            # chumpy Ch arrays store their value in 'x'
            return np.asarray(x.__dict__.get("x"))
        return x

    return {k: to_np(v) for k, v in data.items()}


def _long(values) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.int64))


class ManoModel(nn.Module):
    """MANO's parameters as buffers and its forward.

    Built from the official pickle (``ManoModel(path)``) or from a raw
    parameter dict (``ManoModel(params=d)``), on ``device``.
    """

    def __init__(self, pkl_path: str | None = None, params: dict | None = None,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        d = params if params is not None else _chumpy_tolerant_load(pkl_path)
        j_reg = d["J_regressor"]
        j_reg = j_reg.todense() if hasattr(j_reg, "todense") else j_reg

        def f32(a):
            return torch.from_numpy(np.array(a, dtype=np.float32))

        self.register_buffer("v_template", f32(d["v_template"]))         # (778, 3)
        self.register_buffer("shapedirs", f32(d["shapedirs"]))           # (778, 3, 10)
        self.register_buffer("posedirs", f32(d["posedirs"]))             # (778, 3, 135)
        self.register_buffer("J_regressor", f32(j_reg))                  # (16, 778)
        self.register_buffer("weights", f32(d["weights"]))               # (778, 16)
        kt = np.asarray(d["kintree_table"])
        self.parents = kt[0].astype(np.int32)                            # (16,)
        # the official root entry is uint32 -1
        self.parents[0] = 0
        # triangle faces (1538, 3), present in the official pickle ('f');
        # optional so synthetic parameters work
        self.faces = np.asarray(d["f"], np.int32) if d.get("f") is not None else None

        self.register_buffer("_parents", _long(self.parents), persistent=False)
        self.register_buffer("_tips", _long(TIP_VERTEX_IDS), persistent=False)
        self.register_buffer("_bone_parent", _long(BONE_PARENT), persistent=False)
        self.register_buffer("_bone_reorder", _long(BONE_REORDER), persistent=False)
        self.register_buffer("_bottom", torch.tensor([0.0, 0.0, 0.0, 1.0]), persistent=False)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.v_template.device

    def shaped_joints(self, beta: torch.Tensor) -> torch.Tensor:
        """(B, 10) betas -> (B, 16, 3) rest-pose skeleton joints."""
        v_shaped = torch.einsum("vck,bk->bvc", self.shapedirs, beta) + self.v_template
        return torch.einsum("jv,bvc->bjc", self.J_regressor, v_shaped)

    def _kinematic_chain(self, local: torch.Tensor) -> torch.Tensor:
        """(B, 16, 4, 4) local transforms -> global ones, a product a joint."""
        transforms = [local[:, 0]]
        for j in range(1, len(self.parents)):
            transforms.append(transforms[int(self.parents[j])] @ local[:, j])
        return torch.stack(transforms, dim=1)

    def forward(self, pose_rotmats: torch.Tensor, beta: torch.Tensor):
        """MANO forward.

        Args:
          pose_rotmats: (B, 16, 3, 3), the global root rotation and 15
            relative joint rotations in MANO order.
          beta: (B, 10) shape coefficients.

        Returns:
          verts (B, 778, 3) and joints21 (B, 21, 3) in MANO's 21-joint order
          (16 skeleton joints + 5 fingertip vertices, the reference's
          get_joints_from_mano_mesh convention).
        """
        B = beta.shape[0]
        v_shaped = torch.einsum("vck,bk->bvc", self.shapedirs, beta) + self.v_template
        joints = torch.einsum("jv,bvc->bjc", self.J_regressor, v_shaped)    # (B,16,3)

        eye = torch.eye(3, dtype=pose_rotmats.dtype, device=pose_rotmats.device)
        pose_feat = (pose_rotmats[:, 1:] - eye).reshape(B, 135)
        v_posed = v_shaped + torch.einsum("vck,bk->bvc", self.posedirs, pose_feat)

        # forward kinematics: every joint's local transform, then the chain
        t = torch.cat([joints[:, :1], (joints - joints[:, self._parents])[:, 1:]], dim=1)
        top = torch.cat([pose_rotmats, t[..., None]], dim=-1)               # (B,16,3,4)
        local = torch.cat([top, self._bottom.to(top.dtype).expand(*top.shape[:-2], 1, 4)],
                          dim=-2)
        A = self._kinematic_chain(local)                                    # (B,16,4,4)

        # remove the rest-pose joint location (SMPL-style correction):
        # A[:, :, :3, 3] -= (A @ [joints, 0])[..., :3]
        joints_h = torch.cat([joints, joints.new_zeros(B, 16, 1)], dim=-1)
        correction = torch.einsum("bjik,bjk->bji", A, joints_h)             # (B,16,4)
        shift = torch.cat([correction[..., :3], correction.new_zeros(B, 16, 1)], dim=-1)
        A = torch.cat([A[..., :3], A[..., 3:] - shift[..., None]], dim=-1)

        T = torch.einsum("vj,bjik->bvik", self.weights, A)                  # (B,778,4,4)
        v_h = torch.cat([v_posed, v_posed.new_ones(B, v_posed.shape[1], 1)], dim=-1)
        verts = torch.einsum("bvik,bvk->bvi", T, v_h)[..., :3]

        posed_joints = A[:, :, :3, 3] + torch.einsum("bjik,bjk->bji", A[:, :, :3, :3], joints)
        joints21 = torch.cat([posed_joints, verts[:, self._tips]], dim=1)
        return verts, joints21


def relative_bone_lengths(mano: ManoModel, beta: torch.Tensor) -> torch.Tensor:
    """15 bone lengths of the shaped skeleton, normalized by the
    wrist->middle_mcp reference bone, in the reference's reorder
    (minimal-hand/model/shape_net.py:49-81 new_cal_ref_bone).

    A departure from the JAX package: its gradient here is NaN (the wrist's
    zero "bone" through sqrt'(0), ``simhand_tpu/finetune/mano.py:148-162``,
    so its ``sik_loss`` trainer's parameters are NaN after one step); this
    one is finite, as the reference's ``torch.norm`` is."""
    j = mano.shaped_joints(beta)                                            # (B,16,3)
    rel = j - j[:, mano._bone_parent]
    ref = torch.linalg.norm(j[:, 4] - j[:, 0], dim=-1, keepdim=True)
    lengths = torch.linalg.norm(rel, dim=-1) / ref
    return lengths[:, mano._bone_reorder]
