"""Fine-tune/eval benchmark dataset readers (counterpart of
``simhand_tpu/finetune/benchmarks.py``: the same readers, names,
arguments and samples, on the port's own ``core/joints.py``,
``data/crops.py`` and ``data/sources/hand100m.py``).

All readers emit the DetnetSampleBuilder sample schema:
  {"image": HxWx3 uint8 RGB, "K": 3x3 | None, "joint": (21,3) | None,
   "kp2d": (21,2)}
joints in freihand/snap order — wrist, then thumb..pinky each
mcp/pip/dip/tip — the order every fine-tune consumer assumes
(maps.py SNAP_PARENT/JOINT_ROOT_IDX/REF_BONE_LINK, aik.py, align
root/bone indices; reference: minimal-hand/datasets/__init__.py:88-110).
``tests/test_torch_benchmark_readers.py`` holds every reader's samples
bit for bit against the JAX package's on the JAX tests' synthetic
layouts. Every reader is gated on its official on-disk layout (nothing is
vendored). The readers decode with ``cv2``, and DexYCB reads ``yaml`` and
STB ``scipy.io``, each imported inside the function that needs it.

Left hands are mirrored to right wherever chirality is known (the
reference trains/evals right hands only; STB mirrors every sample, DO/EO
mirror on their color-frame 3D-projection paths — the degraded
depth-frame 2D fallbacks have no calibrated frame and stay unmirrored).

Coverage vs the reference's minimal-hand/datasets/:
  RHD            official RHD_published_v2 per-frame pickle OR the
                 reference's repackaged cache dict; mask-based crop scale
  STB            labels/*.mat (SK color camera); all-left set, mirrored
  DexYCB         dex-ycb-toolkit layout, s1/s2 subject/camera splits,
                 per-frame labels_*.npz, invalid-frame filter
  AssemblyHands  COCO-style ego annotations v1-1
  DexterObject / EgoDexter  3D tips projected into the color frame via
                 vendored camera chains; tip-only protocol
  Ego4D-hands    Hand100M annotation JSON, 2D-only (flag_3d=0)
"""
from __future__ import annotations

import json
import os
import pickle

import numpy as np

from simhand_tpu_torch.core.joints import JointMap

_JM = JointMap()


# official RHD joint order: palm, then each finger TIP->MCP; the gather
# below is its own inverse (palm + per-finger reversal), matching the
# reference's rhd_to_snap_id (rhd.py:31, config.py:28-50)
RHD_TO_SNAP = [0, 4, 3, 2, 1, 8, 7, 6, 5, 12, 11, 10, 9,
               16, 15, 14, 13, 20, 19, 18, 17]


class RHD:
    """Rendered Handpose Dataset.

    Accepts BOTH on-disk layouts: the official RHD_published_v2
    ``anno_{training,evaluation}.pickle`` of per-frame dicts
    (``uv_vis`` (42,3) / ``xyz`` (42,3) / ``K`` — both hands stacked,
    reference rhd.py:131-196: pick the majority-visible side, reorder
    rhd->snap), and the reference's repackaged cache dict
    (clr_paths/joints/kp2ds/intrs, rhd.py:91-99). The mask-based crop
    scale (get_ori_crop_scale with the side's segmentation ids) is
    computed lazily per sample when mask/ exists."""

    def __init__(self, root_dir: str, split: str = "train"):
        name = {"train": "training", "val": "evaluation", "test": "evaluation"}[split]
        with open(os.path.join(root_dir, name, f"anno_{name}.pickle"), "rb") as f:
            a = pickle.load(f)
        self.root = os.path.join(root_dir, name)
        self._scale_cache: dict[int, np.float32] = {}
        if isinstance(a, dict) and "clr_paths" in a:
            self.clr_paths = a["clr_paths"]
            self.joints = a["joints"]      # list of (21, 3), meters
            self.kp2ds = a["kp2ds"]
            self.intrs = a["intrs"]
            self.sides = a.get("sides")
            self.centers = a.get("centers")
            self.my_scales = a.get("my_scales")
            return
        # official per-frame layout
        self.clr_paths, self.joints, self.kp2ds = [], [], []
        self.intrs, self.sides = [], []
        self.centers, self.my_scales = [], None  # scales lazy (mask IO)
        for i in range(len(a)):
            raw = a[i]
            uv_vis = np.asarray(raw["uv_vis"], np.float32)
            xyz = np.asarray(raw["xyz"], np.float32)
            l_cnt = int((uv_vis[:21, 2] == 1).sum())
            r_cnt = int((uv_vis[21:, 2] == 1).sum())
            lo = 0 if l_cnt > r_cnt else 21
            kp2d = uv_vis[lo : lo + 21, :2][RHD_TO_SNAP]
            self.clr_paths.append(os.path.join("color", f"{i:05d}.png"))
            self.sides.append("l" if lo == 0 else "r")
            self.joints.append(xyz[lo : lo + 21][RHD_TO_SNAP])
            self.kp2ds.append(kp2d)
            self.intrs.append(np.asarray(raw["K"], np.float32))
            self.centers.append(np.array(
                [int((kp2d[:, 0].min() + kp2d[:, 0].max()) / 2),
                 int((kp2d[:, 1].min() + kp2d[:, 1].max()) / 2)], np.float32))

    def _mask_scale(self, i: int, kp2d: np.ndarray) -> np.float32:
        """get_ori_crop_scale: max(mask extent, kp2d extent) * 2.0
        (handutils.py:275-291; mask ids 2-17 left / 18-33 right).
        Cached per index — the reference precomputes all scales at init;
        re-reading the mask PNG every fetch would double image IO."""
        if i in self._scale_cache:
            return self._scale_cache[i]
        kp_scale = float(np.max(kp2d.max(axis=0) - kp2d.min(axis=0)))
        scale = kp_scale
        if self.sides is not None:
            mask_path = os.path.join(
                self.root, "mask", os.path.basename(self.clr_paths[i])
            )
            if os.path.exists(mask_path):
                import cv2

                mask = cv2.imread(mask_path, cv2.IMREAD_GRAYSCALE)
                ids = (2, 17) if self.sides[i] == "l" else (18, 33)
                seg = np.argwhere((mask >= ids[0]) & (mask <= ids[1]))
                if len(seg):
                    ext = (seg.max(axis=0) - seg.min(axis=0) + 1).max()
                    scale = max(float(ext), kp_scale)
        self._scale_cache[i] = np.float32(scale * 2.0)
        return self._scale_cache[i]

    def __len__(self):
        return len(self.clr_paths)

    def __getitem__(self, i: int) -> dict:
        import cv2

        img = cv2.cvtColor(
            cv2.imread(os.path.join(self.root, self.clr_paths[i])),
            cv2.COLOR_BGR2RGB,
        )
        kp2d = np.asarray(self.kp2ds[i], np.float32).reshape(21, 2).copy()
        joint = np.asarray(self.joints[i], np.float32).reshape(21, 3).copy()
        center = (np.asarray(self.centers[i], np.float32).reshape(2).copy()
                  if self.centers is not None else None)
        my_scale = None
        if self.my_scales is not None:
            my_scale = np.float32(np.asarray(self.my_scales[i]).ravel()[0])
        elif self.sides is not None:
            my_scale = self._mask_scale(i, kp2d)
        if self.sides is not None and self.sides[i] == "l":
            # left hands mirrored to right (reference rhd.py:234,252-257)
            w = img.shape[1]
            img = np.ascontiguousarray(img[:, ::-1])
            kp2d[:, 0] = w - kp2d[:, 0]
            joint[:, 0] = -joint[:, 0]
            if center is not None:
                center[0] = w - center[0]
        out = {
            "image": img,
            "K": np.asarray(self.intrs[i], np.float32).reshape(3, 3),
            "joint": joint,
            "kp2d": kp2d,
        }
        if center is not None:
            out["center"] = center
        if my_scale is not None:
            out["my_scale"] = my_scale
        return out


class DexYCB:
    """DexYCB via the official dex-ycb-toolkit layout.

    Splits follow the reference (minimal-hand/datasets/dexycb.py
    get_data_split): s1 = unseen subjects, s2 = unseen cameras.
    """

    SUBJECTS = [
        "20200709-subject-01", "20200813-subject-02", "20200820-subject-03",
        "20200903-subject-04", "20200908-subject-05", "20200918-subject-06",
        "20200928-subject-07", "20201002-subject-08", "20201015-subject-09",
        "20201022-subject-10",
    ]

    @staticmethod
    def split_indices(split: str, setup: str = "s1"):
        if setup == "s1":
            subj = {"train": [0, 1, 2, 3, 4, 5, 9], "val": [6],
                    "test": [7, 8]}[split]
            serial = list(range(8))
        elif setup == "s2":
            subj = list(range(10))
            serial = {"train": [0, 1, 2, 3, 4, 5], "val": [6], "test": [7]}[split]
        else:
            raise ValueError(setup)
        return subj, serial

    WIDTH, HEIGHT = 640, 480
    N_VALID_KEYPOINTS = 10          # reference datasets/__init__.py:1

    def __init__(self, root_dir: str, split: str = "train", setup: str = "s1",
                 filter_invalid: bool = True, cache_path: str | None = None):
        import yaml

        self.root = root_dir
        subj_ind, serial_ind = self.split_indices(split, setup)
        self.samples: list[tuple[str, str, int, str]] = []
        self.intr: dict[str, np.ndarray] = {}
        serials = []
        for si in subj_ind:
            subject_dir = os.path.join(root_dir, self.SUBJECTS[si])
            if not os.path.isdir(subject_dir):
                continue
            for seq in sorted(os.listdir(subject_dir)):
                seq_dir = os.path.join(subject_dir, seq)
                meta_path = os.path.join(seq_dir, "meta.yml")
                if not os.path.exists(meta_path):
                    continue
                with open(meta_path) as f:
                    meta = yaml.safe_load(f)
                all_serials = meta["serials"]
                side = (meta.get("mano_sides") or ["right"])[0]
                for k in serial_ind:
                    if k >= len(all_serials):
                        continue
                    serial = all_serials[k]
                    cam_dir = os.path.join(seq_dir, serial)
                    n = meta["num_frames"]
                    for fr in range(n):
                        self.samples.append((cam_dir, serial, fr, side))
                    serials.append(serial)
        if filter_invalid:
            # reference frame filter (dexycb.py:282-293): drop frames
            # with <10 visible joints or an invisible ref-bone endpoint.
            # The scan opens every labels npz once; pass cache_path to
            # persist the surviving keys (the reference pickles the whole
            # repack, dexycb.py:296-300).
            if cache_path and os.path.exists(cache_path):
                with open(cache_path) as f:
                    keys = set(tuple(k) for k in json.load(f))
                self.samples = [
                    s for s in self.samples if (s[0], s[2]) in keys
                ]
            else:
                keep = []
                for s in self.samples:
                    kp2d, j3d = self._load_labels(s[0], s[2])
                    vis = self._visibility(kp2d, j3d)
                    if (vis.sum() >= self.N_VALID_KEYPOINTS
                            and vis[0] and vis[9]):
                        keep.append(s)
                self.samples = keep
                if cache_path:
                    with open(cache_path, "w") as f:
                        json.dump([[s[0], s[2]] for s in self.samples], f)

    def _load_labels(self, cam_dir: str, fr: int):
        labels = np.load(os.path.join(cam_dir, f"labels_{fr:06d}.npz"))
        return (labels["joint_2d"].reshape(21, 2).astype(np.float32),
                labels["joint_3d"].reshape(21, 3).astype(np.float32))

    def _visibility(self, kp2d: np.ndarray, j3d: np.ndarray) -> np.ndarray:
        # reference dexycb.py:438
        return ((kp2d[:, 0] != -1) & (kp2d.min(axis=1) > 0)
                & (kp2d[:, 0] <= self.WIDTH) & (kp2d[:, 1] <= self.HEIGHT)
                & (j3d[:, 0] != -1))

    def _intrinsics(self, serial: str) -> np.ndarray:
        if serial not in self.intr:
            import yaml

            path = os.path.join(
                self.root, "calibration", f"intrinsics_{serial}_640x480.yml"
            )
            with open(path) as f:
                x = yaml.safe_load(f)["color"]
            self.intr[serial] = np.array(
                [[x["fx"], 0, x["ppx"]], [0, x["fy"], x["ppy"]], [0, 0, 1]],
                np.float32,
            )
        return self.intr[serial]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int) -> dict:
        import cv2

        cam_dir, serial, fr, side = self.samples[i]
        img = cv2.cvtColor(
            cv2.imread(os.path.join(cam_dir, f"color_{fr:06d}.jpg")),
            cv2.COLOR_BGR2RGB,
        )
        kp2d, joint = self._load_labels(cam_dir, fr)
        # DexYCB labels are already wrist-first freihand order
        # (dex-ycb-toolkit MANO joint list; the reference reader keeps it,
        # minimal-hand/datasets/dexycb.py:436).
        # visibility from the RAW labels (the reference computes vis at
        # :438 BEFORE the flip; post-flip coords would misjudge boundary
        # pixels and the mirrored -1 depth sentinel)
        vis = self._visibility(kp2d, joint)
        if side != "right":
            # left hands mirrored to right (reference dexycb.py:469-477)
            img = np.ascontiguousarray(img[:, ::-1])
            kp2d[:, 0] = self.WIDTH - kp2d[:, 0]
            joint[:, 0] *= -1
        center = np.array([int((kp2d[:, 0].min() + kp2d[:, 0].max()) / 2),
                           int((kp2d[:, 1].min() + kp2d[:, 1].max()) / 2)],
                          np.float32)
        my_scale = 1.75 * float(
            np.max(kp2d.max(axis=0) - kp2d.min(axis=0))
        )  # reference dexycb.py:482 (scale_factor=1.75)
        return {
            "image": img,
            "K": self._intrinsics(serial),
            "joint": joint,
            "kp2d": kp2d,
            "vis": vis.astype(np.float32),
            "center": center,
            "my_scale": np.float32(my_scale),
        }


class AssemblyHands:
    """AssemblyHands via the official v1-1 annotation triplet
    (reference: minimal-hand/datasets/assembly_hands.py:140-250):

      annotations/<split>/assemblyhands_<split>_<modality>_data_v1-1.json
          COCO-style: images (seq_name/camera/frame_idx/file_name),
          annotations (image_id, per-hand bbox, joint_valid of 42)
      assemblyhands_<split>_<modality>_calib_v1-1.json
          per-seq intrinsics/extrinsics keyed <camera>_mono10bit
      assemblyhands_<split>_joint_3d_v1-1.json
          per-seq/frame 42-joint world coordinates (mm)

    ``modality``: "ego" (4 headset mono cameras) or "exo" (8 fixed RGB
    cameras) — the same schema, different camera sets/filenames.

    Each annotated hand with a bbox becomes one sample: world joints are
    projected through the frame's camera (x_cam = R x + t), the crop is
    cut around the bbox at scale 1.75 with the intrinsics updated.

    Like the reference, an ``invalid_<split>_<modality>.txt`` skip list
    (lines ``<file_name>,<hand_id>``) is honoured when present; without
    one, hands with fewer than 10 valid joints are dropped
    (reference: assembly_hands.py:200-215).
    """

    CROP_SCALE = 1.75
    CROP_SIZE = 224
    NUM_JOINTS = 21

    def __init__(self, root_dir: str, split: str = "train",
                 crop: bool = True, modality: str = "ego"):
        assert modality in ("ego", "exo"), modality
        self.root = root_dir
        self.crop = crop
        self.modality = modality
        anno_dir = os.path.join(root_dir, "annotations", split)
        with open(os.path.join(
                anno_dir,
                f"assemblyhands_{split}_{modality}_data_v1-1.json")) as f:
            data = json.load(f)
        with open(os.path.join(
                anno_dir,
                f"assemblyhands_{split}_{modality}_calib_v1-1.json")) as f:
            self.calib = json.load(f)["calibration"]
        with open(os.path.join(
                anno_dir, f"assemblyhands_{split}_joint_3d_v1-1.json")) as f:
            self.joints3d = json.load(f)["annotations"]

        invalid: set[str] = set()
        invalid_path = os.path.join(
            anno_dir, f"invalid_{split}_{modality}.txt")
        if os.path.exists(invalid_path):
            with open(invalid_path) as f:
                invalid = {line.strip() for line in f if line.strip()}

        self.images = {img["id"]: img for img in data["images"]}
        self.samples: list[tuple[dict, str]] = []
        for ann in data["annotations"]:
            file_name = self.images[ann["image_id"]]["file_name"]
            for hand_id, hand in enumerate(("right", "left")):
                bbox = (ann.get("bbox") or {}).get(hand)
                if bbox is None:
                    continue
                if f"{file_name},{hand_id}" in invalid:
                    continue
                jv = ann.get("joint_valid")
                if not invalid and jv is not None:
                    jv = np.asarray(jv, np.float32).reshape(-1)
                    half = jv[:21] if hand == "right" else jv[21:42]
                    if half.sum() < 10:
                        continue
                self.samples.append((ann, hand))

    def __len__(self):
        return len(self.samples)

    def _camera(self, img_rec):
        seq, cam = str(img_rec["seq_name"]), img_rec["camera"]
        frame = f"{img_rec['frame_idx']:06d}"
        K = np.asarray(
            self.calib[seq]["intrinsics"][cam + "_mono10bit"], np.float32
        )
        Rt = np.asarray(
            self.calib[seq]["extrinsics"][frame][cam + "_mono10bit"], np.float32
        )
        return K, Rt[:, :3], Rt[:, 3]

    def __getitem__(self, i: int) -> dict:
        import cv2

        from simhand_tpu_torch.data.crops import crop_and_resize_via_joints

        ann, hand = self.samples[i]
        img_rec = self.images[ann["image_id"]]
        img = cv2.cvtColor(
            cv2.imread(os.path.join(self.root, "images", img_rec["file_name"])),
            cv2.COLOR_BGR2RGB,
        )
        K, R, t = self._camera(img_rec)
        seq = str(img_rec["seq_name"])
        frame = f"{img_rec['frame_idx']:06d}"
        world = np.asarray(
            self.joints3d[seq][frame]["world_coord"], np.float32
        ).reshape(-1, 3)
        cam_xyz = world @ R.T + t

        half = slice(0, 21) if hand == "right" else slice(21, 42)
        joint_ah = cam_xyz[half] / 1000.0  # mm -> m
        uvw = joint_ah @ K.T
        kp2d = (uvw[:, :2] / np.maximum(uvw[:, 2:], 1e-9)).astype(np.float32)
        if hand == "left":
            # mirror to a right hand like the pre-train loaders: flip x
            img = cv2.flip(img, 1)
            kp2d[:, 0] = img.shape[1] - kp2d[:, 0]
            K = K.copy()
            K[0, 2] = img.shape[1] - K[0, 2]
            joint_ah = joint_ah * np.array([-1.0, 1.0, 1.0], np.float32)

        # AH annotates tips-first per finger with the wrist last (the
        # interhand layout); the reference gathers straight to snap order
        # (minimal-hand/datasets/assembly_hands.py:475-478).
        joint = _JM.interhand_to_freihand(joint_ah)
        kp2d = _JM.interhand_to_freihand(kp2d)
        if self.crop and kp2d.any():
            img, kp2d, K = crop_and_resize_via_joints(
                img, kp2d, self.CROP_SIZE, self.CROP_SCALE, K
            )
        return {"image": img, "K": K, "joint": joint, "kp2d": kp2d}


class AssemblyHandsEgo(AssemblyHands):
    """Egocentric modality (reference CLI key ``ah-ego``/``ah``)."""

    def __init__(self, root_dir, split="train", crop=True):
        super().__init__(root_dir, split, crop=crop, modality="ego")


class AssemblyHandsExo(AssemblyHands):
    """Exocentric modality (reference CLI key ``ah-exo``)."""

    def __init__(self, root_dir, split="train", crop=True):
        super().__init__(root_dir, split, crop=crop, modality="exo")


class Ego4DHands2D:
    """Hand100M crops as a 2D-only fine-tune set (flag_3d=0 — only the
    heatmap loss applies; reference: minimal-hand/datasets/ego4d_hands.py).

    Hand100M annotations are ait order; remapped to the freihand schema
    here. (Deliberate deviation: the reference reader leaves them in ait
    order — ego4d_hands.py:142-165 never applies its 'transform the index'
    step — which silently trains heatmap channels against a different
    joint assignment than every other subset.)"""

    def __init__(self, root_dir: str, source: str = "ego4d", scale: str = "1m"):
        from simhand_tpu_torch.data.sources.hand100m import Hand100MSource

        self.src = Hand100MSource(root_dir, source=source, scale=scale)

    def __len__(self):
        return len(self.src)

    def __getitem__(self, i: int) -> dict:
        s = self.src[i]
        kp2d = s["joints3D"][:, :2].astype(np.float32)
        return {
            "image": s["image"],
            "K": None,
            "joint": None,                       # no 3D labels
            "kp2d": kp2d[_JM.ait_to_freihand_idx],
        }


# --------------------------------------------------------------------------
# STB (Stereo Hand Pose Tracking Benchmark)
# --------------------------------------------------------------------------

# SK color-camera intrinsics/extrinsics (reference: datasets/stb.py:27-44)
STB_SK_INTR = np.array(
    [[607.92271, 0.0, 314.78337],
     [0.0, 607.88192, 236.42484],
     [0.0, 0.0, 1.0]], np.float32,
)
STB_SK_ROT_VEC = np.array([0.00531, -0.01196, 0.00301])
STB_SK_TRANS_VEC = np.array([-24.0381, -0.4563, -1.2326])  # mm

STB_SPLITS = {
    "train": ["B2Counting", "B2Random", "B3Counting", "B3Random",
              "B4Counting", "B4Random", "B5Counting", "B5Random",
              "B6Counting", "B6Random"],
    "val": ["B2Counting", "B2Random"],
    "test": ["B1Counting", "B1Random"],
}

# STB annotates palm + fingers pinky->thumb; "snap" order is the
# freihand/wrist-first order. stb index -> snap index:
STB_TO_SNAP = [0, 17, 18, 19, 20, 13, 14, 15, 16, 9, 10, 11, 12,
               5, 6, 7, 8, 1, 2, 3, 4]


def _rodrigues_quat(rot_vec: np.ndarray) -> np.ndarray:
    """STB's quaternion-style Rodrigues matrix (datasets/stb.py:46-77)."""
    theta = np.linalg.norm(rot_vec)
    v = np.asarray(rot_vec) * np.sin(theta / 2.0) / theta
    a, (b, c, d) = np.cos(theta / 2.0), -v
    return np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c + a * d), 2 * (b * d - a * c)],
        [2 * (b * c - a * d), a * a + c * c - b * b - d * d, 2 * (c * d + a * b)],
        [2 * (b * d + a * c), 2 * (c * d - a * b), a * a + d * d - b * b - c * c],
    ])


class STB:
    """Stereo Hand Pose Tracking Benchmark, SK color camera only
    (reference: minimal-hand/datasets/stb.py). Palm annotation is moved to
    the wrist via the 2.0x ring-mcp extrapolation (ge_palm2wrist)."""

    def __init__(self, root_dir: str, split: str = "train"):
        import scipy.io as sio

        self.root = root_dir
        rot = _rodrigues_quat(STB_SK_ROT_VEC)
        self.img_paths: list[str] = []
        joints_all = []
        for seq in STB_SPLITS[split]:
            mat = sio.loadmat(os.path.join(root_dir, "labels", f"{seq}_SK.mat"))
            raw = mat["handPara"].transpose(2, 1, 0)        # (N, 21, 3) mm
            # depth-cam -> color-cam, reorder, mm -> m
            xyz = (raw - STB_SK_TRANS_VEC[None, None]) @ rot
            snap = np.zeros_like(xyz)
            snap[:, STB_TO_SNAP, :] = xyz
            snap /= 1000.0
            # palm -> wrist: the ACTIVE reference path is ge_palm2wrist
            # (stb.py:125-131, selected at :270): ring_mcp + 2.0x
            snap[:, 0] = snap[:, 13] + 2.0 * (snap[:, 0] - snap[:, 13])
            joints_all.append(snap.astype(np.float32))
            for i in range(raw.shape[0]):
                self.img_paths.append(
                    os.path.join(root_dir, "images", seq, f"SK_color_{i}.png")
                )
        self.joints_snap = np.concatenate(joints_all)

    def __len__(self):
        return len(self.img_paths)

    def __getitem__(self, i: int) -> dict:
        import cv2

        img = cv2.cvtColor(cv2.imread(self.img_paths[i]), cv2.COLOR_BGR2RGB)
        joint = self.joints_snap[i].copy()          # snap == freihand order
        kp = (STB_SK_INTR @ joint.T).T
        kp2d = (kp[:, :2] / kp[:, 2:]).astype(np.float32)
        # STB is an all-LEFT-hand set; the reference mirrors every sample
        # to right (stb.py:348,376-380: hand_side='right' -> flip=True)
        w = img.shape[1]
        img = np.ascontiguousarray(img[:, ::-1])
        kp2d[:, 0] = w - kp2d[:, 0]
        joint[:, 0] = -joint[:, 0]
        return {"image": img, "K": STB_SK_INTR, "joint": joint, "kp2d": kp2d}


# --------------------------------------------------------------------------
# CMU hand_labels / hand143_panopticdb (2D), GANerated, Dexter+Object,
# EgoDexter — legacy minimal-hand train/eval sets.
# --------------------------------------------------------------------------

class CMUHandLabels:
    """CMU 'hand_labels' (manual annotations): per-image JSON with
    hand_pts (21, 3) = x, y, visible (reference: datasets/hand_labels.py).
    2D-only (flag_3d=0)."""

    def __init__(self, root_dir: str, split: str = "train"):
        sub = "manual_train" if split == "train" else "manual_test"
        self.dir = os.path.join(root_dir, sub)
        self.names = sorted(
            f[:-5] for f in os.listdir(self.dir) if f.endswith(".json")
        )

    def __len__(self):
        return len(self.names)

    def __getitem__(self, i: int) -> dict:
        import cv2

        name = self.names[i]
        with open(os.path.join(self.dir, name + ".json")) as f:
            a = json.load(f)
        img = cv2.cvtColor(
            cv2.imread(os.path.join(self.dir, name + ".jpg")), cv2.COLOR_BGR2RGB
        )
        # CMU hand_pts are OpenPose order = wrist-first freihand order
        pts = np.asarray(a["hand_pts"], np.float32)         # (21, 3) x,y,vis
        kp2d = pts[:, :2]
        return {"image": img, "K": None, "joint": None, "kp2d": kp2d}


class CMUPanoptic143:
    """hand143_panopticdb: one JSON (hands_v143_14817.json) of synthetic
    renders with 2D keypoints (reference: datasets/hand143_panopticdb.py)."""

    def __init__(self, root_dir: str):
        with open(os.path.join(root_dir, "hands_v143_14817.json")) as f:
            self.anno = json.load(f)["root"]
        self.root = root_dir

    def __len__(self):
        return len(self.anno)

    def __getitem__(self, i: int) -> dict:
        import cv2

        a = self.anno[i]
        img = cv2.cvtColor(
            cv2.imread(os.path.join(self.root, a["img_paths"])), cv2.COLOR_BGR2RGB
        )
        kp2d = np.asarray(a["joint_self"], np.float32)[:, :2]
        return {"image": img, "K": None, "joint": None, "kp2d": kp2d}


class GANeratedHands:
    """GANerated synthetic set: per-frame *_joint_pos.txt (21 x 3D, mm,
    normalized) + *_joint2D.txt (reference: datasets/ganerated_hands.py)."""

    def __init__(self, root_dir: str):
        self.frames = []
        for dirpath, _, files in os.walk(root_dir):
            for f in sorted(files):
                if f.endswith("_joint2D.txt"):
                    self.frames.append(os.path.join(dirpath, f[: -len("_joint2D.txt")]))

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i: int) -> dict:
        import cv2

        base = self.frames[i]
        img = cv2.cvtColor(
            cv2.imread(base + "_color_composed.png"), cv2.COLOR_BGR2RGB
        )
        kp2d = np.loadtxt(base + "_joint2D.txt", delimiter=",").reshape(21, 2)
        joint = np.loadtxt(base + "_joint_pos.txt", delimiter=",").reshape(21, 3)
        return {
            "image": img,
            "K": None,
            "joint": joint.astype(np.float32),   # native freihand order
            "kp2d": kp2d.astype(np.float32),
        }


# thumb..pinky tips in freihand order (reference: utils/align.py:31)
FINGERTIP_IDS = [4, 8, 12, 16, 20]


def _tip_center_scale(tips: np.ndarray) -> dict:
    """Crop box from the VALID fingertips only (the reference derives
    DO/EO center/my_scale from 5 tip points, dexter_object.py:157-165) —
    a 21-row extent over zero-filled rows would span from the image
    origin instead of around the hand."""
    valid = tips[(tips != 0).any(axis=1)]
    if len(valid) == 0:
        return {}
    center = np.array([int((valid[:, 0].min() + valid[:, 0].max()) / 2),
                       int((valid[:, 1].min() + valid[:, 1].max()) / 2)],
                      np.float32)
    scale = 2.0 * float(np.max(valid.max(axis=0) - valid.min(axis=0)))
    return {"center": center, "my_scale": np.float32(max(scale, 1.0))}


# Dexter+Object camera chain, vendored from the reference
# (dexter_object.py:74-89): the fingertip annotations live in the DEPTH
# frame (320x240); color-frame 2D comes from projecting the 3D tips
# (x, y negated) through color_intrinsics @ color_extrinsics.
DO_M_COLOR = np.array([[587.45209, 0, 325.0],
                       [0, 600.67456, 249.0],
                       [0, 0, 1.0]]) @ np.array(
    [[0.9999, 0.0034, 0.0161, 19.0473],
     [-0.0033, 1.0000, -0.0079, -1.8514],
     [-0.0162, 0.0079, 0.9998, -4.7501]])


def _parse_tip_rows(path: str, dims: int) -> np.ndarray:
    """Semicolon-grouped, comma-separated tip annotations (the official
    DO/EO text layout, reference dexter_object.py:129-151). One output
    row PER LINE — partially-annotated tips become NaN instead of the
    line being dropped, preserving the row-index -> frame-filename
    pairing (the reference NaN-fills for exactly this reason,
    egodexter.py:333)."""
    rows = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            groups = line.strip().rstrip(";").split(";")
            if len(groups) == 1:
                # flat comma-only layout: consecutive value d-tuples
                flat = [p for p in groups[0].split(",") if p.strip()]
                groups = [
                    ",".join(flat[k * dims : (k + 1) * dims])
                    for k in range(5)
                ]
            vals = np.full((5, dims), np.nan, np.float32)
            for g in range(min(5, len(groups))):
                parts = [p for p in groups[g].split(",") if p.strip()]
                if len(parts) >= dims:
                    try:
                        vals[g] = [float(p) for p in parts[:dims]]
                    except ValueError:
                        pass
            rows.append(vals)
    return np.stack(rows) if rows else np.zeros((0, 5, dims), np.float32)


class DexterObject:
    """Dexter+Object: fingertip-only annotations, evaluated in the COLOR
    frame (reference: datasets/dexter_object.py). 3D tips (my_{seq}3D.txt
    or {seq}3D.txt) are projected via the vendored camera chain; every
    sample is mirrored left->right (hand_side='right', :255-264). Without
    the 3D files, falls back to the raw {seq}2D.txt DEPTH-frame tips
    (misaligned with the color image — documented degraded mode). The
    crop box derives from the valid tips (the reference uses its shipped
    DO_pred_2d.npy predictions — an asset; the annotation-tip box is the
    reproducible substitute). Emits 21-joint arrays with only the 5 tips
    valid — consumers mask via the veil/valid channels."""

    SEQS = ("Grasp1", "Grasp2", "Occlusion", "Rigid", "Pinch", "Rotate")

    def __init__(self, root_dir: str):
        self.samples: list[tuple[str, np.ndarray, bool]] = []
        for seq in self.SEQS:
            anno_dir = os.path.join(root_dir, "data", seq, "annotations")
            img_dir = os.path.join(root_dir, "data", seq, "color")
            tips3d = None
            for name in (f"my_{seq}3D.txt", f"{seq}3D.txt"):
                p = os.path.join(anno_dir, name)
                if os.path.exists(p):
                    tips3d = _parse_tip_rows(p, 3)
                    break
            if tips3d is not None:
                for idx in range(len(tips3d)):
                    raw = tips3d[idx].copy()
                    # occlusion sentinel: z == 32001 invalidates the ROW
                    # (dexter_object.py:153-155, exact match on z)
                    raw[raw[:, 2] == 32001.0] = np.nan
                    # file values are mm; the reference divides by 1000
                    # at load then re-multiplies at projection — net raw
                    # mm into M_color (dexter_object.py:167,238)
                    j = raw * np.array([-1.0, -1.0, 1.0], np.float32)
                    valid = np.isfinite(j).all(axis=1)
                    h = np.concatenate(
                        [np.nan_to_num(j).T, np.ones((1, 5))], axis=0)
                    uv = DO_M_COLOR @ h
                    tips = (uv[:2] / uv[2]).T.astype(np.float32)
                    tips[~valid] = 0.0
                    # 3D gt for the masked-tip protocol: joint_process
                    # frame (x/y negated) in meters, NaN rows preserved
                    # (dexter_object.py:167,230-236)
                    t3d = (j / 1000.0).astype(np.float32)
                    self.samples.append(
                        (os.path.join(img_dir, f"color_{idx:05d}.png"),
                         tips, True, t3d))
                continue
            # degraded fallback: depth-frame 2D tips (legacy {seq}.txt or
            # official {seq}2D.txt)
            for name in (f"{seq}2D.txt", f"{seq}.txt"):
                p = os.path.join(anno_dir, name)
                if os.path.exists(p):
                    for idx, tips in enumerate(_parse_tip_rows(p, 2)):
                        self.samples.append(
                            (os.path.join(img_dir, f"color_{idx:05d}.png"),
                             np.nan_to_num(tips), False, None))
                    break

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int) -> dict:
        import cv2

        path, tips, color_frame, t3d = self.samples[i]
        img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        tips = tips.copy()
        if color_frame:
            # mirror to right hands, like the reference (every sample)
            w = img.shape[1]
            img = np.ascontiguousarray(img[:, ::-1])
            valid = (tips != 0).any(axis=1)
            tips[valid, 0] = w - tips[valid, 0]
        kp2d = np.zeros((21, 2), np.float32)
        kp2d[FINGERTIP_IDS] = tips
        out = {"image": img, "K": None, "joint": None, "kp2d": kp2d,
               "tip_only": True, **_tip_center_scale(tips)}
        if t3d is not None:
            t3d = t3d.copy()
            t3d[:, 0] = -t3d[:, 0]       # flip with the mirrored image
            out["tips_3d"] = t3d         # (5, 3) m, NaN rows invalid
        return out


# EgoDexter camera chain (reference egodexter.py:58-65): 3D tips (mm)
# project into the color frame via color_intrinsics @ color_extrinsics.
EO_M_COLOR = np.array([[617.173, 0, 315.453],
                       [0, 617.173, 242.259],
                       [0, 0, 1.0]]) @ np.array(
    [[1.0000, 0.00090442, -0.0074, 20.2365],
     [-0.00071933, 0.9997, 0.0248, 1.2846],
     [0.0075, -0.0248, 0.9997, 5.7360]])


class EgoDexter:
    """EgoDexter: egocentric fingertip-only annotations, color frame
    (reference: datasets/egodexter.py). 3D tips from
    (my_)annotation.txt_3D.txt (mm; zero rows invalid) projected via the
    vendored camera chain; every sample mirrored left->right (:175-181);
    the reference's fixed CenterCrop(480, 480) becomes a per-sample
    center/my_scale so the builder's affine reproduces it. Without the
    3D file, falls back to annotation.txt DEPTH-frame tips (misaligned
    with the color image — documented degraded mode)."""

    SEQS = ("Desk", "Fruits", "Kitchen", "Rotunda")

    def __init__(self, root_dir: str):
        self.samples: list[tuple[str, np.ndarray, bool]] = []
        for seq in self.SEQS:
            seq_dir = os.path.join(root_dir, "data", seq)
            img_dir = os.path.join(seq_dir, "color")
            tips3d = None
            for name in ("my_annotation.txt_3D.txt", "annotation.txt_3D.txt"):
                p = os.path.join(seq_dir, name)
                if os.path.exists(p):
                    tips3d = _parse_tip_rows(p, 3)
                    break
            if tips3d is not None:
                for idx in range(len(tips3d)):
                    j = tips3d[idx]                        # mm
                    valid = (np.isfinite(j).all(axis=1)
                             & (np.abs(np.nan_to_num(j)) > 1e-6).any(axis=1))
                    if not valid.any():
                        continue
                    h = np.concatenate(
                        [np.nan_to_num(j).T, np.ones((1, 5))], axis=0)
                    uv = EO_M_COLOR @ h
                    tips = (uv[:2] / uv[2]).T.astype(np.float32)
                    tips[~valid] = 0.0
                    # 3D gt for the masked-tip protocol: meters, NaN
                    # rows invalid (egodexter.py:114,167-181)
                    t3d = (j / 1000.0).astype(np.float32)
                    t3d[~valid] = np.nan
                    self.samples.append(
                        (os.path.join(img_dir,
                                      f"image_{idx:05d}_color.png"),
                         tips, True, t3d))
                continue
            anno = os.path.join(seq_dir, "annotation.txt")
            if not os.path.exists(anno):
                continue
            for idx, tips in enumerate(_parse_tip_rows(anno, 2)):
                tips = np.nan_to_num(tips)
                if not tips.any():
                    continue
                self.samples.append(
                    (os.path.join(img_dir, f"image_{idx:05d}_color.png"),
                     tips, False, None))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int) -> dict:
        import cv2

        path, tips, color_frame, t3d = self.samples[i]
        img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        tips = tips.copy()
        h, w = img.shape[:2]
        if color_frame:
            # mirror to right hands, like the reference (every sample)
            img = np.ascontiguousarray(img[:, ::-1])
            valid = (tips != 0).any(axis=1)
            tips[valid, 0] = w - tips[valid, 0]
        kp2d = np.zeros((21, 2), np.float32)
        kp2d[FINGERTIP_IDS] = tips
        # reference transform: CenterCrop(480, 480) on the 640x480 frame
        out = {"image": img, "K": None, "joint": None, "kp2d": kp2d,
               "tip_only": True,
               "center": np.array([w / 2.0, h / 2.0], np.float32),
               "my_scale": np.float32(min(480.0, float(min(h, w))))}
        if t3d is not None:
            t3d = t3d.copy()
            t3d[:, 0] = -t3d[:, 0]       # flip with the mirrored image
            out["tips_3d"] = t3d         # (5, 3) m, NaN rows invalid
        return out
