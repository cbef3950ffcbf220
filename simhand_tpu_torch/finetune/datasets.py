"""Fine-tune datasets and the training-sample pipeline (counterpart of
``simhand_tpu/finetune/datasets.py``).

``FreiHand`` reads the official FreiHAND release layout
(training/rgb/%08d.jpg + training_{xyz,K,scale}.json), with the reference's
x4 green-screen replication on the train split
(minimal-hand/datasets/freihand.py:52-110); it imports ``cv2`` to decode.
``SyntheticPoseDataset`` provides a file-free stand-in with identical
sample schema.

``DetnetSampleBuilder`` converts a raw sample (image + kp2d + optional 3D
joints + K) into detnet training targets, replicating
minimal-hand/datasets/handataset.py:244-390:
  center/scale jitter (±0.1), rotation (±pi), affine crop to 128x128,
  gaussian heatmaps sigma=1 @ 32x32, location/delta maps, blur+color
  jitter, normalize(mean 0.5, std 1).

It is split in two, as the pre-training augmentation is:
  * on the host, in numpy, as the JAX package does it: every draw from the
    caller's generator in the JAX package's order, the centre and scale,
    the affine, the rotation, the heatmaps, the location and delta maps,
    the joints and ``kp2d_valid``, bit for bit (``DetnetSampleBuilder.build``);
  * the image stage (``image_stage``) in torch on the batch's device, once
    a batch: the same function as the JAX builder's ``cv2`` calls (the
    blur, the colour jitter in its drawn order, the affine crop), with no
    ``cv2``. ``detnet_batch_iterator(..., device=...)`` yields the JAX
    package's keys with ``img`` on that device.

``SIK1M`` reads ShapeNet's (relative bone length, MANO beta) pairs, bit for
bit the JAX package's samples; ``create_sik1m_data`` writes them, the betas
drawn and the bones computed on the MANO model's device.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from simhand_tpu_torch.device import resolve_device
from simhand_tpu_torch.finetune.image_stage import (
    ImageDraws,
    cv2_inverse_map,
    gaussian_kernel_u8,
    identity_kernel,
    image_stage,
    photometric,
    warp_affine_u8,
)
from simhand_tpu_torch.finetune.maps import gen_heatmaps, joint_maps

INP_RES = 128
HM_RES = 32


# --------------------------------------------------------------------------
# affine helpers (reference: minimal-hand/utils/handutils.py:364-430)
# --------------------------------------------------------------------------

def get_affine_trans_no_rot(center, scale, res):
    m = np.zeros((3, 3), np.float32)
    m[0, 0] = float(res[1]) / scale
    m[1, 1] = float(res[0]) / scale
    m[0, 2] = res[1] * (-float(center[0]) / scale + 0.5)
    m[1, 2] = res[0] * (-float(center[1]) / scale + 0.5)
    m[2, 2] = 1
    return m


def get_affine_transform(center, scale, res, rot=0.0):
    rot_mat = np.zeros((3, 3), np.float32)
    sn, cs = np.sin(rot), np.cos(rot)
    rot_mat[0, :2] = [cs, -sn]
    rot_mat[1, :2] = [sn, cs]
    rot_mat[2, 2] = 1
    origin_rot_center = rot_mat.dot(list(center) + [1])[:2]
    post_rot_trans = get_affine_trans_no_rot(origin_rot_center, scale, res)
    return post_rot_trans.dot(rot_mat), rot_mat


def transform_coords(pts, affine):
    hom = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
    return (affine.dot(hom.T).T)[:, :2]


def transform_img(img: np.ndarray, affine: np.ndarray, res) -> np.ndarray:
    """``transform_img_cv2`` without cv2: cv2.warpAffine's bilinear crop on
    the CPU (``image_stage.warp_affine_u8``); uint8 (res[0], res[1], C)."""
    inverse = torch.from_numpy(cv2_inverse_map(affine))[None]
    out = warp_affine_u8(torch.from_numpy(np.ascontiguousarray(img))[None], inverse, res)
    return out[0].numpy()


# --------------------------------------------------------------------------
# datasets
# --------------------------------------------------------------------------

class FreiHand:
    """Official FreiHAND layout. Sample: image path + K + xyz + kp2d."""

    def __init__(self, root_dir: str, split: str = "train",
                 train_ratio: float = 0.8, replicate: bool = True):
        self.root = root_dir
        with open(os.path.join(root_dir, "training_K.json")) as f:
            self.K = np.asarray(json.load(f), np.float32)
        with open(os.path.join(root_dir, "training_xyz.json")) as f:
            self.xyz = np.asarray(json.load(f), np.float32)
        n = len(self.xyz)
        split_idx = int(n * train_ratio)
        base = np.arange(split_idx) if split == "train" else np.arange(split_idx, n)
        if split == "train" and replicate:
            # x4: original + 3 green-screen-composited versions share labels
            self.indices = np.concatenate([base + k * n for k in range(4)])
        else:
            self.indices = base
        self.n_unique = n

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i: int) -> dict:
        import cv2

        idx = int(self.indices[i])
        label_idx = idx % self.n_unique
        img = cv2.cvtColor(
            cv2.imread(os.path.join(self.root, "training", "rgb", f"{idx:08d}.jpg")),
            cv2.COLOR_BGR2RGB,
        )
        K = self.K[label_idx]
        xyz = self.xyz[label_idx]
        kp2d = (K @ xyz.T).T
        kp2d = kp2d[:, :2] / kp2d[:, 2:]
        return {"image": img, "K": K, "joint": xyz, "kp2d": kp2d.astype(np.float32)}


class SyntheticPoseDataset:
    """File-free dataset with the FreiHand sample schema (tests/smoke).

    ``render_joints=False`` (default) yields pure-noise images — enough
    for shape/plumbing tests but with NO image<->pose correlation.
    ``render_joints=True`` draws a color blob at every keypoint over the
    noise, the same visual statistic as the synthetic pretrain corpus
    (data/sources/synthetic.py:_render_hand), so learning — and transfer
    from a pretrained encoder — is actually possible (registry key
    ``synthetic-hand``; used by the pretraining-transfers check).
    """

    def __init__(self, n: int = 32, side: int = 224, seed: int = 0,
                 render_joints: bool = False):
        self.n = n
        self.side = side
        self.seed = seed
        self.render_joints = render_joints

    def __len__(self):
        return self.n

    def __getitem__(self, i: int) -> dict:
        rng = np.random.default_rng([self.seed, i])
        xyz = rng.uniform(-0.05, 0.05, (21, 3)).astype(np.float32)
        xyz[:, 2] += 0.5
        K = np.array(
            [[400.0, 0, self.side / 2], [0, 400.0, self.side / 2], [0, 0, 1]],
            np.float32,
        )
        kp2d = (K @ xyz.T).T
        kp2d = (kp2d[:, :2] / kp2d[:, 2:]).astype(np.float32)
        img = rng.integers(0, 255, (self.side, self.side, 3), dtype=np.uint8)
        if self.render_joints:
            color = rng.integers(100, 255, size=3)
            for x, y in kp2d.astype(np.int32):
                x0, x1 = max(x - 2, 0), min(x + 3, self.side)
                y0, y1 = max(y - 2, 0), min(y + 3, self.side)
                img[y0:y1, x0:x1] = color
        return {"image": img, "K": K, "joint": xyz, "kp2d": kp2d}


# --------------------------------------------------------------------------
# multi-dataset composition
# --------------------------------------------------------------------------

class ConcatDataset:
    """Concatenation with cumulative index routing — the reference's
    HandDataset hub semantics (minimal-hand/datasets/handataset.py:240-242,
    511-521): sample i belongs to the first dataset whose cumulative length
    exceeds i."""

    def __init__(self, datasets):
        assert datasets, "need at least one dataset"
        self.datasets = list(datasets)
        for i, d in enumerate(self.datasets):
            if len(d) == 0:
                raise ValueError(
                    f"dataset #{i} ({type(d).__name__}) is empty — check "
                    "its root/split (a tiny freihand root with the default "
                    "train_ratio can leave the train split empty)"
                )
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, i: int) -> dict:
        if i < 0 or i >= len(self):
            raise IndexError(i)
        d = int(np.searchsorted(self._offsets, i, side="right") - 1)
        return self.datasets[d][i - int(self._offsets[d])]


class WeightedMixDataset:
    """Weighted sampling mix: a virtual epoch of ``epoch_size`` samples,
    sample i drawn from dataset d with probability ``weights[d]`` (then
    uniformly within d), deterministically from ``(seed, epoch, i)`` so
    the mix is reproducible and shardable. ``set_epoch`` (called by
    ``detnet_batch_iterator``) redraws the multiset each epoch — without
    it every epoch would repeat one fixed draw and samples outside it
    would never be trained on.

    The reference approximates dataset balancing by subsampling at
    construction (handataset.py ``subset_ratio``); per-sample weighted
    routing subsumes that without discarding data.
    """

    def __init__(self, datasets, weights=None, epoch_size: int | None = None,
                 seed: int = 0):
        assert datasets, "need at least one dataset"
        self.datasets = list(datasets)
        for i, d in enumerate(self.datasets):
            if len(d) == 0:
                raise ValueError(
                    f"dataset #{i} ({type(d).__name__}) is empty — check "
                    "its root/split"
                )
        if weights is None:
            weights = [float(len(d)) for d in self.datasets]
        assert len(weights) == len(self.datasets)
        w = np.asarray(weights, np.float64)
        assert (w >= 0).all() and w.sum() > 0, weights
        self.weights = w / w.sum()
        self.epoch_size = (
            int(epoch_size) if epoch_size is not None
            else sum(len(d) for d in self.datasets)
        )
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def __len__(self):
        return self.epoch_size

    def __getitem__(self, i: int) -> dict:
        if i < 0 or i >= len(self):
            raise IndexError(i)
        rng = np.random.default_rng([self.seed, self._epoch, i])
        d = int(rng.choice(len(self.datasets), p=self.weights))
        ds = self.datasets[d]
        return ds[int(rng.integers(len(ds)))]


# --------------------------------------------------------------------------
# sample builder
# --------------------------------------------------------------------------

def draw_photometric(rng: np.random.Generator, brightness: float = 0.5,
                     contrast: float = 0.5, saturation: float = 0.5,
                     hue: float = 0.15, blur_radius: float = 0.5
                     ) -> tuple[np.ndarray, tuple, tuple]:
    """photometric_augment's draws from ``rng`` in the JAX package's order:
    the blur radius, the brightness, saturation, hue and contrast factors
    (each drawn, as the reference's default arguments are, even when its
    strength is 0), then the shuffle of the enabled ops. Returns the blur
    kernel, the factors (the hue one as cv2's hue shift) and the op order."""
    r = float(rng.uniform()) * blur_radius
    kernel = gaussian_kernel_u8(r) if r > 1e-3 else identity_kernel()
    f_b = float(rng.uniform(max(0, 1 - brightness), 1 + brightness))
    f_s = float(rng.uniform(max(0, 1 - saturation), 1 + saturation))
    f_h = float(rng.uniform(-hue, hue))
    f_c = float(rng.uniform(max(0, 1 - contrast), 1 + contrast))
    # numpy rounds each factor to float32 where it meets a float32 image
    factors = (float(np.float32(f_b)), float(np.float32(f_s)), int(round(f_h * 180)),
               float(np.float32(f_c)))
    # the op indices of the enabled ops, shuffled as the reference's list
    # of functions is (zero-strength ops are skipped entirely)
    order = [op for op, strength in enumerate((brightness, saturation, hue, contrast))
             if strength > 0]
    rng.shuffle(order)
    return kernel, factors, tuple(order)


def photometric_augment(img: np.ndarray, rng: np.random.Generator,
                        brightness: float = 0.5, contrast: float = 0.5,
                        saturation: float = 0.5, hue: float = 0.15,
                        blur_radius: float = 0.5) -> np.ndarray:
    """Train-time blur + color jitter of the reference fine-tune loader
    (handataset.py:367-377 + utils/imgutils.py:10-58): gaussian blur with
    radius ~ U(0,1)*blur_radius, then brightness/saturation/hue/contrast
    factors drawn like torchvision ColorJitter and applied in a SHUFFLED
    order. The JAX package's function on one uint8 frame, on the CPU,
    without cv2 (``image_stage.photometric``); uint8 in/out."""
    kernel, factors, order = draw_photometric(rng, brightness, contrast, saturation, hue,
                                              blur_radius)
    draws = ImageDraws(np.zeros(6, np.float32), kernel, factors, order)
    return photometric(torch.from_numpy(np.ascontiguousarray(img))[None], [draws])[0].numpy()


class DetnetSampleBuilder:
    def __init__(
        self,
        train: bool = True,
        inp_res: int = INP_RES,
        hm_res: int = HM_RES,
        sigma: float = 1.0,
        center_jitter: float = 0.1,
        scale_jitter: float = 0.1,
        max_rot: float = np.pi,
        crop_scale: float = 2.0,
        color_jitter: bool = True,
    ):
        self.train = train
        self.inp_res = inp_res
        self.hm_res = hm_res
        self.sigma = sigma
        self.center_jitter = center_jitter
        self.scale_jitter = scale_jitter
        self.max_rot = max_rot
        self.crop_scale = crop_scale
        self.color_jitter = color_jitter

    def build(self, sample: dict, rng: np.random.Generator
              ) -> tuple[dict, np.ndarray, ImageDraws]:
        """The host half: every target but ``img``, the uint8 frame and its
        image stage's draws."""
        kp2d = sample["kp2d"]
        # per-dataset center/my_scale win when the reader provides them
        # (the reference HandDataset consumes sample['center'] /
        # sample['my_scale'], handataset.py:254-255); fallback: reference
        # get_annot_center / get_annot_scale (handutils.py:191-205,293-301:
        # kp2d extent, factor 2.0)
        if sample.get("center") is not None:
            center = np.asarray(sample["center"], np.float64)
        else:
            center = np.trunc(
                0.5 * (kp2d.min(axis=0) + kp2d.max(axis=0))
            )
        if sample.get("my_scale") is not None:
            scale = float(sample["my_scale"])
        else:
            scale = self.crop_scale * np.max(
                kp2d.max(axis=0) - kp2d.min(axis=0)
            )

        if self.train:
            center = center + (
                self.center_jitter * scale * rng.uniform(-1, 1, 2)
            ).astype(int)
            sj = np.clip(
                self.scale_jitter * rng.standard_normal() + 1,
                1 - self.scale_jitter,
                1 + self.scale_jitter,
            )
            scale = scale * sj
            rot = rng.uniform(-self.max_rot, self.max_rot)
        else:
            rot = 0.0

        affine, rot_mat = get_affine_transform(
            center, scale, [self.inp_res, self.inp_res], rot
        )
        kp2d_t = transform_coords(kp2d, affine)

        hm, veil = gen_heatmaps(kp2d_t, self.inp_res, self.hm_res, self.sigma)

        # raw-annotation validity (pre-transform: zero-filled tip-only
        # rows / DexYCB vis) — the affine moves raw zeros off zero, so
        # consumers can't reconstruct this from the transformed kp2d
        valid = sample.get("vis")
        if valid is None:
            valid = (kp2d != 0).any(axis=-1)
        out = {
            "hm": hm,
            "hm_veil": veil,
            "flag_3d": np.float32(0.0),
            "dm": np.zeros((self.hm_res, self.hm_res, 21, 3), np.float32),
            "lm": np.zeros((self.hm_res, self.hm_res, 21, 3), np.float32),
            "kp2d": kp2d_t.astype(np.float32),
            "kp2d_valid": np.asarray(valid, np.float32),
        }
        if "joint" in sample and sample["joint"] is not None:
            joint = rot_mat[:3, :3].dot(sample["joint"].T).T
            lm, dm, root, bone = joint_maps(joint, self.hm_res)
            out.update(
                {
                    "lm": lm,
                    "dm": dm,
                    "flag_3d": np.float32(1.0),
                    "joint": joint.astype(np.float32),
                    "joint_root": root.astype(np.float32),
                    "joint_bone": bone,
                }
            )

        if sample.get("tips_3d") is not None:
            # DO/EO 3D gt tips for the masked-tip eval protocol
            out["tips_3d"] = np.asarray(sample["tips_3d"], np.float32)

        # reference order: blur + color jitter on the full frame, THEN the
        # affine crop (handataset.py:367-384); the image stage applies both
        draws = ImageDraws(cv2_inverse_map(affine))
        if self.train and self.color_jitter:
            kernel, factors, order = draw_photometric(rng)
            draws = draws._replace(blur=kernel, factors=factors, order=order)
        return out, np.ascontiguousarray(sample["image"]), draws

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        """One sample as the JAX builder gives it, ``img`` included (the
        image stage on the CPU)."""
        out, frame, draws = self.build(sample, rng)
        out["img"] = image_stage([frame], [draws], self.inp_res, "cpu")[0].numpy()
        return out


_RIDERS = ("joint", "joint_root", "joint_bone", "tips_3d")


def detnet_batch_iterator(dataset, builder: DetnetSampleBuilder, batch_size: int,
                          seed: int = 0, epoch: int = 0, shuffle: bool = True,
                          drop_remainder: bool = True, device=None,
                          shard: tuple[int, int] | None = None):
    """Batches in the JAX package's order with its keys: the targets as
    numpy arrays, ``img`` a float32 tensor on ``device`` (``cuda`` unless
    the caller passes ``"cpu"``), made by one image stage a batch.
    ``drop_remainder=False`` (eval) also yields the final partial batch, so
    no sample is silently excluded from reported metrics.

    ``shard=(index, count)`` builds only rows ``[index B/count, (index+1)
    B/count)`` of each global batch of ``batch_size`` (``shard_batch``'s
    rows; every sample's draws are keyed by its index, so they are the
    same rows), so a data-parallel rank decodes and augments its share
    alone."""
    dev = resolve_device(device)
    if shard is not None and batch_size % shard[1]:
        raise ValueError(f"batch_size {batch_size} does not split over {shard[1]} ranks")
    if hasattr(dataset, "set_epoch"):
        dataset.set_epoch(epoch)
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng([seed, epoch]).shuffle(order)
    n_batches = n // batch_size if drop_remainder else -(-n // batch_size)
    for b in range(n_batches):
        idxs = order[b * batch_size : (b + 1) * batch_size]
        if shard is not None:
            n_local = batch_size // shard[1]
            idxs = idxs[shard[0] * n_local:(shard[0] + 1) * n_local]
        samples, frames, draws = [], [], []
        for i in idxs:
            rng = np.random.default_rng([seed, epoch, int(i)])
            out, frame, d = builder.build(dataset[int(i)], rng)
            samples.append(out)
            frames.append(frame)
            draws.append(d)
        keys = [k for k in samples[0] if k not in _RIDERS]
        batch = {k: np.stack([s[k] for s in samples]) for k in keys}
        batch["img"] = image_stage(frames, draws, builder.inp_res, dev)
        # metric joints / DO-EO 3D tips ride along only when the whole
        # batch has them (mixed 2D/3D batches from composed datasets
        # train fine — the loss gates 3D terms per-sample via flag_3d —
        # but can't carry a ragged array)
        if all("joint" in s for s in samples):
            for k in ("joint", "joint_root", "joint_bone"):
                batch[k] = np.stack([s[k] for s in samples])
        if all("tips_3d" in s for s in samples):
            batch["tips_3d"] = np.stack([s["tips_3d"] for s in samples])
        yield batch


# --------------------------------------------------------------------------
# SIK1M: (relative bone length, MANO beta) pairs for ShapeNet training
# --------------------------------------------------------------------------

# 0.1 x the per-bone std of relative bone lengths, added as train-time
# noise (reference: minimal-hand/datasets/SIK1M.py:56-60; bone 6 — the
# reference bone itself — has zero std by construction).
SIK1M_NOISE = np.array(
    [0.02906406, 0.02663224, 0.01769793, 0.0274501, 0.02573783, 0.0222863,
     0.0, 0.02855567, 0.02330295, 0.0253288, 0.0266308, 0.02495683,
     0.03685857, 0.02430637, 0.02349446], np.float64,
) / 10.0


class SIK1M:
    """npy-pair dataset ``data_bone.npy`` (N, 15) / ``data_shape.npy``
    (N, 10) with an 80/20 head/tail split and Gaussian bone-length noise
    on every fetch (reference: minimal-hand/datasets/SIK1M.py:12-79).
    """

    def __init__(self, data_root: str, data_split: str = "train",
                 split_ratio: float = 0.8, seed: int = 0):
        self.bone_len = np.load(os.path.join(data_root, "data_bone.npy"))
        self.shape = np.load(os.path.join(data_root, "data_shape.npy"))
        n = self.shape.shape[0]
        n_train = int(n * split_ratio)
        if data_split == "train":
            self.index = np.arange(n_train)
        elif data_split in ("val", "test"):
            self.index = np.arange(n_train, n)
        else:
            self.index = np.arange(n)
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.index)

    def __getitem__(self, i: int) -> dict:
        j = self.index[i]
        noise = SIK1M_NOISE * self._rng.standard_normal(15)
        return {
            "rel_bone_len": self.bone_len[j] + noise,
            "shape": self.shape[j].copy(),
        }


def create_sik1m_data(mano, total: int, out_dir: str,
                      batch: int = 4096, seed: int = 0) -> None:
    """Generates the SIK1M npy pair: beta ~ 3*N(0,1) -> MANO relative bone
    lengths, written as data_bone.npy / data_shape.npy (reference:
    minimal-hand/create_data.py:55-113). The betas come from a
    ``torch.Generator`` on the MANO model's device, ``batch`` at a time, and
    the pairs stay there until they are written."""
    from simhand_tpu_torch.finetune.mano import relative_bone_lengths

    dev = mano.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    data_bone = torch.empty((total, 15), device=dev)
    data_shape = torch.empty((total, 10), device=dev)
    with torch.no_grad():
        for t0 in range(0, total, batch):
            t1 = min(t0 + batch, total)
            beta = 3.0 * torch.randn((t1 - t0, 10), generator=gen, device=dev)
            data_bone[t0:t1] = relative_bone_lengths(mano, beta)
            data_shape[t0:t1] = beta
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "data_bone.npy"), data_bone.cpu().double().numpy())
    np.save(os.path.join(out_dir, "data_shape.npy"), data_shape.cpu().double().numpy())
