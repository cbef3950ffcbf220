"""Pre-training samples and batches (counterpart of
``simhand_tpu/data/pipeline.py``).

``PretrainDataset`` routes each index through the experiment type's prep
and gives the batch dict of the train step:

  transformed_image{1,2} : float32 (H, W, 3), ImageNet-normalized
  joints{1,2}_ori        : raw normalized keypoints x resize_shape
  joints{1,2}_aug        : post-augmentation 2.5D joints
  angle_{1,2}, jitter_{x,y}_{1,2} : per-view augment params

Two routes, as in the JAX package:
  * the raw route, the production path: ``raw_batch`` assembles both
    views' uint8 crops and joints straight off a packed cache source with
    the native gather; ``batch_iterator(..., raw=True)`` yields those
    batches, ``data.prefetch`` moves them to the card and
    ``data.augment.prepare_views`` augments them inside the train step;
  * the host route (``__getitem__``, ``batch_iterator(raw=False)``): the
    reference's OpenCV chain (``HostAugmenter``) on the host, drawing from
    a generator seeded by (seed, epoch, index), so it gives the JAX
    package's batches bit for bit. It needs ``cv2``.

The supervised route (``_supervised``, the fine-tune side's 2.5D samples)
takes the host route.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence

import numpy as np
import torch

from simhand_tpu_torch.core import geometry
from simhand_tpu_torch.core.joints import CHILD_JOINT, PARENT_JOINT
from simhand_tpu_torch.data import staging
from simhand_tpu_torch.data.augment_cv2 import (
    AppliedParams,
    AugmentFlags,
    AugmentParams,
    HostAugmenter,
)
from simhand_tpu_torch.utils import trace

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

SIMILAR_PAIR_TYPES = {"simhand-base", "simhand", "simhand_w", "simhand_vis"}
WEIGHTED_TYPES = {"simclr_w", "peclr_w", "simhand_w", "simhand_vis"}
PARAM_TYPES = {"peclr", "peclr_w", "simhand-base", "simhand", "simhand_w", "simhand_vis"}


def normalize_image(img_uint8: np.ndarray) -> np.ndarray:
    """uint8 RGB -> float32 (H, W, 3), ImageNet statistics."""
    x = img_uint8.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def convert_to_2_5d_np(K: np.ndarray, joints_3d: np.ndarray) -> np.ndarray:
    """Camera-space joints -> 2.5D (pixel u, v, depth relative to the wrist
    over the wrist -> index_mcp bone), in numpy for the loader's hot path;
    single (21, 3) or batched (..., 21, 3) joints with a shared or
    per-sample K. For the Hand100M sources (K = I, depth 1) it leaves x and
    y as they are and sets z to 0."""
    j = np.asarray(joints_3d, np.float64)
    K = np.asarray(K, np.float64)
    scale = np.linalg.norm(
        j[..., CHILD_JOINT, :] - j[..., PARENT_JOINT, :], axis=-1
    )
    proj = np.einsum("...ij,...kj->...ki", K, j) / j[..., -1:]
    z_rel = (j[..., -1] - j[..., PARENT_JOINT, -1][..., None]
             ) / scale[..., None]
    return np.concatenate(
        [proj[..., :2], z_rel[..., None]], axis=-1
    ).astype(np.float32)


class PretrainDataset:
    """Index-addressable prepared samples for any experiment type."""

    def __init__(
        self,
        source,
        experiment_type: str,
        flags: AugmentFlags,
        params: AugmentParams,
        seed: int = 0,
        use_palm: bool = False,
    ):
        self.source = source
        self.experiment_type = experiment_type
        self.augmenter = HostAugmenter(flags, params)
        self.flags = flags
        self.params = params
        self.seed = seed
        # supervised route only: regress the palm (midpoint of wrist and
        # index_mcp, ait order) instead of the wrist — reference
        # data_set.py:388-396 / --use_palm
        self.use_palm = use_palm

    def __len__(self) -> int:
        return len(self.source)

    def _rng(self, idx: int, epoch: int = 0) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, idx])
        )

    def _prep_view(self, sample: dict, rng, override_jitter):
        img, j_aug, _, applied = self.augmenter.transform(
            sample["image"],
            convert_to_2_5d_np(sample["K"], sample["joints3D"]),
            rng,
            override_angle=None,
            override_jitter=override_jitter,
        )
        return normalize_image(img), j_aug, applied

    def _ori_joints(self, sample: dict) -> np.ndarray:
        j = sample["joints_raw"].copy()
        j[:, 0] *= self.params.resize_shape[1]
        j[:, 1] *= self.params.resize_shape[0]
        return j

    @staticmethod
    def _param_dict(applied: AppliedParams, view: int) -> dict:
        out = {}
        for key in ("angle", "jitter_x", "jitter_y", "h", "s", "a", "b"):
            v = getattr(applied, key)
            if v is not None:
                out[f"{key}_{view}"] = np.float32(v)
        return out

    def _supervised(self, sample: dict, rng) -> dict:
        """Supervised 2.5D sample (reference: data_set.py:360-411): convert
        to 2.5D, augment image+joints, update K by the accumulated transform,
        recreate 3D for a consistency reference. The geometry runs in
        float32 torch on the CPU (``core.geometry``)."""
        def f32(a):
            return torch.from_numpy(np.asarray(a, np.float32))

        K = np.asarray(sample["K"], np.float32)
        j25, scale = geometry.convert_to_2_5d(f32(K), f32(sample["joints3D"]))
        img, j25_aug, T, _ = self.augmenter.transform(sample["image"], j25.numpy(), rng)
        K_new = T.astype(np.float32) @ K
        joints3d = np.asarray(sample["joints3D"], np.float32)
        joints_raw = np.asarray(sample["joints_raw"], np.float32)
        if self.use_palm:
            # reference order (data_set.py:384-396): palm-ify the 3D
            # joints AFTER the augment, recompute 2.5D through the
            # updated K (replacing the augmented 2.5D — K_new carries the
            # transform), and palm-ify joints_raw too
            def palm(j):
                j = j.copy()
                j[0] = (j[0] + j[2]) / 2.0      # ait wrist=0, index_mcp=2
                return j

            joints3d = palm(joints3d)
            joints_raw = palm(joints_raw)
            j25_t, scale = geometry.convert_to_2_5d(f32(K_new), f32(joints3d))
            j25_aug = j25_t.numpy()
        j3d_recreated = geometry.convert_2_5d_to_3d(f32(j25_aug), scale, f32(K_new)).numpy()
        return {
            "image": normalize_image(img),
            "joints": np.asarray(j25_aug).astype(np.float32),
            "joints3D": joints3d,
            "K": K_new,
            "scale": np.float32(scale),
            "joints3D_recreated": j3d_recreated.astype(np.float32),
            "joints_valid": np.asarray(sample["joints_valid"], np.float32),
            "joints_raw": joints_raw,
            "T": T.astype(np.float32),
        }

    def raw_batch(self, indices, stage=None) -> dict | None:
        """A raw pair batch straight off a packed cache source (the native
        gather; no per-sample Python), or None when the source has no
        ``gather_crops``. ``stage``, given the batch's layout ({key: (shape,
        dtype)}), gives the arrays to write it into, or None
        (``data.staging.StagingPool.take``); without them the arrays are
        new."""
        src = self.source
        if not hasattr(src, "gather_crops"):
            return None
        idx = np.asarray(indices, np.int64)
        if self.experiment_type in SIMILAR_PAIR_TYPES:
            pos = src.positive_idx[idx]
        else:
            pos = idx
        n, c = len(idx), src.crop_size
        crops = ((n, c, c, 3), np.uint8)
        joints = ((n, *src.joints3d.shape[1:]), np.float32)
        raw = ((n, *src.joints_raw.shape[1:]), src.joints_raw.dtype)
        layout = {"image1": crops, "image2": crops, "joints1": joints, "joints2": joints,
                  "joints_raw1": raw, "joints_raw2": raw}
        out = (stage(layout) if stage else None) or {}

        def to_25d(key, rows):
            # the cache sources are Hand100M crops: identity K, as raw_pair
            j = convert_to_2_5d_np(np.eye(3), src.joints3d[rows])
            if key not in out:
                return j
            np.copyto(out[key], j)
            return out[key]

        return {
            "image1": src.gather_crops(idx, out.get("image1")),
            "image2": src.gather_crops(pos, out.get("image2")),
            "joints1": to_25d("joints1", idx),
            "joints2": to_25d("joints2", pos),
            "joints_raw1": np.take(src.joints_raw, idx, axis=0, out=out.get("joints_raw1")),
            "joints_raw2": np.take(src.joints_raw, pos, axis=0, out=out.get("joints_raw2")),
        }

    def raw_pair(self, idx: int) -> dict:
        """Both views' uint8 crops, pixel joints and normalised joints of
        one sample (the anchor and its positive, or the anchor twice)."""
        anchor = self.source[idx]
        if self.experiment_type in SIMILAR_PAIR_TYPES:
            positive = self.source[int(anchor["positive_sample_idx"])]
        else:
            positive = anchor
        return {
            "image1": anchor["image"],
            "image2": positive["image"],
            "joints1": convert_to_2_5d_np(anchor["K"], anchor["joints3D"]),
            "joints2": convert_to_2_5d_np(positive["K"], positive["joints3D"]),
            "joints_raw1": anchor["joints_raw"].astype(np.float32),
            "joints_raw2": positive["joints_raw"].astype(np.float32),
        }

    def __getitem__(self, idx: int, epoch: int = 0) -> dict:
        rng = self._rng(idx, epoch)
        etype = self.experiment_type
        anchor = self.source[idx]

        if etype == "supervised":
            return self._supervised(anchor, rng)

        if etype in SIMILAR_PAIR_TYPES:
            positive = self.source[int(anchor["positive_sample_idx"])]
        else:
            positive = anchor

        override_jitter = None if self.flags.crop else [0, 0]

        img1, j1_aug, p1 = self._prep_view(anchor, rng, override_jitter)
        img2, j2_aug, p2 = self._prep_view(positive, rng, override_jitter)

        out = {"transformed_image1": img1, "transformed_image2": img2}
        if etype in WEIGHTED_TYPES:
            out["joints1_ori"] = self._ori_joints(anchor)
            out["joints2_ori"] = self._ori_joints(positive)
            out["joints1_aug"] = j1_aug.astype(np.float32)
            out["joints2_aug"] = j2_aug.astype(np.float32)
        if etype == "simhand_vis":
            # companion views with the reference's default augmenter: every
            # flag off but resize, never rotated, cropped (with the
            # zero-jitter override) only when the main crop flag is off.
            # Its joints{1,2}_ori are these transforms' joints, not the
            # raw-scaled joints of the other _w preps.
            geo = HostAugmenter(
                AugmentFlags(crop=False, resize=self.flags.resize,
                             rotate=False),
                self.params,
            )
            v1, jo1, _, _ = geo.transform(
                anchor["image"],
                convert_to_2_5d_np(anchor["K"], anchor["joints3D"]), rng,
                override_jitter=override_jitter,
            )
            v2, jo2, _, _ = geo.transform(
                positive["image"],
                convert_to_2_5d_np(positive["K"], positive["joints3D"]),
                rng,
                override_jitter=override_jitter,
            )
            out["image1"] = normalize_image(v1)
            out["image2"] = normalize_image(v2)
            out["joints1_ori"] = jo1.astype(np.float32)
            out["joints2_ori"] = jo2.astype(np.float32)
        if etype in PARAM_TYPES:
            out.update(self._param_dict(p1, 1))
            out.update(self._param_dict(p2, 2))
        return out


def _collate(samples: Sequence[dict]) -> dict:
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples]) for k in keys}


def batch_iterator(
    dataset: PretrainDataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    epoch: int = 0,
    num_threads: int = 8,
    drop_last: bool = True,
    raw: bool = False,
    sample_weights: np.ndarray | None = None,
) -> Iterator[dict]:
    """Prefetching threaded batch loader, in the JAX package's order for the
    same seed and epoch: raw pair batches (``raw=True``) or host-augmented
    ones. cv2 releases the GIL in its hot loops, so threads overlap the
    host route's work. With ``sample_weights``, indices are drawn with
    replacement (the reference's weighted sampler over a concat).

    Where a card can page-lock memory, the raw batches are gathered into the
    process's staging pool (``data.staging``), and each batch holds its
    block until the batch is freed."""
    n = len(dataset)
    rng_order = np.random.default_rng([seed, epoch])
    if sample_weights is not None:
        order = rng_order.choice(n, size=n, replace=True, p=sample_weights)
    else:
        order = np.arange(n)
        if shuffle:
            rng_order.shuffle(order)
    nb = n // batch_size if drop_last else -(-n // batch_size)

    if raw:
        # raw batches are assembled by the OpenMP gather across all cores;
        # more than two iterator threads on top oversubscribe the host
        # (data/staging.py's LIMIT counts on two at most)
        num_threads = min(num_threads, 2)
    pool = staging.shared_pool() if raw else None
    take = None if pool is None else pool.take
    n_workers = min(num_threads, nb) or 1
    # backpressure: work is issued in a bounded window ahead of the
    # consumer, so at most ~window batches are ever held
    window = 2 * n_workers
    work: "queue.Queue[int | None]" = queue.Queue()
    done: dict[int, dict] = {}
    errors: list[BaseException] = []
    done_lock = threading.Condition()
    stop = threading.Event()

    def worker():
        while not stop.is_set():
            b = work.get()
            if b is None or stop.is_set():
                return
            try:
                idxs = order[b * batch_size : (b + 1) * batch_size]
                if raw:
                    batch = dataset.raw_batch(idxs, take)
                    if batch is None:
                        batch = _collate([dataset.raw_pair(int(i)) for i in idxs])
                else:
                    batch = _collate([dataset.__getitem__(int(i), epoch) for i in idxs])
            except BaseException as e:  # handed to the consumer, which raises it
                with done_lock:
                    errors.append(e)
                    done_lock.notify_all()
                return
            with done_lock:
                done[b] = batch
                done_lock.notify_all()

    # the consuming thread's work with the queue (starting the workers,
    # waiting for each batch and handing out the next index, stopping them)
    # is the span simhand.feed.queue
    threads = [
        threading.Thread(target=worker, daemon=True) for _ in range(n_workers)
    ]
    issued = min(nb, window)
    with trace.span("simhand.feed.queue"):
        for t in threads:
            t.start()
        for b in range(issued):
            work.put(b)

    try:
        for b in range(nb):
            with trace.span("simhand.feed.queue"):
                with done_lock:
                    while b not in done:
                        if errors:
                            raise errors[0]
                        done_lock.wait()
                    batch = done.pop(b)
                if issued < nb:
                    work.put(issued)
                    issued += 1
            yield batch
        with done_lock:
            if errors:
                raise errors[0]
    finally:
        # an abandoned generator must not leave workers running in native
        # code when the interpreter exits: drain, send exit sentinels, join
        with trace.span("simhand.feed.queue"):
            stop.set()
            try:
                while True:
                    work.get_nowait()
            except queue.Empty:
                pass
            for _ in threads:
                work.put(None)
            for t in threads:
                t.join(timeout=10)
            with done_lock:
                done.clear()             # batches never handed out give back their blocks
