"""Raw pre-training batches (counterpart of ``simhand_tpu/data/pipeline.py``,
its raw route: the production input path with augmentation on the card).

``PretrainDataset.raw_batch`` assembles both views' uint8 crops, pixel
joints and normalised joints straight off a packed cache source with the
native gather; ``batch_iterator(..., raw=True)`` yields those batches from
a bounded window of at most two worker threads, and ``data.prefetch``
moves them to the card, where ``data.augment.prepare_views`` augments them
inside the train step.

The host-augment and supervised routes (``__getitem__``, ``_supervised``)
need the JAX package's ``HostAugmenter``, which reads and writes through
``cv2``, and are not ported yet.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence

import numpy as np

from simhand_tpu_torch.core.joints import CHILD_JOINT, PARENT_JOINT
from simhand_tpu_torch.data.augment_cv2 import AugmentFlags, AugmentParams

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
    """Index-addressable raw sample pairs for any experiment type."""

    def __init__(
        self,
        source,
        experiment_type: str,
        flags: AugmentFlags,
        params: AugmentParams,
        seed: int = 0,
    ):
        self.source = source
        self.experiment_type = experiment_type
        self.flags = flags
        self.params = params
        self.seed = seed

    def __len__(self) -> int:
        return len(self.source)

    def raw_batch(self, indices) -> dict | None:
        """A raw pair batch straight off a packed cache source (the native
        gather; no per-sample Python), or None when the source has no
        ``gather_crops``."""
        src = self.source
        if not hasattr(src, "gather_crops"):
            return None
        idx = np.asarray(indices, np.int64)
        if self.experiment_type in SIMILAR_PAIR_TYPES:
            pos = src.positive_idx[idx]
        else:
            pos = idx

        def to_25d(j):
            # the cache sources are Hand100M crops: identity K, as raw_pair
            return convert_to_2_5d_np(np.eye(3), j)

        return {
            "image1": src.gather_crops(idx),
            "image2": src.gather_crops(pos),
            "joints1": to_25d(src.joints3d[idx]),
            "joints2": to_25d(src.joints3d[pos]),
            "joints_raw1": src.joints_raw[idx],
            "joints_raw2": src.joints_raw[pos],
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
    same seed and epoch. With ``sample_weights``, indices are drawn with
    replacement. Only ``raw=True`` is ported: the host-augmented batches
    need ``HostAugmenter``."""
    if not raw:
        raise NotImplementedError(
            "host-augmented batches need HostAugmenter (cv2), which is not ported; "
            "pass raw=True and augment on the card")
    n = len(dataset)
    rng_order = np.random.default_rng([seed, epoch])
    if sample_weights is not None:
        order = rng_order.choice(n, size=n, replace=True, p=sample_weights)
    else:
        order = np.arange(n)
        if shuffle:
            rng_order.shuffle(order)
    nb = n // batch_size if drop_last else -(-n // batch_size)

    # raw batches are assembled by the OpenMP gather across all cores; more
    # than two iterator threads on top oversubscribe the host (the JAX
    # package measured 8,455 samples/s at 2 threads against 648 at 16)
    num_threads = min(num_threads, 2)
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
                batch = dataset.raw_batch(idxs)
                if batch is None:
                    batch = _collate([dataset.raw_pair(int(i)) for i in idxs])
            except BaseException as e:  # handed to the consumer, which raises it
                with done_lock:
                    errors.append(e)
                    done_lock.notify_all()
                return
            with done_lock:
                done[b] = batch
                done_lock.notify_all()

    threads = [
        threading.Thread(target=worker, daemon=True) for _ in range(n_workers)
    ]
    for t in threads:
        t.start()
    issued = min(nb, window)
    for b in range(issued):
        work.put(b)

    try:
        for b in range(nb):
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
