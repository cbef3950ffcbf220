"""Mining job CLI (counterpart of ``simhand_tpu/mining/run.py``): pair every
hand crop with its most similar other-video hands and write a Hand100M v1-1
annotation JSON. It runs on the card unless given ``--device cpu``:

  python -m simhand_tpu_torch.mining.run \
      --input annotations_unpaired.json --output Hand100M_Ego4D_1m_v1-1.json \
      --k 1

Video identity is derived from the frame path (``<video_id>/frame_x.jpg``
or ``<video_id>_frame<idx>.jpg``) unless annotations carry an explicit
``video_id`` field. The output equals the JAX package's byte for byte.

On several GPUs it runs one process a GPU, launched the torchrun way
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``): the queries are split over the ranks (and the database
too with ``--shard_db``), and rank 0 alone writes the output.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def video_ids_from_annotations(images: list[dict], annotations: list[dict]) -> np.ndarray:
    image_by_id = {img["id"]: img for img in images}
    names = {}
    vids = np.zeros(len(annotations), np.int32)
    for i, a in enumerate(annotations):
        if "video_id" in a:
            key = a["video_id"]
        else:
            file_name = image_by_id[a["image_id"]]["file_name"]
            base = os.path.basename(file_name)
            if "_frame" in base:
                # flat layout: <video_id>_frame<idx>.jpg
                key = os.path.join(
                    os.path.dirname(file_name), base.split("_frame")[0]
                )
            else:
                # nested layout: <video_id>/frame_<idx>.jpg
                key = os.path.dirname(file_name) or file_name
        vids[i] = names.setdefault(key, len(names))
    return vids


def main(argv=None, device=None):
    """Mines the pairs of ``--input`` into ``--output``; ``device``
    overrides ``--device``."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--k", type=int, default=1)
    p.add_argument("--query_chunk", type=int, default=4096)
    p.add_argument("--db_chunk", type=int, default=8192)
    p.add_argument("--shard_db", action="store_true", default=False,
                   help="shard the keypoint DB over the ranks too and "
                        "rotate it round the ring (ppermute): for "
                        "corpora whose replicated DB would not fit a card")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from simhand_tpu_torch.device import resolve_device

    dev = resolve_device(device or args.device)
    if int(os.environ.get("WORLD_SIZE", 1)) <= 1:
        return _run(args, dev, None)
    import torch.distributed as dist

    from simhand_tpu_torch.parallel.mesh import create_mesh, init_distributed

    dev = init_distributed(dev)
    try:
        return _run(args, dev, create_mesh())
    finally:
        dist.destroy_process_group()


def _run(args, dev, mesh):
    """The mining of ``main`` on ``dev``, one rank of ``mesh`` (or alone)."""
    from simhand_tpu_torch.mining.similar_hands import attach_positives, mine_similar_hands

    with open(args.input) as f:
        data = json.load(f)
    images, annotations = data["images"], data["annotations"]

    kp = np.stack(
        [
            np.asarray(a["keypoint_25d"], np.float32).reshape(21, 3)[:, :2]
            for a in annotations
        ]
    )
    vids = video_ids_from_annotations(images, annotations)

    d, i = mine_similar_hands(
        kp, vids, k=args.k,
        query_chunk=args.query_chunk, db_chunk=args.db_chunk,
        mesh=mesh, progress=True, shard_db=args.shard_db and mesh is not None, device=dev,
    )
    if mesh is not None and mesh.index != 0:
        return
    annotations = attach_positives(annotations, d, i)

    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    with open(args.output, "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)
    print(f"wrote {args.output} ({len(annotations)} annotations, k={args.k})")


if __name__ == "__main__":
    main()
