"""Does pre-training transfer? The port's copy of the JAX package's
``scripts/transfer_check.py``: the miniature of the reference's headline
claim (reference README.md:22: SiMHand pre-training improves FreiHAND,
DexYCB and AH fine-tuning by 15/10/4%), and the grand loop that ties the
three stages together.

``run_transfer_check`` fine-tunes a detnet on the ``synthetic-hand`` dataset
(colour blobs at the keypoints over noise) twice with the same budget: arm
(a) from a random init, arm (b) from an encoder that ``experiments.main``
first pre-trained on the synthetic Hand100M corpus and exported
(``--export_torch``), loaded with ``--pretrain`` under ``--lr_strategy
DLR``. It returns, and prints as one JSON line, each arm's final-epoch
heatmap loss and held-out heatmap metrics.

``run_grand_loop`` runs the reference workflow end to end: the corpus's
annotation written without frames, the mining CLI on it, a crop cache built
with the mined positives, pre-training on that cache with the export, the
fine-tune from the export, and ``finetune.evaluate`` on its checkpoint.

One departure from the JAX script: the card's machine has no ``cv2``, so
the pre-training corpus is not the JPEG dataset of
``generate_synthetic_hand100m``. It is the packed crop cache of
``SyntheticHandSource`` (the same generator: ``num_images``, ``num_videos``
and ``seed`` as that call draws them, rendered straight at the 224x224 crop
side), fed through ``--cache_dir --device_augment``. Its pixels therefore
differ from the JAX script's, and so do the losses it reaches.

Both functions run on the card unless given ``device="cpu"``; without a
card they raise. The mains' logs and TensorBoard files go where
``BASE_PATH`` says; the command line sets it to ``<workdir>/runs`` unless
it is set. Usage:

    python -m simhand_tpu_torch.transfer_check \\
        --pretrain_steps 60 --finetune_steps 60 [--bn_variant stop_grad] \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

# the pre-training corpus: scripts/transfer_check.py's generate_synthetic_hand100m
# call, at the crop side of the cache
CORPUS_IMAGES, CORPUS_VIDEOS, CROP = 256, 16, 224


def _fresh(workdir: str) -> str:
    os.makedirs(workdir, exist_ok=True)
    if os.listdir(workdir):
        raise FileExistsError(f"{workdir} is not empty: give a new or empty directory")
    return workdir


def build_corpus(cache_dir: str, num_images: int = CORPUS_IMAGES, seed: int = 0,
                 positives=None) -> str:
    """The packed crop cache of the synthetic corpus of ``seed`` (no cv2;
    CORPUS_VIDEOS videos), its positives the generator's or the
    ``(positive_idx, distance)`` given."""
    from simhand_tpu_torch.data.cache import build_crop_cache
    from simhand_tpu_torch.data.sources import SyntheticHandSource

    source = SyntheticHandSource(num_images, num_videos=CORPUS_VIDEOS, side=CROP, seed=seed,
                                 positives=positives)
    return build_crop_cache(source, cache_dir)


def pretrain_argv(workdir: str, cache_dir: str, export: str, steps: int, batch_size: int,
                  experiment_type: str = "simhand_w", bn_variant: str = "exact",
                  resnet_size: str = "18") -> list[str]:
    """The JAX script's pre-training flags on ``cache_dir``. The checkpoints
    go under ``workdir`` (``--resume_path`` names their directory; it is new,
    so nothing is restored)."""
    return [
        "--experiment_type", experiment_type, "--crop", "--resize", "--rotate",
        "-sources", "synthetic", "-batch_size", str(batch_size), "-resnet_size", resnet_size,
        "--data_dir", os.path.join(workdir, "data"), "--cache_dir", cache_dir,
        "-experiment_name", "transfer_check",
        "-epochs", str(-(-steps * batch_size // 128)), "--max_steps", str(steps),
        "--export_torch", export, "--bn_variant", bn_variant,
        "--resume_path", os.path.join(workdir, "pretrain_checkpoints"),
    ]


def finetune_argv(out_dir: str, steps: int, batch_size: int, lr: float = 3e-4,
                  resnet_size: str = "18", pretrain: str | None = None) -> list[str]:
    """The JAX script's fine-tune flags: epochs sized so that the last one
    ends on the step budget (the trainer evaluates and saves there, and only
    there); with ``pretrain``, the encoder from that export under DLR."""
    n_train = max(batch_size * 2, 64)          # the trainer's synthetic set
    epochs = -(-steps // max(n_train // batch_size, 1))
    argv = ["--dataset", "synthetic-hand", "--backbone", resnet_size, "--epochs", str(epochs),
            "--batch_size", str(batch_size), "--max_steps", str(steps),
            "--eval_every", str(epochs), "--lr", str(lr), "--out_dir", out_dir]
    if pretrain:
        argv += ["--pretrain", pretrain, "--lr_strategy", "DLR", "--lr_head", str(lr)]
    return argv


def read_metrics(out_dir: str) -> dict:
    """A fine-tune run's final-epoch heatmap loss (``lossH``) and the last
    evaluation's hm_pck, auc, hm_pck_loose and hm_dist, from its npy
    curves."""
    lossH = np.load(os.path.join(out_dir, "lossH.npy"))
    acc = np.load(os.path.join(out_dir, "acc_hm_all.npy"), allow_pickle=True).item()
    auc = np.load(os.path.join(out_dir, "auc_all.npy"), allow_pickle=True).item()
    extras = np.load(os.path.join(out_dir, "hm_extras_all.npy"), allow_pickle=True).item()
    key = next(iter(acc))
    out = {"lossH_final": float(lossH[-1, 1]), "hm_pck": float(acc[key][-1][1]),
           "auc": float(auc[key][-1][1]) if auc else float("nan")}
    if extras:
        row = extras[next(iter(extras))][-1]
        out["hm_pck_loose"], out["hm_dist"] = float(row[1]), float(row[2])
    return out


def run_transfer_check(workdir: str, pretrain_steps: int = 60, finetune_steps: int = 60,
                       batch_size: int = 16, bn_variant: str = "exact", lr: float = 3e-4,
                       corpus_seed: int = 0, experiment_type: str = "simhand_w",
                       skip_random: bool = False, resnet_size: str = "18",
                       device=None) -> dict:
    """Runs both arms in ``workdir`` (new or empty) on ``device`` (the card
    unless "cpu"); returns {"random": metrics or None, "pretrained":
    metrics}, each as ``read_metrics`` gives it."""
    from simhand_tpu_torch.device import resolve_device
    from simhand_tpu_torch.experiments import main as pretrain
    from simhand_tpu_torch.finetune import train as finetune

    dev = str(resolve_device(device))
    _fresh(workdir)

    def arm(name: str, export: str | None) -> dict:
        out_dir = os.path.join(workdir, name)
        finetune.main(finetune_argv(out_dir, finetune_steps, batch_size, lr, resnet_size,
                                    export), device=dev)
        return read_metrics(out_dir)

    random_metrics = None if skip_random else arm("ft_random", None)
    cache_dir = build_corpus(os.path.join(workdir, "cache"), seed=corpus_seed)
    export = os.path.join(workdir, "encoder_pretrained.pth")
    pretrain.main(pretrain_argv(workdir, cache_dir, export, pretrain_steps, batch_size,
                                experiment_type, bn_variant, resnet_size)
                  + ["--device_augment"], device=dev)
    return {"random": random_metrics, "pretrained": arm("ft_pretrained", export)}


def run_grand_loop(workdir: str, images: int = 256, batch_size: int = 8,
                   resnet_size: str = "18", pretrain_steps: int = 2, finetune_steps: int = 2,
                   extra_pretrain_args=(), device=None, finetune_batch_size: int | None = None,
                   extra_finetune_args=(), seed: int = 0) -> dict:
    """Mine -> pre-train -> export -> fine-tune from the export -> evaluate,
    in ``workdir`` (new or empty) on ``device`` (the card unless "cpu"),
    with no cv2. Returns each stage's record and seconds:

    * ``corpus``: the annotation written without frames (``images`` hands of
      CORPUS_VIDEOS videos from ``seed``), its positives stripped;
    * ``mining``: ``mining.run.main --k 1`` on it; ``positives`` (the mined
      top-1 of every hand) and ``oracle`` (``top1_cross_video``'s);
    * ``cache``: the crop cache built with the mined positives;
    * ``pretrain``: ``experiments.main`` on that cache (``--device_augment``,
      then ``extra_pretrain_args``), its step and ``--export_torch`` file;
    * ``finetune``: ``finetune.train.main --pretrain <export> --lr_strategy
      DLR`` on ``synthetic-hand`` (B = ``finetune_batch_size``, else
      ``batch_size``; then ``extra_finetune_args``), its step, out_dir and
      ``read_metrics``;
    * ``evaluate``: ``finetune.evaluate.main`` on its checkpoint.
    """
    from simhand_tpu_torch.data.sources import write_synthetic_annotation
    from simhand_tpu_torch.device import resolve_device
    from simhand_tpu_torch.experiments import main as pretrain
    from simhand_tpu_torch.finetune import evaluate, train as finetune
    from simhand_tpu_torch.mining import run as mining

    dev = str(resolve_device(device))
    _fresh(workdir)
    record = {}

    def stage(name: str, fn):
        t0 = time.perf_counter()
        out = fn()
        record[name] = {**out, "seconds": time.perf_counter() - t0}

    def write_corpus():
        anno, _ = write_synthetic_annotation(os.path.join(workdir, "synthetic"), images,
                                             CORPUS_VIDEOS, side=CROP, seed=seed)
        with open(anno) as f:
            corpus = json.load(f)
        oracle = np.array([a["positive_sample"][0] for a in corpus["annotations"]])
        for a in corpus["annotations"]:
            a["positive_sample"], a["distance"] = [], []
        unpaired = os.path.join(workdir, "unpaired.json")
        with open(unpaired, "w") as f:
            json.dump(corpus, f)
        return {"unpaired": unpaired, "oracle": oracle}

    def mine():
        paired = os.path.join(workdir, "paired.json")
        # a query chunk no larger than the corpus: the queries are padded to it
        mining.main(["--input", record["corpus"]["unpaired"], "--output", paired, "--k", "1",
                     "--query_chunk", str(min(images, 4096))], device=dev)
        with open(paired) as f:
            mined = json.load(f)["annotations"]
        return {"output": paired,
                "positives": np.array([a["positive_sample"][0] for a in mined]),
                "distance": np.array([a["distance"][0] for a in mined], np.float32),
                "oracle": record["corpus"]["oracle"]}

    def cache():
        positives = (record["mining"]["positives"], record["mining"]["distance"])
        return {"cache_dir": build_corpus(os.path.join(workdir, "cache"), images, seed,
                                          positives)}

    export = os.path.join(workdir, "encoder_pretrained.pth")

    def pretrain_stage():
        argv = pretrain_argv(workdir, record["cache"]["cache_dir"], export, pretrain_steps,
                             batch_size, resnet_size=resnet_size)
        state = pretrain.main(argv + ["--device_augment", *extra_pretrain_args], device=dev)
        return {"step": int(state.step), "export": export}

    out_dir = os.path.join(workdir, "finetune")

    def finetune_stage():
        argv = finetune_argv(out_dir, finetune_steps, finetune_batch_size or batch_size,
                             resnet_size=resnet_size, pretrain=export)
        state = finetune.main(argv + list(extra_finetune_args), device=dev)
        return {"step": int(state.step), "out_dir": out_dir, **read_metrics(out_dir)}

    def evaluate_stage():
        return evaluate.main(["--dataset", "synthetic-hand", "--backbone", resnet_size,
                              "--checkpoint", os.path.join(out_dir, "checkpoints"),
                              "--batch_size", str(finetune_batch_size or batch_size)],
                             device=dev)

    for name, fn in (("corpus", write_corpus), ("mining", mine), ("cache", cache),
                     ("pretrain", pretrain_stage), ("finetune", finetune_stage),
                     ("evaluate", evaluate_stage)):
        stage(name, fn)
    return record


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pretrain_steps", type=int, default=60)
    p.add_argument("--finetune_steps", type=int, default=60)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--bn_variant", default="exact")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--corpus_seed", type=int, default=0,
                   help="pretrain-corpus RNG seed (robustness re-runs)")
    p.add_argument("--skip_random", action="store_true",
                   help="skip the random-init arm (comparisons between "
                        "pretraining objectives reuse the published "
                        "random-arm number)")
    p.add_argument("--experiment_type", default="simhand_w",
                   help="pretraining objective for arm (b): compare simclr "
                        "(same-image positives) with simhand_w (mined "
                        "similar-hand positives), the paper's core-claim "
                        "miniature")
    p.add_argument("--resnet_size", default="18")
    p.add_argument("--workdir", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the card (default) or, when asked, the CPU")
    args = p.parse_args(argv)

    import logging

    logging.basicConfig(level=logging.INFO)
    workdir = args.workdir or tempfile.mkdtemp(prefix="transfer_check_")
    os.environ.setdefault("BASE_PATH", os.path.join(workdir, "runs"))
    result = run_transfer_check(
        workdir, args.pretrain_steps, args.finetune_steps, args.batch_size, args.bn_variant,
        args.lr, args.corpus_seed, args.experiment_type, args.skip_random,
        resnet_size=args.resnet_size, device=args.device)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
