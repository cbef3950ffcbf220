"""detnet fine-tune trainer (counterpart of ``simhand_tpu/finetune/train.py``):

  python -m simhand_tpu_torch.finetune.train \\
      --dataset freihand --data_dir /data/freihand \\
      --backbone 50 --pretrain /path/resnet50_simhand.pth \\
      --epochs 120 --batch_size 128

Every flag of the JAX trainer, with its type, default and choices, plus
``--device`` (``cuda``, the default, or ``cpu``; without a card and without
``--device cpu`` it raises).

On several GPUs it runs one process a GPU, data-parallel, as the JAX
trainer runs on a mesh: launched the torchrun way (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), it joins
the process group, takes rank 0's initial state, and each rank builds
(decodes and augments) only its rows of every global batch
(``--batch_size`` is the global batch). The
step's BatchNorm is per-replica; the gradients, the loss parts and the
running statistics are averaged over the ranks, and ``det_loss`` takes its
3D terms over the global batch. Rank 0 alone evaluates and writes the
checkpoints, the curves and ``detnet.pth``; the other ranks wait for it
at a barrier with a deadline (``WRITE_DEADLINE_S``).

The loop reads ``det_total`` and the curves' parts off the device after
every step (``float(parts[...])``), as the JAX loop does: one sync a step.
The sample builder's image stage runs on the training device
(``finetune/datasets.py``); nothing here imports ``cv2``.
"""
from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from simhand_tpu_torch.convert import load_torch_encoder
from simhand_tpu_torch.device import resolve_device
from simhand_tpu_torch.finetune.datasets import DetnetSampleBuilder, detnet_batch_iterator
from simhand_tpu_torch.finetune.detloss import det_loss
from simhand_tpu_torch.finetune.detnet import DetNet
from simhand_tpu_torch.finetune.evaluation import AverageMeter, EvalUtil, heatmap_metrics
from simhand_tpu_torch.finetune.registry import build_composed_dataset
from simhand_tpu_torch.parallel.mesh import create_mesh, init_distributed, replicate
from simhand_tpu_torch.train.checkpoint import CheckpointManager, export_state_dict
from simhand_tpu_torch.train.loop import pmean_tensors, running_stats
from simhand_tpu_torch.train.optimizer import Adam, exponential_decay
from simhand_tpu_torch.train.state import TrainState, init_weights

logger = logging.getLogger("simhand_tpu_torch.finetune")

TRAIN_KEYS = ("img", "hm", "dm", "lm", "hm_veil", "flag_3d")
#: how long the other ranks wait for rank 0's evaluation and writes
WRITE_DEADLINE_S = 1800.0


def to_device(batch: dict, device, keys=TRAIN_KEYS) -> dict:
    """The step's keys of a builder batch as tensors on ``device``."""
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v)))
            .to(device, non_blocking=True) for k, v in batch.items() if k in keys}


def make_detnet_train_step(model, axis=None):
    """(state, batch) -> (state, parts): one Adam step of ``model`` on a
    batch of tensors on the model's device (``state``: a ``TrainState``
    whose optimizer is an ``Adam``); the BatchNorm statistics come from the
    train-mode forward. The parts stay tensors on the device.

    With an ``axis`` the batch is this rank's rows: BatchNorm stays
    per-replica in the forward, ``det_loss`` takes the axis, and the
    gradients, the parts and then the running statistics are pmean'd (one
    collective each), as JAX's mesh step does."""

    def step(state, batch):
        if state.model is not model:
            raise ValueError("the state holds another model than this step's")
        model.train()
        preds = model(batch["img"])
        total, parts = det_loss(preds, batch["hm"], batch["dm"], batch["lm"],
                                batch["hm_veil"], batch["flag_3d"], axis=axis)
        grads = list(torch.autograd.grad(total, state.optimizer.params))
        parts = {k: v.detach() for k, v in parts.items()}
        if axis is not None:
            grads = pmean_tensors(axis, grads)
            parts = dict(zip(parts, pmean_tensors(axis, list(parts.values()))))
            stats = running_stats(model)
            with torch.no_grad():
                for s, m in zip(stats, pmean_tensors(axis, stats)):
                    s.copy_(m)
        state.optimizer.step(grads)
        state.step += 1
        return state, parts

    return step


def evaluate_detnet_forward(forward, dataset, builder, batch_size=64, device=None):
    """Root-relative scale-normalized 3D EPE/AUC + heatmap-space PCK
    (the reference's train-time accuracy meter,
    minimal-hand/utils/eval/evalutils.py:54-76) over a dataset, for any
    ``forward(images) -> preds`` callable on ``device``."""
    evaluator = EvalUtil()
    meters = {k: AverageMeter() for k in ("hm_pck", "hm_pck_loose", "hm_dist")}
    for batch in detnet_batch_iterator(dataset, builder, batch_size, shuffle=False,
                                       drop_remainder=False, device=device):
        preds = forward(batch["img"])
        hm = heatmap_metrics(preds["h_map"].float().cpu().numpy(), batch["hm"],
                             batch["hm_veil"])
        n = batch["hm"].shape[0]
        for k, meter in meters.items():
            if np.isfinite(hm[k]):
                meter.update(hm[k], n=n)
        if "joint" not in batch:
            continue
        xyz = preds["xyz"].cpu().numpy()  # root-relative, bone-normalized
        gt = batch["joint"]
        root = batch["joint_root"][:, None]
        bone = batch["joint_bone"].reshape(-1, 1, 1)
        gt_norm = (gt - root) / bone
        evaluator.feed(gt_norm.reshape(-1, 21, 3), xyz.reshape(-1, 21, 3))
    out = {k: meter.avg for k, meter in meters.items()}
    if evaluator._dists:
        epe_mean, _, epe_median, auc, _, _ = evaluator.get_measures(0.0, 0.05, 20)
        out.update({"epe_mean": epe_mean, "epe_median": epe_median, "auc": auc})
    return out


def evaluate_detnet(model, dataset, builder, batch_size=64, device=None):
    """``evaluate_detnet_forward`` over the model's eval-mode forward."""
    model.eval()
    with torch.no_grad():
        return evaluate_detnet_forward(model, dataset, builder, batch_size, device)


def init_detnet(model: DetNet, seed: int = 0) -> None:
    """flax's initialisers for a fresh detnet, from ``seed``."""
    init_weights(model, torch.Generator().manual_seed(seed))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="synthetic",
                   help="comma-separated registry keys (finetune/registry.py:"
                        " freihand,dexycb,ah-ego,ah-exo,stb,rhd,cmu,hand143,"
                        "ganerated,do,eo,ego4d,synthetic). Multiple keys "
                        "compose like the reference HandDataset hub "
                        "(subset_name=[...], handataset.py:36-242)")
    p.add_argument("--data_dir", default=None,
                   help="one root for all sets, or comma-list matching --dataset")
    p.add_argument("--sample_weights", default=None,
                   help="comma floats matching --dataset: per-set sampling "
                        "weights (deterministic weighted mix instead of "
                        "concatenation)")
    p.add_argument("--epoch_size", type=int, default=None,
                   help="virtual epoch size for the weighted mix")
    p.add_argument("--setup", default="s1", choices=["s1", "s2"],
                   help="DexYCB split setup (unseen subjects/cameras)")
    p.add_argument("--val_dataset", default=None,
                   help="registry key for eval (default: first --dataset)")
    p.add_argument("--val_data_dir", default=None)
    p.add_argument("--val_split", default="val",
                   help="split for the eval dataset (val/test)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --out_dir")
    p.add_argument("--backbone", default="50", choices=["18", "50", "152"])  # 18: smoke/tests
    p.add_argument("--pretrain", default=None,
                   help="torch .pth encoder init (SiMHand or torchvision)")
    p.add_argument("--epochs", type=int, default=120)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr_strategy", default="ULR", choices=["ULR", "DLR"],
                   help="reference utils/optimizer.py: ULR = uniform lr; "
                        "DLR = differential rates (--lr for the "
                        "pretrained encoder, --lr_head for the fresh "
                        "deconv/map heads)")
    p.add_argument("--lr_head", type=float, default=1e-3,
                   help="head lr under --lr_strategy DLR (lr[1] in the "
                        "reference's param groups)")
    p.add_argument("--lr_decay_step", type=int, default=50)
    p.add_argument("--lr_decay_gamma", type=float, default=0.1)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--eval_every", type=int, default=10)
    p.add_argument("--out_dir", default="/tmp/detnet")
    p.add_argument("--bn_variant", default="exact",
                   choices=["exact", "stop_grad", "fused", "fused_pallas"],
                   help="backbone BatchNorm implementation (models/{norm,fused_bn}.py; "
                        "fused_pallas: kernel #9 in the backward)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the card (default) or, when asked, the CPU")
    return p.parse_args(argv)


def main(argv=None, device=None):
    """Parses ``argv`` and fine-tunes; returns the train state. ``device``
    overrides ``--device``. With ``WORLD_SIZE > 1`` in the environment,
    this process is one rank of a data-parallel run."""
    args = parse_args(argv)
    dev = resolve_device(device or args.device)
    if int(os.environ.get("WORLD_SIZE", 1)) <= 1:
        return _run(args, dev, None)
    import torch.distributed as dist

    dev = init_distributed(dev)
    try:
        return _run(args, dev, create_mesh())
    finally:
        dist.destroy_process_group()


def _run(args, dev, axis):
    """The run of ``main`` on ``dev``, one rank of ``axis`` (or alone)."""
    is_main = axis is None or axis.index == 0
    logging.basicConfig(level=logging.INFO if is_main else logging.WARNING)

    def wait_for_rank0():
        if axis is not None:
            axis.barrier(WRITE_DEADLINE_S)

    weights = ([float(w) for w in args.sample_weights.split(",")]
               if args.sample_weights else None)
    train_ds = build_composed_dataset(
        args.dataset, args.data_dir, "train", setup=args.setup,
        weights=weights, epoch_size=args.epoch_size,
        synthetic_n=max(args.batch_size * 2, 64),
    )
    # val root resolution: explicit --val_data_dir wins; otherwise reuse
    # the train root matching the chosen val dataset (by position in the
    # --dataset list), not the whole comma-list
    train_names = [n.strip() for n in args.dataset.split(",") if n.strip()]
    train_roots = ([r.strip() or None for r in args.data_dir.split(",")]
                   if args.data_dir else [None])
    if len(train_roots) == 1:
        train_roots = train_roots * len(train_names)
    val_name = args.val_dataset or train_names[0]
    if args.val_data_dir:
        val_root = args.val_data_dir
    elif val_name in train_names:
        val_root = train_roots[train_names.index(val_name)]
    else:
        val_root = None
    val_ds = build_composed_dataset(val_name, val_root, args.val_split, setup=args.setup,
                                    synthetic_n=64)

    model = DetNet(
        resnet_size=args.backbone, dtype=torch.bfloat16,
        bn_stop_gradient_stats=args.bn_variant == "stop_grad",
        bn_fused="pallas" if args.bn_variant == "fused_pallas" else args.bn_variant == "fused",
    )
    init_detnet(model, 0)
    if args.pretrain:
        load_torch_encoder(model.encoder.resnet, args.pretrain)
        logger.info("initialized encoder from %s", args.pretrain)
    model.to(dev)

    steps_per_epoch = max(len(train_ds) // args.batch_size, 1)

    def make_schedule(base_lr):
        return exponential_decay(base_lr, args.lr_decay_step * steps_per_epoch,
                                 args.lr_decay_gamma, staircase=True)

    if args.lr_strategy == "DLR":
        # differential rates per the reference's DLR param groups
        # (utils/optimizer.py:33-48): pretrained encoder at --lr, fresh
        # heads at --lr_head
        head = [p for name, p in model.named_parameters() if not name.startswith("encoder.")]
        groups = [(list(model.encoder.parameters()), make_schedule(args.lr)),
                  (head, make_schedule(args.lr_head))]
    else:
        groups = [(list(model.parameters()), make_schedule(args.lr))]
    state = TrainState(model, Adam(groups))

    ckpt_dir = os.path.join(args.out_dir, "checkpoints")
    if is_main:
        os.makedirs(ckpt_dir, exist_ok=True)
    wait_for_rank0()
    manager = CheckpointManager(ckpt_dir, metric="det_total")
    global_step = 0
    if args.resume and manager.latest_step() is not None:
        state = manager.restore(state)
        global_step = manager.latest_step()
        logger.info("resumed from step %d", global_step)

    if axis is not None:
        state = replicate(axis, state)
    step_fn = make_detnet_train_step(model, axis)
    # each rank builds only its rows of every global batch
    shard = None if axis is None else (axis.index, axis.size)
    builder = DetnetSampleBuilder(train=True)
    val_builder = DetnetSampleBuilder(train=False)

    # npy training curves, the artifact contract of the reference's
    # plot.py (minimal-hand/plot.py:11-16): per-epoch [epoch, value] rows
    # for the heatmap/delta/location losses plus per-dataset AUC and
    # heatmap-accuracy dicts, and [epoch, pck_loose, dist] rows
    curve_files = {"det_hm": "lossH", "det_dm": "lossD", "det_lm": "lossL"}
    loss_rows = {name: [] for name in curve_files.values()}
    auc_all: dict[str, list] = {}
    acc_hm_all: dict[str, list] = {}
    hm_extras_all: dict[str, list] = {}
    if args.resume and global_step:
        # keep the pre-resume history instead of overwriting the npy
        # artifacts with only post-resume rows
        for name in loss_rows:
            f = os.path.join(args.out_dir, f"{name}.npy")
            if os.path.exists(f):
                loss_rows[name] = np.load(f).reshape(-1, 2).tolist()
        for store, fname in ((auc_all, "auc_all"), (acc_hm_all, "acc_hm_all"),
                             (hm_extras_all, "hm_extras_all")):
            f = os.path.join(args.out_dir, f"{fname}.npy")
            if os.path.exists(f):
                store.update(np.load(f, allow_pickle=True).item())

    def dump_curves():
        for name, rows in loss_rows.items():
            np.save(os.path.join(args.out_dir, f"{name}.npy"), np.asarray(rows, np.float64))
        np.save(os.path.join(args.out_dir, "auc_all.npy"), np.asarray(auc_all, dtype=object))
        np.save(os.path.join(args.out_dir, "acc_hm_all.npy"),
                np.asarray(acc_hm_all, dtype=object))
        np.save(os.path.join(args.out_dir, "hm_extras_all.npy"),
                np.asarray(hm_extras_all, dtype=object))

    start_epoch = global_step // max(steps_per_epoch, 1)
    for epoch in range(start_epoch, args.epochs):
        t0 = time.time()
        losses = []
        part_sums: dict[str, float] = {}
        for batch in detnet_batch_iterator(train_ds, builder, args.batch_size, epoch=epoch,
                                           device=dev, shard=shard):
            state, parts = step_fn(state, to_device(batch, dev))
            losses.append(float(parts["det_total"]))
            for key in curve_files:
                part_sums[key] = part_sums.get(key, 0.0) + float(parts[key])
            global_step += 1
            if args.max_steps and global_step >= args.max_steps:
                break
        if not losses:
            raise RuntimeError(
                f"epoch {epoch} yielded zero batches: len(train_ds)="
                f"{len(train_ds)} < batch_size={args.batch_size} — shrink "
                "--batch_size or grow the dataset/--epoch_size"
            )
        for key, name in curve_files.items():
            loss_rows[name].append([epoch + 1, part_sums.get(key, 0.0) / max(len(losses), 1)])
        logger.info("epoch %d: det_total %.4f (%.1fs)", epoch, float(np.mean(losses)),
                    time.time() - t0)
        if is_main and ((epoch + 1) % args.eval_every == 0 or epoch == args.epochs - 1):
            metrics = evaluate_detnet(model, val_ds, val_builder, args.batch_size, dev)
            logger.info("eval @ epoch %d: %s", epoch, metrics)
            if "auc" in metrics:
                auc_all.setdefault(val_name, []).append([epoch + 1, metrics["auc"]])
            acc_hm_all.setdefault(val_name, []).append([epoch + 1, metrics["hm_pck"]])
            hm_extras_all.setdefault(val_name, []).append(
                [epoch + 1, metrics["hm_pck_loose"], metrics["hm_dist"]])
            manager.save(global_step, state, {"det_total": float(np.mean(losses))})
        if is_main:
            dump_curves()
        wait_for_rank0()
        if args.max_steps and global_step >= args.max_steps:
            break

    if is_main:
        if manager.latest_step() != global_step:
            manager.save(global_step, state, {"det_total": float(np.mean(losses))})
        # torch-format export of the fine-tuned detnet, the JAX package's
        # detnet.pth (minimal-hand keys)
        path = os.path.join(args.out_dir, "detnet.pth")
        export_state_dict(model, path)
        logger.info("saved %s", path)
    wait_for_rank0()
    manager.wait()
    manager.close()
    return state


if __name__ == "__main__":
    main()
