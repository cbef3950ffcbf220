"""Pre-training entry point (counterpart of ``simhand_tpu/experiments/main.py``),
with the reference's flags:

  python -m simhand_tpu_torch.experiments.main \\
      --experiment_type simhand_w --weight_type linear --diff_type mpjpe \\
      --pos_neg pos_neg --joints_type original \\
      --crop --resize --rotate --color_jitter \\
      -sources ego4d -sources 100doh --datasets_scale 2m \\
      --cache_dir $CACHE --device_augment --use_pallas \\
      -batch_size 256 -epochs 100 -resnet_size 50

It runs on one card (``--device cuda``, the default) or, when asked, on the
CPU (``--device cpu``). The route users take for speed, ``--cache_dir`` with
``--device_augment``, needs neither ``cv2`` nor any other optional package:
each is imported inside the function that uses it.

On several GPUs it runs one process a GPU, data-parallel, as the JAX
package runs on a mesh of more than one device; launch it as torchrun
does, with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` set (``torchrun --nproc_per_node 8 -m
simhand_tpu_torch.experiments.main ...``). With ``WORLD_SIZE > 1`` it
joins the process group (NCCL on the card, gloo on the CPU), replicates
rank 0's initial state, and each rank reads the same global batch stream
(``-batch_size`` is the global batch) and keeps its rows. The loss is the
global-batch loss, the gradients and BatchNorm statistics are averaged
over the ranks (BatchNorm itself is per-replica, as JAX's main builds
it), validation is sharded the same way, and only rank 0 logs, writes
checkpoints and exports. With ``--fsdp`` the ranks hold 1/W of the
parameters and Adam moments each (``parallel/fsdp.py``) and the step is
JAX's FSDP step: every BatchNorm, the projection head's too, over the
global batch; evaluation and export see the gathered parameters, and
checkpoints are the whole state, as a replicated run writes them. One
process runs exactly as before.

Where it departs from the JAX package:
  * with ``-log_interval epoch`` (the default) the per-step losses stay
    tensors on the device and are read once at the epoch's end, as JAX
    keeps device arrays: nothing in the step loop waits for the card;
  * when ``--cache_dir`` already holds an ``index.json``, the raw sources
    are not built: they would only feed a cache that exists (and the
    synthetic one needs ``cv2`` to write its JPEGs). The samples are the
    same;
  * the sample-pair figure is drawn only when the logger has a sink that
    takes figures;
  * ``--profile_dir`` records ``torch.profiler`` over the run's first
    ``PROFILE_STEPS`` steps (fewer if the run ends first) and writes a
    Chrome trace there, ``trace.json``, in place of ``jax.profiler``; the
    step's phases are its ``simhand.step.*`` spans;
  * ``--fsdp`` on one device does nothing, as JAX's does there (it needs a
    mesh); with ``WORLD_SIZE > 1`` every ``--bn_variant`` runs under it,
    the fused ones with their kernels' sums all-reduced over the ranks;
  * with several ranks, the preemption flag is agreed over the ranks at
    each step (one all-reduce of a host integer over gloo, beside NCCL),
    so every rank saves or stops at the same step and none waits for its
    card there;
  * with several ranks, every rank reads (and, without
    ``--device_augment``, augments on the host) the whole global batch and
    keeps 1/W of it: W times the host feed work of JAX's main, which loads
    each batch once. Selecting this rank's indices before decoding is left
    to a later change;
  * without a card and without ``--device cpu`` (or ``device="cpu"``),
    ``main`` raises: it never moves to the CPU on its own;
  * the SIGTERM handler is put back as it was when ``main`` returns.
"""
from __future__ import annotations

import logging
import os
import re
import signal
import time

import numpy as np
import torch

from simhand_tpu_torch import constants
from simhand_tpu_torch.data.augment import prepare_views, seeded_generator
from simhand_tpu_torch.data.augment_cv2 import AugmentFlags, AugmentParams
from simhand_tpu_torch.data.pipeline import PretrainDataset, batch_iterator
from simhand_tpu_torch.device import resolve_device
from simhand_tpu_torch.experiments import config as cfg_mod
from simhand_tpu_torch.experiments.cli import get_general_args
from simhand_tpu_torch.models import ContrastiveConfig, ContrastiveModel
from simhand_tpu_torch.parallel import (
    create_mesh,
    device_prefetch,
    gathered,
    init_distributed,
    make_fsdp_train_step,
    replicate,
    shard_batch,
)
from simhand_tpu_torch.train import (
    OptimizerConfig,
    create_train_state,
    make_eval_step,
    make_train_step,
)
from simhand_tpu_torch.train.checkpoint import CheckpointManager, export_torch_encoder
from simhand_tpu_torch.train.loop import EVAL_AUGMENT_SEED
from simhand_tpu_torch.utils.logging import (
    MetricLogger,
    register_experiment,
    setup_debug_logging,
)

logger = logging.getLogger("simhand_tpu_torch")

#: steps ``--profile_dir`` records, from the run's first
PROFILE_STEPS = 10

# README-documented aliases the reference's get_model never handled
EXPERIMENT_ALIASES = {"handclr": "simhand", "handclr_w": "simhand_w", "simhand-v0": "simhand"}


def build_sources(args, train_param):
    """The sample sources of the ``-sources`` flags."""
    from simhand_tpu_torch.data.sources import Hand100MSource

    root = args.data_dir or constants.HAND2M_DATA
    scale = args.datasets_scale or "1m"
    sources = args.sources or ["ego4d"]
    # --cache_size: the crops' resolution (the joints are stored normalised
    # and scaled to pixels at load, so any size is the reference loader at
    # that resolution)
    src_kwargs = {}
    if getattr(args, "cache_size", None):
        src_kwargs["crop_size"] = int(args.cache_size)
    out = []
    for s in sources:
        if s in ("ego4d", "100doh"):
            out.append(Hand100MSource(root, source=s, scale=scale, **src_kwargs))
        elif s == "synthetic":
            from simhand_tpu_torch.data.sources import generate_synthetic_hand100m

            synth_root = os.path.join(root, "synthetic")
            anno = os.path.join(
                synth_root, "annotations", "100DOH", "Hand100M_100DOH_smoke_v1-1.json"
            )
            if not os.path.exists(anno):
                generate_synthetic_hand100m(synth_root, num_images=256, num_videos=16)
            out.append(Hand100MSource(synth_root, source="100doh",
                                      scale="smoke", **src_kwargs))
        else:
            raise NotImplementedError(
                f"source {s!r} is a fine-tune-side dataset; use simhand_tpu_torch.finetune"
            )
    if len(out) == 1:
        return out[0]
    from simhand_tpu_torch.data.concat import ConcatSource

    return ConcatSource(out)


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


def _mean(losses: list) -> float:
    """The mean of loss tensors, read from the device in one copy."""
    return float(np.mean(torch.stack(losses).cpu().tolist()))


def main(argv=None, device=None):
    """Parses ``argv`` (``sys.argv[1:]`` when None) and pre-trains; returns
    the train state. ``device`` overrides ``--device``. With
    ``WORLD_SIZE > 1`` in the environment, this process is one rank of a
    data-parallel run."""
    args = get_general_args(argv)
    if getattr(args, "heatmap", False):
        # as the reference, whose get_model raises for every experiment type
        # when heatmap_flag is set
        raise NotImplementedError(
            "--heatmap is not implemented for any experiment type "
            "(matches the reference)"
        )
    dev = resolve_device(device or args.device)
    if int(os.environ.get("WORLD_SIZE", 1)) <= 1:
        return _run(args, dev, None)
    import torch.distributed as dist

    dev = init_distributed(dev)
    try:
        return _run(args, dev, create_mesh())
    finally:
        dist.destroy_process_group()


def _run(args, dev: torch.device, axis):
    """The run of ``main`` on ``dev``, one rank of ``axis`` (or alone)."""
    is_main = axis is None or axis.index == 0
    logging.basicConfig(
        level=(logging.DEBUG if args.debug else logging.INFO) if is_main else logging.WARNING,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )

    train_param = cfg_mod.read_json(cfg_mod.TRAINING_CONFIG_PATH)
    train_param = cfg_mod.update_train_params(args, train_param)

    seed = int(train_param["seed"])
    np.random.seed(seed)

    # ---------------- data ----------------
    cached = bool(args.cache_dir) and os.path.exists(
        os.path.join(args.cache_dir, "index.json"))
    if not cached:
        source = build_sources(args, train_param)
    if args.cache_dir:
        from simhand_tpu_torch.data.cache import CachedHand100MSource, build_crop_cache

        if not cached:
            logger.info("building packed crop cache at %s", args.cache_dir)
            build_crop_cache(source, args.cache_dir, progress=True)
        source = CachedHand100MSource(args.cache_dir)
        if args.cache_size and source.crop_size != int(args.cache_size):
            raise ValueError(
                f"--cache_size {args.cache_size} does not match the existing "
                f"cache at {args.cache_dir} (stores {source.crop_size}² "
                f"crops); rebuild into a fresh --cache_dir"
            )
    num_samples = len(source)
    logger.info("dataset: %d samples", num_samples)

    flags = AugmentFlags(
        **{k: bool(v) for k, v in train_param["augmentation_flags"].items()}
    )
    ap = train_param["augmentation_params"]
    params = AugmentParams(
        crop_margin=ap["crop_margin"],
        crop_margin_range=tuple(ap["crop_margin_range"]),
        cut_out_fraction=tuple(ap["cut_out_fraction"]),
        hue_factor_range=tuple(ap["hue_factor_range"]),
        min_angle=min(ap["min_angle"], ap["max_angle"]),
        max_angle=max(ap["min_angle"], ap["max_angle"]),
        resize_shape=tuple(ap["resize_shape"]),
        sat_factor_range=tuple(ap["sat_factor_range"]),
        value_factor_alpha_range=tuple(ap["value_factor_alpha_range"]),
        value_factor_beta_range=tuple(ap["value_factor_beta_range"]),
        crop_box_jitter=tuple(ap["crop_box_jitter"]),
        sobel_kernel=int(ap["sobel_kernel"]),
        noise_std=float(ap["noise_std"]),
    )
    experiment_type = args.experiment_type or "simclr"
    experiment_type = EXPERIMENT_ALIASES.get(experiment_type, experiment_type)
    dataset = PretrainDataset(source, experiment_type, flags, params, seed=seed,
                              use_palm=getattr(args, "use_palm", False))

    # ---------------- model ----------------
    model_param = cfg_mod.read_json(cfg_mod.model_config_path(experiment_type))
    model_param = cfg_mod.update_model_params(
        model_param, args, num_samples, train_param
    )

    batch_size = int(train_param["batch_size"])
    accum = int(train_param.get("accumulate_grad_batches", 1))
    iters_per_epoch = max(num_samples // batch_size, 1)
    epochs = int(train_param["epochs"])

    bn_variant = getattr(args, "bn_variant", "exact")
    model = ContrastiveModel(
        resnet_size=str(model_param["resnet_size"]),
        proj_hidden_dim=int(model_param["projection_head_hidden_dim"]),
        proj_output_dim=int(model_param["output_dim"]),
        dtype=torch.bfloat16 if str(train_param.get("precision")) in ("16", "bf16")
        else torch.float32,
        bn_stop_gradient_stats=bn_variant == "stop_grad",
        bn_fused="pallas" if bn_variant == "fused_pallas" else bn_variant == "fused",
    )
    opt_cfg = OptimizerConfig(
        lr=float(model_param["lr"]),
        weight_decay=float(model_param["opt_weight_decay"]),
        optimizer=str(model_param["optimizer"]),
        warmup_epochs=int(model_param["warmup_epochs"]),
        epochs=int(model_param.get("lr_max_epochs") or epochs),
        accumulate_grad_batches=accum,
        train_iters_per_epoch=iters_per_epoch,
    )
    side = int(params.resize_shape[0])
    state = create_train_state(model, opt_cfg, seed, input_shape=(2, side, side, 3),
                               device=dev)
    logger.info(
        "model rn%s, base lr %.3e, %d iters/epoch",
        model_param["resnet_size"], opt_cfg.base_lr, iters_per_epoch,
    )

    ccfg = ContrastiveConfig(
        experiment_type=experiment_type,
        augmentation=tuple(model_param["augmentation"]),
        image_side=float(side),
        weight_type=str(model_param.get("weight_type", "linear")),
        diff_type=str(model_param.get("diff_type", "mpjpe")),
        pos_neg=str(model_param.get("pos_neg", "pos_neg")),
        joints_type=str(model_param.get("joints_type", "aug")),
        use_pca=bool(model_param.get("use_pca", False)),
        non_linear_lambda_pos=float(model_param.get("non_linear_lambda_pos", 5.0)),
        non_linear_lambda_neg=float(model_param.get("non_linear_lambda_neg", 0.05)),
        use_pallas=bool(args.use_pallas),
    )

    augment = (flags, params, side) if args.device_augment else None
    if getattr(args, "fsdp", False) and axis is not None:
        # ZeRO-3: parameters and Adam moments split over the ranks; every
        # BatchNorm, the head's too, and the loss over the global batch
        # (== one device's step on it; tests/test_torch_fsdp.py)
        step_fn, place_state, _ = make_fsdp_train_step(model, ccfg, axis, state,
                                                       augment=augment)
        state = place_state(replicate(axis, state))
    else:
        step_fn = make_train_step(model, ccfg, augment=augment, axis=axis)
        if axis is not None:
            state = replicate(axis, state)
    # under --device_augment the evaluation takes raw batches and augments
    # them with the fixed EVAL_AUGMENT_SEED, so validation never goes blind;
    # under FSDP it sees the gathered parameters
    eval_step = make_eval_step(model, ccfg, augment=augment, axis=axis)

    def eval_fn(state, batch):
        with gathered(state):
            return eval_step(state, batch)

    def save(step: int, metrics: dict) -> None:
        # an FSDP state's payload is gathered on every rank; rank 0 writes
        if is_main:
            manager.save(step, state, metrics)
        else:
            state.payload()

    # the held-out slice: Hand100M has no labelled val set, so the tail
    # (1 - train_ratio) of the index space serves as one
    train_ratio = float(train_param.get("train_ratio", 1.0))
    n_val = int(num_samples * (1.0 - train_ratio))
    n_val = (n_val // batch_size) * batch_size

    # ---------------- observability ----------------
    exp_name = args.experiment_name or cfg_mod.prepare_name(
        f"{experiment_type}_", train_param
    )
    metric_logger = MetricLogger(
        exp_name, tb_dir=constants.TENSORBOARD_LOGS, tags=list(args.tag)
    ) if is_main else None

    def log_metrics(metrics: dict, step: int) -> None:
        if metric_logger is not None:
            metric_logger.log_metrics(metrics, step)

    if args.meta_file and is_main:
        register_experiment(args.meta_file, exp_name, args.experiment_key)
    if args.debug and is_main:
        setup_debug_logging(
            os.path.join(constants.SAVED_META_INFO_PATH, "debug"), exp_name
        )

    # ---------------- checkpointing ----------------
    ckpt_dir = args.resume_path or os.path.join(
        constants.SAVED_MODELS_BASE_PATH, exp_name, "checkpoints"
    )
    manager = CheckpointManager(ckpt_dir, save_top_k=int(args.save_top_k))
    if args.checkpoint:
        # restore a named checkpoint: the name's digits are its step
        m = re.search(r"\d+", args.checkpoint)
        if m is None:
            raise ValueError(
                f"-checkpoint {args.checkpoint!r}: no step number in the "
                f"name (available steps: {manager.all_steps()})"
            )
        step_req = int(m.group())
        available = manager.all_steps()
        if step_req not in available:
            raise FileNotFoundError(
                f"-checkpoint {args.checkpoint!r}: step {step_req} not "
                f"under {ckpt_dir} (available: {available})"
            )
        state = manager.restore(state, step=step_req)
        logger.info("restored checkpoint step %s", step_req)
    elif args.resume or args.resume_path:
        restored = manager.restore(state)
        if restored is not None:
            state = restored
            logger.info("resumed from step %s", manager.latest_step())

    num_workers = int(train_param.get("num_workers", 8))
    if args.eval:
        # evaluation only: the checkpoint at --eval_path (or the run's own)
        # and the contrastive loss on the data
        eval_mgr = (
            CheckpointManager(args.eval_path) if args.eval_path else manager
        )
        restored = eval_mgr.restore(state)
        if restored is not None:
            state = restored
        losses = []
        host_iter = batch_iterator(dataset, batch_size, shuffle=False,
                                   raw=args.device_augment, num_threads=num_workers)
        feed = device_prefetch(host_iter, axis, dev)
        try:
            for i, batch in enumerate(feed):
                losses.append(eval_fn(state, batch)["contrastive_loss"])
                if i >= 50:
                    break
        finally:
            feed.close()
            host_iter.close()
        logger.info("eval contrastive_loss: %.5f", _mean(losses))
        if metric_logger is not None:
            metric_logger.close()
        manager.close()
        return state

    profiler = None
    if args.profile_dir and is_main:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        def export(prof) -> None:
            os.makedirs(args.profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(args.profile_dir, "trace.json"))

        profiler = torch.profiler.profile(
            activities=activities, on_trace_ready=export,
            schedule=torch.profiler.schedule(wait=0, warmup=0, active=PROFILE_STEPS, repeat=1))
        profiler.start()

    # ---------------- train loop ----------------
    global_step = 0
    max_steps = args.max_steps
    stop = False

    # preemption: SIGTERM asks for a checkpoint at the next step boundary,
    # then the run exits
    preempted = {"flag": False}

    def _on_sigterm(signum, frame):
        logger.warning("SIGTERM received — checkpointing at next boundary")
        preempted["flag"] = True

    try:
        previous_handler = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        previous_handler = None  # not the main thread
    try:
        for epoch in range(epochs):
            if stop:
                break
            epoch_losses = []
            epoch_steps = 0
            t_epoch = time.time()
            weights = (
                source.sample_weights() if hasattr(source, "sample_weights") else None
            )
            host_iter = batch_iterator(
                dataset, batch_size, seed=seed, epoch=epoch,
                num_threads=num_workers, raw=args.device_augment,
                sample_weights=weights,
            )
            prefetch_iter = device_prefetch(host_iter, axis, dev)
            try:
                for batch_idx, batch in enumerate(prefetch_iter):
                    state, metrics = step_fn(state, batch)
                    global_step += 1
                    epoch_steps += 1
                    if profiler is not None:
                        profiler.step()
                    if (batch_idx == 4 and epoch % 5 == 0 and metric_logger is not None
                            and metric_logger.takes_figures):
                        # the sample-pair figure every few epochs; under
                        # --device_augment the batch is raw, so one sample's
                        # views are made with the evaluation's fixed seed
                        from simhand_tpu_torch.utils.plots import plot_pair_images

                        if args.device_augment:
                            views = prepare_views(
                                {k: v[:1] for k, v in batch.items()},
                                seeded_generator(dev, EVAL_AUGMENT_SEED), flags, params,
                                side)
                        else:
                            views = batch
                        fig = plot_pair_images(
                            views["transformed_image1"][0].float().cpu().numpy(),
                            views["transformed_image2"][0].float().cpu().numpy(),
                            title=f"epoch {epoch}",
                        )
                        metric_logger.log_figure("sample_pair", fig, global_step)
                        import matplotlib.pyplot as plt

                        plt.close(fig)
                    if args.log_interval == "step":
                        log_metrics({k: float(v) for k, v in metrics.items()}, global_step)
                    else:
                        epoch_losses.append(metrics["contrastive_loss"])
                    if args.vis and args.vis_save_dir and global_step % 100 == 1 and is_main:
                        # the simhand_vis contract: an npy of the pair images
                        # (and joints) every 100 iterations
                        os.makedirs(args.vis_save_dir, exist_ok=True)
                        dump = {
                            k: v.cpu().numpy()
                            for k, v in batch.items()
                            if k.startswith(("transformed_image", "image", "joints"))
                        }
                        np.save(
                            os.path.join(args.vis_save_dir, f"iter_{global_step:07d}.npy"),
                            dump, allow_pickle=True,
                        )
                    if max_steps is not None and global_step >= max_steps:
                        stop = True
                        break
                    if (getattr(args, "fault_inject_preempt_step", None) is not None
                            and global_step >= args.fault_inject_preempt_step):
                        # the preemption drill: the SIGTERM path, at a set step
                        preempted["flag"] = True
                    if axis is not None:
                        # every rank stops at the same step
                        preempted["flag"] = axis.any_rank(preempted["flag"])
                    if preempted["flag"]:
                        save(global_step,
                             {"contrastive_loss": float(metrics["contrastive_loss"])})
                        manager.wait()
                        logger.warning("checkpoint saved at step %d; exiting", global_step)
                        stop = True
                        break
            finally:
                # close the loader now, not at the interpreter's exit
                prefetch_iter.close()
                host_iter.close()
            if epoch_losses:
                mean_loss = _mean(epoch_losses)
            else:
                mean_loss = float(metrics["contrastive_loss"])
            dt = time.time() - t_epoch
            logger.info(
                "epoch %d: contrastive_loss %.5f (%.1fs, %.1f pairs/s)",
                epoch, mean_loss, dt, batch_size * epoch_steps / dt,
            )
            log_metrics({"contrastive_loss_epoch": mean_loss}, global_step)
            if n_val > 0:
                val_losses = []
                val_order = np.arange(num_samples - n_val, num_samples)
                n_full = len(val_order) // batch_size
                if n_full:
                    val_batches = [
                        val_order[b * batch_size : (b + 1) * batch_size]
                        for b in range(n_full)
                    ]
                else:
                    # fewer val samples than one batch: tiled to the batch
                    val_batches = [np.resize(val_order, batch_size)]
                for idxs in val_batches:
                    if args.device_augment:
                        # raw batches; the evaluation augments them on the
                        # device with EVAL_AUGMENT_SEED
                        val_batch = dataset.raw_batch(idxs)
                        if val_batch is None:
                            pairs = [dataset.raw_pair(int(i)) for i in idxs]
                            val_batch = {
                                k: np.stack([s[k] for s in pairs]) for k in pairs[0]
                            }
                    else:
                        samples = [dataset.__getitem__(int(i), epoch=0) for i in idxs]
                        val_batch = {
                            k: np.stack([s[k] for s in samples]) for k in samples[0]
                        }
                    if axis is not None:
                        val_batch = shard_batch(axis, val_batch)
                    val_losses.append(
                        eval_fn(state, _to_device(val_batch, dev))["contrastive_loss"])
                log_metrics({"contrastive_loss_val": _mean(val_losses)}, global_step)
            if (epoch + 1) % max(int(args.save_period), 1) == 0 or epoch == epochs - 1:
                save(global_step, {"contrastive_loss": mean_loss})
    finally:
        if previous_handler is not None:
            signal.signal(signal.SIGTERM, previous_handler)

    manager.wait()
    if profiler is not None:
        profiler.stop()         # exports here if the run ended inside the window

    if args.export_torch:
        with gathered(state):
            if is_main:
                export_torch_encoder(state, args.export_torch)
                logger.info("exported torch encoder to %s", args.export_torch)
    if metric_logger is not None:
        metric_logger.close()
    manager.close()
    return state


if __name__ == "__main__":
    main()
