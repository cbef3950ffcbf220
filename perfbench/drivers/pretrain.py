"""The cell driver of contrastive pre-training: the port's production
pre-training path, composed as ``experiments/main.py`` composes it for
``--cache_dir --device_augment --use_pallas --crop --resize --rotate
--color_jitter``.

  feed  data/cache.py CachedHand100MSource -> data/pipeline.py PretrainDataset,
        batch_iterator(raw=True) (gather.py -> csrc/batch_gather.cpp)
        -> data/prefetch.py device_prefetch
  step  train/loop.py make_train_step(model, ContrastiveConfig, augment=...)
        over models/contrastive.py ContrastiveModel and train/state.py's
        TrainState with train/optimizer.py's chain

Where it departs from ``main.py``:
  * the epochs are chained into one ``device_prefetch`` (main.py starts a
    new iterator, and new pinned buffers, each epoch);
  * no validation, checkpoint or logging runs;
  * the weights are drawn on the card from the seed (``draw_weights``) and
    copied into the model, where ``create_train_state`` draws them on the
    host; the state is built as ``create_train_state`` builds it otherwise;
  * the learning-rate schedule starts past its warm-up (the configuration's
    ``warmup_epochs`` is 0), so that every timed step moves the parameters.

The first ``checked_steps`` steps run through the window's own feed and
step. Their readings (each step's loss, the first gradient as Adam holds it,
each leaf's change, the running statistics', the first step's embeddings)
are compared with the plain
reference once the window has closed and the program's state is gone.
"""
from __future__ import annotations

import gc
import time

import torch

from perfbench import compare
from perfbench.spec import load_module


def _chained_epochs(dataset, batch_pairs: int, seed: int, threads: int):
    """The raw batches of epoch 0, 1, 2, ... without end, each epoch in the
    feed's own order for (seed, epoch)."""
    from simhand_tpu_torch.data.pipeline import batch_iterator

    epoch = 0
    while True:
        it = batch_iterator(dataset, batch_pairs, seed=seed, epoch=epoch,
                            num_threads=threads, raw=True)
        try:
            yield from it
        finally:
            it.close()
        epoch += 1


class PretrainCell:
    """One cell's program under test, its window step and its check."""

    def __init__(self, spec, seed: int, device: torch.device, work_dir: str):
        self.spec, self.seed, self.device, self.work_dir = spec, int(seed), device, work_dir
        self.cfg, self.traffic = spec.config, spec.traffic
        self.reference = load_module(spec.root, "reference", self.cfg["reference"])
        self.generator = load_module(spec.root, "traffic", self.traffic["generator"])
        self.batch_pairs = int(self.cfg["batch_size"])
        self.samples_per_step = self.batch_pairs          # a sample is a positive pair
        side = int(self.cfg["augmentation_params"]["resize_shape"][0])
        self.flops_per_sample = (float(self.cfg["fwd_gflops_224"]) * 1e9 * (side / 224.0) ** 2
                                 * 3 * 2)
        # the rows of the NT-Xent kernels' planes; none off the kernel route
        self.ntxent_rows = 2 * self.batch_pairs if self.cfg["use_pallas"] else None
        self.feed_wait_s = 0.0
        self.losses: list[torch.Tensor] = []
        self.readings: dict = {}

    # ------------------------------------------------------------------
    def _build(self):
        from simhand_tpu_torch.data.augment_cv2 import AugmentFlags, AugmentParams
        from simhand_tpu_torch.data.cache import CachedHand100MSource
        from simhand_tpu_torch.data.pipeline import PretrainDataset
        from simhand_tpu_torch.models import ContrastiveConfig, ContrastiveModel
        from simhand_tpu_torch.parallel import device_prefetch
        from simhand_tpu_torch.train import OptimizerConfig, make_train_step
        from simhand_tpu_torch.train.optimizer import Optimizer, decay_mask
        from simhand_tpu_torch.train.state import TrainState

        cfg = self.cfg
        flags = AugmentFlags(**{k: bool(v) for k, v in cfg["augmentation_flags"].items()})
        ap = cfg["augmentation_params"]
        params = AugmentParams(
            crop_margin=ap["crop_margin"], crop_margin_range=tuple(ap["crop_margin_range"]),
            cut_out_fraction=tuple(ap["cut_out_fraction"]),
            hue_factor_range=tuple(ap["hue_factor_range"]),
            min_angle=min(ap["min_angle"], ap["max_angle"]),
            max_angle=max(ap["min_angle"], ap["max_angle"]),
            resize_shape=tuple(ap["resize_shape"]),
            sat_factor_range=tuple(ap["sat_factor_range"]),
            value_factor_alpha_range=tuple(ap["value_factor_alpha_range"]),
            value_factor_beta_range=tuple(ap["value_factor_beta_range"]),
            crop_box_jitter=tuple(ap["crop_box_jitter"]), sobel_kernel=int(ap["sobel_kernel"]),
            noise_std=float(ap["noise_std"]))
        side = int(params.resize_shape[0])
        source = CachedHand100MSource(self.corpus)
        dataset = PretrainDataset(source, cfg["experiment_type"], flags, params, seed=self.seed)

        model = ContrastiveModel(
            resnet_size=str(cfg["resnet_size"]),
            proj_hidden_dim=int(cfg["projection_head_hidden_dim"]),
            proj_output_dim=int(cfg["output_dim"]),
            dtype=torch.bfloat16 if str(cfg["precision"]) in ("16", "bf16") else torch.float32,
            bn_stop_gradient_stats=cfg["bn_variant"] == "stop_grad",
            bn_fused="pallas" if cfg["bn_variant"] == "fused_pallas"
            else cfg["bn_variant"] == "fused")
        self._load_weights(model)
        opt_cfg = OptimizerConfig(
            lr=float(cfg["lr"]), weight_decay=float(cfg["opt_weight_decay"]),
            optimizer=str(cfg["optimizer"]), warmup_epochs=int(cfg["warmup_epochs"]),
            epochs=int(cfg["epochs"]),
            accumulate_grad_batches=int(cfg["accumulate_grad_batches"]),
            train_iters_per_epoch=int(cfg["train_iters_per_epoch"]),
            lars_eta=float(cfg["lars_eta"]))
        plist = list(model.parameters())
        self.state = TrainState(model, Optimizer(opt_cfg, plist, decay_mask(model)))
        ccfg = ContrastiveConfig(
            experiment_type=cfg["experiment_type"],
            augmentation=tuple(k for k, v in cfg["augmentation_flags"].items() if v),
            temperature=float(cfg["temperature"]), image_side=float(side),
            weight_type=cfg["weight_type"], diff_type=cfg["diff_type"],
            pos_neg=cfg["pos_neg"], joints_type=cfg["joints_type"], use_pca=False,
            use_pallas=bool(cfg["use_pallas"]))
        self.step_fn = make_train_step(model, ccfg, augment=(flags, params, side))
        self.host_batches = _chained_epochs(dataset, self.batch_pairs, self.seed,
                                            int(cfg["num_workers"]))
        self.feed = device_prefetch(self.host_batches, None, self.device)

    def _load_weights(self, model) -> None:
        """The seed's weights, drawn on the card, into ``model`` by name."""
        spec = self.reference.param_spec(self.cfg)
        self.weights = self.reference.draw_weights(spec, self.seed, self.device)
        model.to(self.device)
        own = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
        if set(own) != set(self.weights):
            raise ValueError(f"the model's keys differ from the reference's: "
                             f"{sorted(set(own) ^ set(self.weights))[:6]}")
        with torch.no_grad():
            for k, t in own.items():
                t.copy_(self.weights[k])

    # ------------------------------------------------------------------
    def setup(self) -> None:
        """The corpus, the program, its checked steps and its warm-up."""
        self.corpus = self.generator.ensure_corpus(self.traffic, self.work_dir, self.device)
        self._build()
        model, opt = self.state.model, self.state.optimizer
        names = [n for n, _ in model.named_parameters()]
        losses, emb = [], []
        # the first step's embeddings, as the encoder hands them to the head
        hook = model.encoder.register_forward_hook(
            lambda module, args, out: emb.append(out.detach().to("cpu", copy=True)))
        for i in range(int(self.traffic["checked_steps"])):
            self.state, metrics = self.step_fn(self.state, next(self.feed))
            losses.append(metrics["contrastive_loss"])
            if i == 0:
                hook.remove()
                with torch.no_grad():
                    # the first gradient as Adam holds it: its first
                    # moment over (1 - b1)
                    first = {n: float(m.norm()) / (1 - 0.9) for n, m in zip(names, opt.mu)}
                    # the first step's batch variances, from the running
                    # ones (momentum 0.9 from 1)
                    var0 = {k[:-len(".running_var")]: ((v.float() - 0.9) / 0.1).cpu()
                            for k, v in model.state_dict().items()
                            if k.endswith("running_var")}
        with torch.no_grad():
            now = {k: v for k, v in model.state_dict().items()
                   if not k.endswith("num_batches_tracked")}
            change = {k: float((now[k].float() - self.weights[k]).norm()) for k in now}
        self.readings = {"losses": [float(x) for x in losses], "embeddings": emb[0],
                         "batch_var": var0,
                         "first_grad": first, "change": change}
        del self.weights
        for _ in range(int(self.traffic["warmup_steps"])):
            self.state, _ = self.step_fn(self.state, next(self.feed))
        self.sync()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self) -> None:
        """One timed step: the next batch off the feed, then the step."""
        t = time.perf_counter()
        batch = next(self.feed)
        self.feed_wait_s += time.perf_counter() - t
        self.state, metrics = self.step_fn(self.state, batch)
        self.losses.append(metrics["contrastive_loss"])

    def traced_step(self) -> None:
        """``step`` inside the harness's spans, which the trace names gaps by."""
        from torch.profiler import record_function

        with record_function("perfbench.feed"):
            batch = next(self.feed)
        with record_function("perfbench.step"):
            self.state, _ = self.step_fn(self.state, batch)

    @staticmethod
    def launch_counts() -> dict[str, int]:
        """The launches the port's NT-Xent wrappers have counted, by the name
        of the kernel each launches (its sum pass is named otherwise)."""
        from simhand_tpu_torch.losses import ntxent_kernels as K

        return {"plain_denom_kernel": K.ntxent_denominator.launches,
                "weighted_denom_kernel": K.weighted_ntxent_denominator.launches,
                "plain_grad_kernel": K.ntxent_grad.launches,
                "weighted_grad_kernel": K.weighted_grad_rows.launches}

    def window_failures(self) -> tuple[int, int]:
        """(steps in the window, steps whose loss is not finite)."""
        if not self.losses:
            return 0, 0
        finite = torch.isfinite(torch.stack(self.losses))
        return len(self.losses), int((~finite).sum())

    # ------------------------------------------------------------------
    def close_program(self) -> None:
        """Stops the feed's threads and frees the program's state."""
        feed, host = getattr(self, "feed", None), getattr(self, "host_batches", None)
        if feed is not None:
            feed.close()
        if host is not None:
            host.close()
        for name in ("feed", "host_batches", "state", "step_fn", "losses"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_readings(self, compute: str = "float32", half_batch: bool = False,
                           perturb: float = 0.0) -> dict:
        """The plain reference's readings of the checked steps, from the
        seed's weights (each weight moved by ``perturb`` times a unit normal
        draw, relative to itself) and the corpus on disk."""
        ref = self.reference
        steps = int(self.traffic["checked_steps"])
        weights = ref.draw_weights(ref.param_spec(self.cfg), self.seed, self.device)
        if perturb:
            g = torch.Generator(device=self.device).manual_seed(self.seed + 1)
            weights = {k: v if ref.is_buffer(k) else v * (1 + perturb * torch.randn(
                v.shape, generator=g, device=self.device)) for k, v in weights.items()}
        batches = ref.raw_batches(self.corpus, self.seed, self.batch_pairs, steps, self.device)
        return ref.run_steps(self.cfg, weights, batches, compute=compute, half_batch=half_batch)

    def check(self, limits: dict) -> dict:
        """{name: (reading, limit)} of the program's checked steps against the
        reference's; the program's state must be freed first."""
        gaps = compare.gaps(self.readings, self.reference_readings())
        return {name: (gaps[name], float(limits[name])) for name in limits}

#: the class the harness finds by the configuration's ``driver``
Cell = PretrainCell
