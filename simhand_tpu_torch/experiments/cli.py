"""The pre-training flags (counterpart of ``simhand_tpu/experiments/cli.py``):
every flag of the JAX package with the same name, type, default and
choices, so the published recipes run unchanged, and one more, ``--device``
(the counterpart of the JAX run's ``JAX_PLATFORMS``): ``cuda`` unless the
caller asks for the CPU.
"""
from __future__ import annotations

import argparse


def get_general_args(
    argv: list[str] | None = None,
    description: str = "simhand_tpu_torch pre-training",
) -> argparse.Namespace:
    """Parses ``argv`` (``sys.argv[1:]`` when None)."""
    parser = argparse.ArgumentParser(description=description)

    parser.add_argument("--experiment_type", type=str, help="The training model name.")
    parser.add_argument("--weight_type", type=str, help="Weight type (linear / non_linear)")
    parser.add_argument("--joints_type", type=str, help="joints type (original / augmented)")
    parser.add_argument("--diff_type", type=str, help="joints_differ (w_o_abs / w_abs / mpjpe)")
    parser.add_argument("--pos_neg", type=str, help="pos_neg weighting(pos / neg / pos_neg)")
    parser.add_argument("--non_linear_lambda_pos", type=float, help="non_linear_parm (5.0 / 2.5 / 1.0)")
    parser.add_argument("--non_linear_lambda_neg", type=float, help="non_linear_parm (0.05 / 0.01 / 0.005)")
    parser.add_argument("--use_pca", action="store_true", default=False, help="To enable PCA denoise.")
    parser.add_argument("--resume", action="store_true", help="resume the model training.")
    parser.add_argument("--resume_path", type=str, help="resume the model checkpoints path")
    parser.add_argument("--eval", action="store_true", help="eval the model and visualization.")
    parser.add_argument("--eval_path", type=str, help="eval the model checkpoints path")
    parser.add_argument("--debug", action="store_true", help="Enable debug logging.")
    parser.add_argument("--vis", action="store_true", help="Enable save the intermediate data.")
    parser.add_argument("--vis_save_dir", type=str, default="", help="data visualization save dir")
    parser.add_argument("--datasets_scale", type=str, help="Usage scale of the pre-trained data set.")

    # Augmentation flags
    parser.add_argument("--color_drop", action="store_true", help="To enable random color drop")
    parser.add_argument("--color_jitter", action="store_true", help="To enable random jitter")
    parser.add_argument("--crop", action="store_true", help="To enable cropping")
    parser.add_argument("--cut_out", action="store_true", help="To enable random cut out")
    parser.add_argument("--flip", action="store_true", help="(kept-and-ignored like the reference: no flip op exists in its augmenter either — the flag only fed the experiment-name code)")
    parser.add_argument("--gaussian_blur", action="store_true", help="To enable gaussian blur")
    parser.add_argument("--rotate", action="store_true", help="To rotate samples randomly")
    parser.add_argument("--random_crop", action="store_true", help="To enable random cropping")
    parser.add_argument("--resize", action="store_true", help="To enable resizing")
    parser.add_argument("--sobel_filter", action="store_true", help="To enable sobel filtering")
    parser.add_argument("--gaussian_noise", action="store_true", help="To add gaussian noise.")
    parser.add_argument("-tag", action="append", default=[], help="Tag for logging")

    # Training and data-loader params
    parser.add_argument("-batch_size", type=int, help="Global batch size")
    parser.add_argument("-epochs", type=int, help="Number of epochs")
    parser.add_argument("-seed", type=int, help="To add seed")
    parser.add_argument("--gpus", type=str, default="0", help="(ignored: one card; kept for recipe compat)")
    parser.add_argument("-num_workers", type=int, help="Number of workers for the input pipeline.")
    parser.add_argument("-train_ratio", type=float, help="Ratio of train:validation split.")
    parser.add_argument("-accumulate_grad_batches", type=int, help="Number of batches to accumulate gradient.")
    parser.add_argument("-lr", type=float, default=None, help="learning rate")
    parser.add_argument("-optimizer", type=str, default=None, choices=["LARS", "adam"], help="Select optimizer")
    parser.add_argument("--denoiser", action="store_true", default=False, help="z-root denoiser MLP (reference: only meaningful with --heatmap, which errors for all 8 types; kept for name/compat)")
    parser.add_argument("--heatmap", action="store_true", default=False, help="heatmap model variant (the reference raises for every experiment type — experiments/utils.py:633-665; rejected here too)")
    parser.add_argument(
        "-sources", action="append", default=[],
        choices=["freihand", "interhand", "mpii", "youtube", "ego4d", "100doh",
                 "ah", "ah-exo", "ah-ego", "synthetic"],
        help="Data sources to use.",
    )
    parser.add_argument("-log_interval", type=str, default="epoch", choices=["step", "epoch"])
    parser.add_argument("-experiment_key", type=str, default=None, help="Experiment key of pretrained encoder")
    parser.add_argument("-checkpoint", type=str, default="", help="checkpoint name to restore.")
    parser.add_argument("-meta_file", type=str, default=None, help="File to save the name of the experiment.")
    parser.add_argument("-experiment_name", type=str, default="", help="experiment name for logging")
    parser.add_argument("-save_period", type=int, default=1, help="interval at which experiments should be saved")
    parser.add_argument("-save_top_k", type=int, default=3, help="Top snapshots to save")
    parser.add_argument("--encoder_trainable", action="store_true", default=False, help="(kept-and-ignored like the reference: declared at experiments/utils.py:211 but never consumed)")
    parser.add_argument(
        "-resnet_size", type=str, default="18",
        choices=["18", "34", "50", "101", "152"], help="Resnet size",
    )
    parser.add_argument("-lr_max_epochs", type=int, default=None, help="LR schedule horizon override")
    parser.add_argument("--use_palm", action="store_true", default=False, help="To regress palm instead of wrist.")

    # additions of the JAX package; the port keeps their names
    parser.add_argument("--data_dir", type=str, default=None, help="dataset root (overrides env HAND2M_DATA)")
    parser.add_argument("--max_steps", type=int, default=None, help="cap total optimizer steps (smoke runs)")
    parser.add_argument("--export_torch", type=str, default=None, help="path to export encoder as torch .pth")
    parser.add_argument("--profile_dir", type=str, default=None, help="write a torch.profiler Chrome trace here")
    parser.add_argument("--device_augment", action="store_true", default=False,
                        help="run the augmentation chain fused on-device")
    parser.add_argument("--use_pallas", action="store_true", default=False,
                        help="the NT-Xent CUDA kernels (csrc/ntxent.cu) "
                             "in place of the dense loss")
    parser.add_argument("--fsdp", action="store_true", default=False,
                        help="shard params + optimizer state over the "
                             "ranks (ZeRO-3; does nothing on one device, "
                             "as in the JAX package)")
    parser.add_argument("--cache_dir", type=str, default=None,
                        help="packed-crop cache dir (built on first use); "
                             "removes per-step JPEG decode from the input path")
    parser.add_argument("--cache_size", type=int, default=None,
                        help="crop resolution the cache stores (default "
                             "224 = reference CROP_SIZE). 160 cuts host+H2D "
                             "bytes 2x with full crop-jitter+rotate margin "
                             "for the 128-px model; exact loader-at-that-"
                             "resolution semantics (joints are normalized)")
    parser.add_argument("--bn_variant", default="exact",
                        choices=["exact", "stop_grad", "fused", "fused_pallas"],
                        help="BatchNorm implementation. exact = flax BN "
                             "(reference semantics, default); stop_grad = "
                             "no backprop through the batch statistics; "
                             "fused / fused_pallas = the hand-derived "
                             "backward (fused_pallas: its reduces on the "
                             "csrc/bn_epilogue.cu kernel; models/fused_bn.py)")
    parser.add_argument("--fault_inject_preempt_step", type=int, default=None,
                        help="testing: simulate a SIGTERM preemption at this "
                             "global step (exercises the checkpoint-and-exit "
                             "path deterministically)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; without a card, cuda raises")

    return parser.parse_args(argv)
