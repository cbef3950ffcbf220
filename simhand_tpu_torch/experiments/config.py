"""Config plumbing (counterpart of ``simhand_tpu/experiments/config.py``):
JSON defaults with CLI overrides, attribute-style access.

The three-tier merge of the reference (argparse -> model config JSON ->
training config JSON) with every key of its configs, so the published
recipes run unchanged. The JSON and YAML files under ``config/`` are
copies of the JAX package's.
"""
from __future__ import annotations

import json
import os
from typing import Any

_CONFIG_DIR = os.path.join(os.path.dirname(__file__), "config")

TRAINING_CONFIG_PATH = os.path.join(_CONFIG_DIR, "training_config.json")
MODEL_CONFIG_PATH = os.path.join(_CONFIG_DIR, "model_config.json")


class Config(dict):
    """dict with attribute access (replaces easydict)."""

    def __getattr__(self, k: str) -> Any:
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return Config(v) if isinstance(v, dict) and not isinstance(v, Config) else v

    def __setattr__(self, k: str, v: Any) -> None:
        self[k] = v

    @staticmethod
    def deep(d: dict) -> "Config":
        return Config(
            {k: Config.deep(v) if isinstance(v, dict) else v for k, v in d.items()}
        )


def read_json(path: str) -> Config:
    with open(path) as f:
        return Config.deep(json.load(f))


def model_config_path(experiment_type: str | None) -> str:
    """Per-experiment config if present (simclr_config.json etc.), else the
    shared model_config.json (all reference per-experiment configs carry
    identical values)."""
    if experiment_type:
        base = experiment_type.replace("-", "_")
        candidate = os.path.join(_CONFIG_DIR, f"{base}_config.json")
        if os.path.exists(candidate):
            return candidate
    return MODEL_CONFIG_PATH


def update_params(config: Config, args: Any, keys: list[str]) -> Config:
    """CLI args override JSON defaults when not None (reference:
    src/experiments/utils.py:386-401)."""
    for key in keys:
        v = getattr(args, key, None)
        if v is not None and v != [] and v != "":
            config[key] = v
    return config


def update_train_params(args: Any, train_param: Config) -> Config:
    train_param = update_params(
        train_param,
        args,
        ["batch_size", "epochs", "train_ratio", "num_workers", "seed",
         "accumulate_grad_batches"],
    )
    flags = train_param.augmentation_flags
    for flag in [
        "color_drop", "color_jitter", "crop", "cut_out", "gaussian_blur",
        "random_crop", "resize", "rotate", "gaussian_noise", "sobel_filter",
    ]:
        if getattr(args, flag, False):
            flags[flag] = True
    train_param["augmentation_flags"] = flags
    return train_param


def update_model_params(model_param: Config, args: Any, num_samples: int,
                        train_param: Config) -> Config:
    model_param["num_samples"] = num_samples
    model_param["batch_size"] = train_param["batch_size"]
    model_param["num_of_mini_batch"] = train_param.get(
        "accumulate_grad_batches", 1
    )
    model_param = update_params(
        model_param, args, ["optimizer", "lr", "resnet_size", "lr_max_epochs"]
    )
    # augmentations active for the equivariance path
    model_param["augmentation"] = [
        k for k, v in train_param["augmentation_flags"].items() if v
    ]
    for key in ("weight_type", "joints_type", "diff_type", "pos_neg",
                "non_linear_lambda_pos", "non_linear_lambda_neg"):
        v = getattr(args, key, None)
        if v is not None:
            model_param[key] = v
    model_param["use_pca"] = bool(getattr(args, "use_pca", False))
    _validate(model_param)
    return model_param


def _validate(m: Config) -> None:
    """Enum validation (reference: src/experiments/utils.py:736-753)."""
    if "weight_type" in m:
        assert m["weight_type"] in ("linear", "non_linear"), m["weight_type"]
    if "diff_type" in m:
        assert m["diff_type"] in ("w_o_abs", "w_abs", "mpjpe"), m["diff_type"]
    if "pos_neg" in m:
        assert m["pos_neg"] in ("pos", "neg", "pos_neg"), m["pos_neg"]
    if "non_linear_lambda_pos" in m and m.get("weight_type") == "non_linear":
        assert m["non_linear_lambda_pos"] in (5.0, 2.5, 1.0)
        assert m["non_linear_lambda_neg"] in (0.05, 0.01, 0.005)


def prepare_name(prefix: str, train_param: Config, hybrid_naming: bool = False) -> str:
    """Experiment-name codes from active augmentations — byte-identical
    to the reference's layout (src/experiments/utils.py:404-462):
    ``{prefix}{batch_size}{sorted _-joined UPPERCASE codes}``, e.g.
    ``simhand_w_8192C_CJ_Re_Ro`` — so checkpoint dirs / TB runs / the
    experiment registry line up with names from reference tooling."""
    codes = {
        "color_drop": "CD", "color_jitter": "CJ", "crop": "C",
        "cut_out": "CO", "flip": "F", "gaussian_blur": "GB",
        "random_crop": "RC", "resize": "Re", "rotate": "Ro",
        "sobel_filter": "SF", "gaussian_noise": "GN",
    }
    active = [
        codes[k] for k, v in train_param["augmentation_flags"].items()
        if v and k in codes
    ]
    return f"{prefix}{train_param['batch_size']}{'_'.join(sorted(active))}"
