"""The port's flags, config, experiment names and metric logging
(``simhand_tpu_torch.experiments.{cli,config}``, ``utils``) against the JAX
package on the CPU; the model and loss configuration that both entry points
build from the same flags; and the rule that no module of the port imports
an optional package when it is imported.
"""
import argparse
import csv
import logging
import pathlib
import re
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simhand_tpu.experiments.cli as jcli
import simhand_tpu.experiments.config as jcfg
import simhand_tpu.experiments.main as jmain
import simhand_tpu_torch.experiments.cli as cli
import simhand_tpu_torch.experiments.config as cfg
import simhand_tpu_torch.experiments.main as main_mod
from simhand_tpu_torch import utils

REPO = pathlib.Path(__file__).resolve().parent.parent
# RECIPES.md's pre-training recipe
RECIPE = ("--experiment_type simhand_w --weight_type linear --diff_type mpjpe --pos_neg pos_neg "
          "--joints_type original --crop --resize --rotate --color_jitter -sources ego4d "
          "-sources 100doh --datasets_scale 2m -batch_size 8192 -epochs 100 -resnet_size 50 "
          "--data_dir /data --cache_dir /cache --device_augment "
          "--export_torch resnet50_simhand.pth").split()
ARGVS = {
    "defaults": [],
    "recipe": RECIPE,
    "pca_non_linear": RECIPE[:2] + ["--weight_type", "non_linear", "--non_linear_lambda_pos",
                                    "2.5", "--non_linear_lambda_neg", "0.01", "--use_pca",
                                    "--diff_type", "w_abs", "--pos_neg", "neg"],
    **{f"bn_{v}": ["--bn_variant", v, "-sources", "synthetic", "-sources", "ego4d",
                   "-sources", "synthetic"]
       for v in ("exact", "stop_grad", "fused", "fused_pallas")},
    "everything": ("--experiment_type peclr_w --resume --resume_path r --eval --eval_path e "
                   "--debug --vis --vis_save_dir v --color_drop --cut_out --flip "
                   "--gaussian_blur --random_crop --sobel_filter --gaussian_noise -tag a -tag b "
                   "-seed 3 --gpus 0,1 -num_workers 2 -train_ratio 0.5 "
                   "-accumulate_grad_batches 4 -lr 0.3 -optimizer adam --denoiser --heatmap "
                   "-log_interval step -experiment_key k -checkpoint epoch=3 -meta_file m.csv "
                   "-experiment_name n -save_period 2 -save_top_k 1 --encoder_trainable "
                   "-resnet_size 152 -lr_max_epochs 7 --use_palm --max_steps 9 "
                   "--profile_dir p --use_pallas --fsdp --cache_size 160 "
                   "--fault_inject_preempt_step 2").split(),
}


def jax_args(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["main.py", *argv])
    return vars(jcli.get_general_args())


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_parser_gives_jax_values(monkeypatch, name):
    got = vars(cli.get_general_args(ARGVS[name]))
    assert got.pop("device") == "cuda"
    assert got == jax_args(monkeypatch, ARGVS[name])


def test_parser_has_every_jax_flag_and_device(monkeypatch):
    """The same flags with the same names, types, defaults, choices and
    actions; the port adds only --device."""
    parsers = []
    real = argparse.ArgumentParser.parse_args

    def spy(self, args=None, namespace=None):
        parsers.append(self)
        return real(self, args, namespace)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", spy)
    cli.get_general_args([])
    jax_args(monkeypatch, [])
    ours, theirs = ({a.dest: (tuple(a.option_strings), type(a).__name__, a.type, a.default,
                              a.choices, a.nargs, a.const) for a in p._actions}
                    for p in parsers)
    assert ours.pop("device") == (("--device",), "_StoreAction", str, "cuda", None, None, None)
    assert ours == theirs
    assert vars(cli.get_general_args(["--device", "cpu"]))["device"] == "cpu"


def test_config_files_are_the_jax_files():
    ours, theirs = REPO / "simhand_tpu_torch/experiments/config", REPO / "simhand_tpu/experiments/config"
    names = sorted(p.name for p in theirs.iterdir())
    assert names == sorted(p.name for p in ours.iterdir())
    assert {"training_config.json", "model_config.json", "rn50_contrastive.yaml",
            "rn152_contrastive.yaml"} <= set(names)
    for n in names:
        assert (ours / n).read_bytes() == (theirs / n).read_bytes(), n
    assert utils.read_yaml(str(ours / "rn50_contrastive.yaml"))["preprocessing"]["resize"] == \
        [128, 128]


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_config_merge_matches(monkeypatch, name):
    """update_train_params, update_model_params, prepare_name and
    model_config_path give the JAX package's values for the same flags."""
    args = cli.get_general_args(ARGVS[name])
    jargs = types.SimpleNamespace(**jax_args(monkeypatch, ARGVS[name]))
    for etype in (args.experiment_type, "simhand-base", None):
        assert cfg.model_config_path(etype).replace("simhand_tpu_torch", "simhand_tpu") == \
            jcfg.model_config_path(etype)
    tp = cfg.update_train_params(args, cfg.read_json(cfg.TRAINING_CONFIG_PATH))
    jtp = jcfg.update_train_params(jargs, jcfg.read_json(jcfg.TRAINING_CONFIG_PATH))
    assert tp == jtp and isinstance(tp, cfg.Config)
    assert tp.augmentation_params.resize_shape == [128, 128]
    mp = cfg.update_model_params(cfg.read_json(cfg.MODEL_CONFIG_PATH), args, 1000, tp)
    jmp = jcfg.update_model_params(jcfg.read_json(jcfg.MODEL_CONFIG_PATH), jargs, 1000, jtp)
    assert mp == jmp
    for prefix in ("simhand_w_", "simclr_"):
        assert cfg.prepare_name(prefix, tp) == jcfg.prepare_name(prefix, jtp)
    if name == "recipe":
        assert cfg.prepare_name("simhand_w_", tp) == "simhand_w_8192C_CJ_Re_Ro"


def test_validation_refuses_what_jax_refuses():
    for bad in ({"weight_type": "cubic"}, {"diff_type": "l1"}, {"pos_neg": "both"},
                {"weight_type": "non_linear", "non_linear_lambda_pos": 3.0,
                 "non_linear_lambda_neg": 0.05}):
        with pytest.raises(AssertionError):
            jcfg._validate(bad)
        with pytest.raises(AssertionError):
            cfg._validate(bad)
    cfg._validate({"weight_type": "non_linear", "non_linear_lambda_pos": 1.0,
                   "non_linear_lambda_neg": 0.005})


class _Built(Exception):
    """Raised by the spies once the configuration is built."""


def built_configuration(monkeypatch, module, argv):
    """The ContrastiveModel and ContrastiveConfig keyword arguments that an
    entry point builds from ``argv``, stopped before it trains."""
    seen = {}

    def model_spy(**kw):
        seen["model"] = kw
        return object()

    def config_spy(**kw):
        seen["config"] = kw
        raise _Built

    if module is jmain:
        import simhand_tpu.models as jmodels
        import simhand_tpu.models.contrastive as jcontrastive
        import simhand_tpu.train as jtrain

        monkeypatch.setattr(jmodels, "ContrastiveModel", model_spy)
        monkeypatch.setattr(jtrain, "create_train_state", lambda *a, **k: None)
        monkeypatch.setattr(jcontrastive, "ContrastiveConfig", config_spy)
        monkeypatch.setattr(sys, "argv", ["main.py", *argv])
        with pytest.raises(_Built):
            jmain.main()
    else:
        monkeypatch.setattr(main_mod, "ContrastiveModel", model_spy)
        monkeypatch.setattr(main_mod, "create_train_state", lambda *a, **k: None)
        monkeypatch.setattr(main_mod, "ContrastiveConfig", config_spy)
        with pytest.raises(_Built):
            main_mod.main(argv + ["--device", "cpu"])
    dtype = seen["model"].pop("dtype")
    seen["model"]["dtype"] = {jnp.float32: "float32", jnp.bfloat16: "bfloat16",
                              torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    return seen


@pytest.mark.parametrize("etype,variant,extra", [
    ("simhand_w", "exact", ["--use_pallas"]),
    ("handclr_w", "stop_grad", ["--weight_type", "non_linear", "--use_pca"]),
    ("handclr", "fused", ["--crop", "--rotate"]),
    ("simhand-v0", "fused_pallas", ["-resnet_size", "50", "--pos_neg", "pos"]),
    ("simclr", "exact", ["--joints_type", "original", "--use_pallas"]),
])
def test_entry_points_build_the_same_model_and_loss(tmp_path, monkeypatch, etype, variant,
                                                    extra):
    """--bn_variant -> bn_fused / bn_stop_gradient_stats, the handclr* and
    simhand-v0 aliases, the precision rule and every ContrastiveConfig
    field, through each package's main up to its model."""
    argv = ["--experiment_type", etype, "--bn_variant", variant, "-sources", "synthetic",
            "--data_dir", str(tmp_path / "data"), "-batch_size", "8", *extra]
    got = built_configuration(monkeypatch, main_mod, argv)
    want = built_configuration(monkeypatch, jmain, argv)
    assert got == want
    assert got["config"]["experiment_type"] == {"handclr_w": "simhand_w", "handclr": "simhand",
                                                "simhand-v0": "simhand"}.get(etype, etype)
    assert got["model"]["bn_fused"] == {"fused": True, "fused_pallas": "pallas"}.get(variant,
                                                                                    False)
    assert got["model"]["dtype"] == "bfloat16"


def test_heatmap_is_refused_before_any_device(monkeypatch):
    with pytest.raises(NotImplementedError, match="heatmap"):
        main_mod.main(["--heatmap"])


def test_metric_logger_writes_tensorboard_events_and_the_registry(tmp_path):
    """Scalars and a figure in TensorBoard event files under tb_dir/<name>;
    the registry CSV in the JAX package's layout; the debug log file."""
    pytest.importorskip("tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    import importlib

    from simhand_tpu_torch.utils.logging import (
        MetricLogger,
        register_experiment,
        setup_debug_logging,
    )
    from simhand_tpu_torch.utils.plots import plot_pair_images

    jlog = importlib.import_module("simhand_tpu.utils.logging")
    ml = MetricLogger("exp", tb_dir=str(tmp_path / "tb"), tags=["t"])
    assert ml.takes_figures
    ml.log_metrics({"contrastive_loss": torch.tensor(2.5), "x": 1}, 3)
    ml.log_metrics({"contrastive_loss": 2.0}, 4)
    img = np.zeros((8, 8, 3), np.float32)
    ml.log_figure("sample_pair", plot_pair_images(img, img, np.ones((21, 3)), None, "t"), 4)
    ml.close()
    acc = EventAccumulator(str(tmp_path / "tb" / "exp"))
    acc.Reload()
    assert [(e.step, e.value) for e in acc.Scalars("contrastive_loss")] == [(3, 2.5), (4, 2.0)]
    assert acc.Tags()["images"] == ["sample_pair"]
    assert not MetricLogger("console").takes_figures

    for register, name in ((jlog.register_experiment, "jax.csv"),
                           (register_experiment, "port.csv")):
        register(str(tmp_path / "meta" / name), "exp_a", "key1")
        register(str(tmp_path / "meta" / name), "exp_b")
    rows = {}
    for name in ("jax.csv", "port.csv"):
        with open(tmp_path / "meta" / name) as f:
            rows[name] = [r[:2] + [len(r[2])] if i else r for i, r in enumerate(csv.reader(f))]
    assert rows["port.csv"] == rows["jax.csv"]
    assert rows["port.csv"][0] == ["experiment_name", "experiment_key", "timestamp"]
    lg = setup_debug_logging(str(tmp_path / "debug"), "exp")
    lg.debug("hello")
    for h in lg.handlers:
        h.flush()
    assert "hello" in (tmp_path / "debug" / "exp.log").read_text()
    assert utils.get_console_logger().name == "simhand_tpu_torch"
    utils.save_json({"a": [1, 2]}, str(tmp_path / "a.json"))
    assert utils.read_json(str(tmp_path / "a.json")) == {"a": [1, 2]}
    for h in lg.handlers:
        h.close()
    lg.handlers.clear()


OPTIONAL = ("cv2", "yaml", "matplotlib", "tensorboard", "tensorflow", "orbax", "comet_ml")


def test_no_module_of_the_port_imports_an_optional_package_at_module_level():
    """The card's machine has none of these: a module-level import would
    break the port's import there. Imports inside functions are allowed."""
    pattern = re.compile(r"^(import|from)\s+(%s)\b" % "|".join(OPTIONAL), re.M)
    tb = re.compile(r"^(import|from)\s+torch\.utils\.tensorboard\b", re.M)
    files = sorted((REPO / "simhand_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    assert [str(f) for f in files if pattern.search(f.read_text())
            or tb.search(f.read_text())] == []
    utils_dir = REPO / "simhand_tpu_torch/utils"
    assert "import yaml" in (utils_dir / "__init__.py").read_text()
    assert "from torch.utils.tensorboard import SummaryWriter" in \
        (utils_dir / "logging.py").read_text()
    assert "import matplotlib" in (utils_dir / "plots.py").read_text()
