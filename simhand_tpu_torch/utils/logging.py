"""Metric logging (counterpart of ``simhand_tpu/utils/logging.py``): the
console, TensorBoard, Comet when ``COMET_API_KEY`` is set, and the
experiment registry.

TensorBoard goes through ``torch.utils.tensorboard.SummaryWriter``,
imported when the logger is made; where it cannot be imported (it needs the
``tensorboard`` package), the logger warns and logs to the console only, as
the JAX package does without ``tensorflow``.
"""
from __future__ import annotations

import csv
import importlib.util
import logging
import os
import time

logger = logging.getLogger("simhand_tpu_torch.metrics")


class MetricLogger:
    def __init__(self, experiment_name: str, tb_dir: str | None = None,
                 tags: list[str] | None = None):
        self.experiment_name = experiment_name
        self._tb = None
        self._comet = None
        if tb_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(tb_dir, experiment_name))
            except ImportError as e:
                logger.warning("TensorBoard logging disabled: %s", e)
        if os.environ.get("COMET_API_KEY"):
            try:  # pragma: no cover - needs comet_ml and the network
                import comet_ml

                self._comet = comet_ml.Experiment(
                    api_key=os.environ["COMET_API_KEY"],
                    project_name=os.environ.get("COMET_PROJECT", "simhand-tpu"),
                )
                self._comet.set_name(experiment_name)
                for t in tags or []:
                    self._comet.add_tag(t)
            except Exception as e:
                logger.warning("Comet logging disabled: %s", e)

    @property
    def takes_figures(self) -> bool:
        """Whether a sink (TensorBoard or Comet) records figures and
        ``matplotlib``, which draws them, can be imported."""
        sink = self._tb is not None or self._comet is not None
        return sink and importlib.util.find_spec("matplotlib") is not None

    def log_metrics(self, metrics: dict, step: int) -> None:
        msg = " ".join(f"{k}={float(v):.5f}" for k, v in metrics.items())
        logger.info("step %d %s", step, msg)
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), global_step=step)
            self._tb.flush()
        if self._comet is not None:  # pragma: no cover
            self._comet.log_metrics({k: float(v) for k, v in metrics.items()}, step=step)

    def log_figure(self, name: str, fig, step: int) -> None:
        """Records a matplotlib figure (the reference's sample-pair figures)."""
        if self._tb is not None:
            self._tb.add_figure(name, fig, global_step=step)
            self._tb.flush()
        if self._comet is not None:  # pragma: no cover
            self._comet.log_figure(figure_name=name, figure=fig, step=step)

    def close(self):
        if self._tb is not None:
            self._tb.close()
        if self._comet is not None:  # pragma: no cover
            self._comet.end()


def register_experiment(meta_file: str, experiment_name: str,
                        key: str | None = None) -> None:
    """Appends (name, key, timestamp) to the experiment registry CSV, in the
    JAX package's layout."""
    os.makedirs(os.path.dirname(os.path.abspath(meta_file)), exist_ok=True)
    new = not os.path.exists(meta_file)
    with open(meta_file, "a", newline="") as f:
        w = csv.writer(f)
        if new:
            w.writerow(["experiment_name", "experiment_key", "timestamp"])
        w.writerow([experiment_name, key or "", time.strftime("%Y-%m-%d %H:%M:%S")])


def setup_debug_logging(log_dir: str, experiment_name: str) -> logging.Logger:
    """An opt-in debug logger writing to ``log_dir/<experiment_name>.log``."""
    os.makedirs(log_dir, exist_ok=True)
    lg = logging.getLogger(f"simhand_tpu_torch.debug.{experiment_name}")
    lg.setLevel(logging.DEBUG)
    fh = logging.FileHandler(os.path.join(log_dir, f"{experiment_name}.log"))
    fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    lg.addHandler(fh)
    return lg
