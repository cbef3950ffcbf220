"""A cell's files, found by name.

  BENCHMARK.json             which metrics each cell reports
  perfbench/workloads/<cell>.json    its configuration, traffic, chips and limits
  perfbench/configs/<config>.json    the model and run as they are run
  perfbench/traffic/<traffic>.json   the traffic mix's parameters
  perfbench/<kind>/<name>.py         a driver, reference, generator or metric

Nothing here knows a particular cell: a later cell adds files and entries.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import os
import re
import sys

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"{what} {name!r} is not a name: at most 64 of A-Z a-z 0-9 _ . -, "
                         "not starting with . or -")
    return name


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(root: str, kind: str, name: str):
    """perfbench/<kind>/<name>.py under ``root``, loaded from its path (a
    name may hold dots); each file once per process."""
    check_name(name, kind)
    path = os.path.abspath(os.path.join(root, "perfbench", kind, f"{name}.py"))
    key = f"perfbench._{hashlib.sha256(path.encode()).hexdigest()[:12]}"
    if key in sys.modules:
        return sys.modules[key]
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} named {name!r}: {path} is missing")
    module_spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(module_spec)
    sys.modules[key] = module
    module_spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Spec:
    root: str
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    @property
    def limits(self) -> dict:
        return self.workload["limits"]


def _reported(metrics: list[dict], cell: str) -> list[dict]:
    out = []
    for m in metrics:
        check_name(m["name"], "metric")
        if not UNIT.match(m["unit"]):
            raise ValueError(f"metric {m['name']}: unit {m['unit']!r} is not a unit")
        if "workloads" not in m or cell in m["workloads"]:
            out.append(m)
    return out


def load_spec(root: str, cell: str) -> Spec:
    """The cell ``cell`` of the checkout at ``root``."""
    check_name(cell, "workload")
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    workload = read_json(os.path.join(root, "perfbench", "workloads", f"{cell}.json"))
    listed = {w["name"]: w for w in bench.get("workloads", [])}
    if cell in listed:
        for key in ("config", "traffic", "chips"):
            if listed[cell][key] != workload[key]:
                raise ValueError(f"{cell}: BENCHMARK.json's {key} {listed[cell][key]!r} "
                                 f"differs from the workload file's {workload[key]!r}")
    config = read_json(os.path.join(
        root, "perfbench", "configs", f"{check_name(workload['config'], 'config')}.json"))
    traffic = read_json(os.path.join(
        root, "perfbench", "traffic", f"{check_name(workload['traffic'], 'traffic')}.json"))
    return Spec(root, cell, workload, config, traffic,
                _reported(bench["end_to_end"], cell), _reported(bench["per_layer"], cell))
