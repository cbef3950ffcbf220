"""The benchmark's files: BENCHMARK.json to the contract's shape, every cell,
configuration, traffic mix and metric found by name, and no file under
perfbench/ that imports JAX, flax or the JAX package."""
from __future__ import annotations

import ast
import json
import os
import shutil

import pytest

from perfbench import spec as S
from perfbench.tests.toy import REPO

BENCH = os.path.join(REPO, "BENCHMARK.json")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
WIDTHS = ("hidden", "intermediate", "latent", "state", "projection", "head")


def bench() -> dict:
    with open(BENCH) as f:
        return json.load(f)


def test_benchmark_json_shape():
    b = bench()
    assert set(b) == KEYS
    assert b["paths"] == ["perfbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]] + [
        m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for name in names:
        S.check_name(name, "name")
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and os.path.isfile(os.path.join(REPO, c["file"]))
        assert len(c["why"]) <= 200 and len(c["source"]) <= 200 and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            S.check_name(key, "reduced key")
            assert not key.endswith(("_dim", "_rank")) and not any(w in key for w in WIDTHS)
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
    for m in b["end_to_end"] + b["per_layer"]:
        assert S.UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(b)) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cells_found_by_name(cell):
    spec = S.load_spec(REPO, cell)
    assert spec.chips == 1
    assert {m["name"] for m in spec.end_to_end} >= {"samples_per_s", "setup_s"}
    assert spec.per_layer
    S.load_module(REPO, "drivers", spec.config["driver"]).Cell
    S.load_module(REPO, "reference", spec.config["reference"]).run_steps
    S.load_module(REPO, "traffic", spec.traffic["generator"]).ensure_corpus
    assert set(spec.limits) and all(v > 0 for v in spec.limits.values())


@pytest.mark.parametrize("entry", bench()["end_to_end"] + bench()["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_modules(entry):
    module = S.load_module(REPO, "metrics", entry["name"])
    assert module.UNIT == entry["unit"]
    assert module.MOVES == entry.get("moves")
    if "layer" in entry:
        assert module.LAYER == entry["layer"]


@pytest.mark.parametrize("bad", ["", ".x", "-x", "a b", "a/b", "a,b", "é", "x" * 65])
def test_bad_names(bad):
    with pytest.raises(ValueError):
        S.check_name(bad, "name")


def _top_level_imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _sources():
    for base, _, files in os.walk(os.path.join(REPO, "perfbench")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports(path):
    found = _top_level_imports(path)
    assert not found & {"jax", "jaxlib", "flax", "simhand_tpu"}, found
    if os.sep + "reference" + os.sep in path:
        assert "simhand_tpu_torch" not in found and "perfbench" not in found, found


def test_new_cell_and_metric_found_without_code(tmp_path):
    """A later PR adds a workload file, a metric module and their entries:
    the harness finds both with no edit of a file that is there."""
    root = tmp_path / "root"
    shutil.copytree(os.path.join(REPO, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    b["workloads"].append({"name": "rn50_later", "config": "rn50_simhand_w",
                           "traffic": "pretrain_cache_fed", "chips": 1, "why": "a later cell"})
    b["per_layer"].append({"name": "later_metric", "unit": "ms", "better": "lower",
                           "source": "host_clock", "layer": "feed", "moves": "samples_per_s",
                           "workloads": ["rn50_later"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    (root / "perfbench" / "workloads" / "rn50_later.json").write_text(json.dumps(
        {"config": "rn50_simhand_w", "traffic": "pretrain_cache_fed", "chips": 1,
         "limits": {"loss_gap": 1.0}}))
    (root / "perfbench" / "metrics" / "later_metric.py").write_text(
        'UNIT = "ms"\nLAYER = "feed"\nMOVES = "samples_per_s"\n\n\n'
        'def read(ctx):\n    return 2.0 * ctx.feed_wait_s\n')
    from perfbench.run import Context, read_metrics

    spec = S.load_spec(str(root), "rn50_later")
    assert [m["name"] for m in spec.per_layer][-1] == "later_metric"
    assert "later_metric" not in [m["name"] for m in S.load_spec(str(root), "rn50_pretrain")
                                  .per_layer]
    ctx = Context(None, 1.0, 4, 4096, 2.0, 0.25, None, None)
    out = read_metrics(spec, [spec.per_layer[-1]], ctx)
    assert out == {"later_metric": {"value": 0.5, "unit": "ms"}}
