"""The benchmark's files: BENCHMARK.json against the contract, every cell,
configuration and metric file found by its name, and the sources of the
benchmark free of JAX and of the JAX package (the reference also of the
port), compared by whole top-level module names."""

from __future__ import annotations

import ast
import importlib.util
import json
import re
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))  # the readers import pb_trace by name
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    for n in names:
        assert NAME.match(n), n
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [x["name"] for x in BENCH[kind]]
        assert len(seen) == len(set(seen)), kind
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in BENCH["configs"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + [w["why"] for w in BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert {"samples_per_s", "group_ms_p95", "setup_s"} <= set(e2e)
    for name, m in e2e.items():
        # a split quantity (``<quantity>.<cells>``) lists its cells
        assert "." not in name or m["workloads"], name
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert e2e["setup_s"]["bound"] == 0.25


def test_per_layer_metrics_have_readers():
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] == "samples_per_s"
        path = HERE / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location("reader", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.read)
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in BENCH["workloads"]}


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_and_config_files_parse(workload):
    entry = next(w for w in BENCH["workloads"] if w["name"] == workload)
    assert entry["chips"] == 1
    cell = json.loads((HERE / "cells" / f"{workload}.json").read_text())
    assert cell["name"] == workload
    assert cell["config"] == entry["config"]
    assert cell["traffic"] == entry["traffic"]
    assert cell["why"] == entry["why"]
    for key in ("error_model", "p", "decoder", "batch", "point_samples",
                "check_groups", "trace_groups", "trace_skip", "limits"):
        assert key in cell, key
    conf = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"]
    assert data["source"] == conf["source"]
    assert data["reduced"] == conf["reduced"] == []


@pytest.mark.parametrize("name", sorted(p.stem for p in
                                         (HERE / "cells").glob("*.json")))
def test_every_cell_file_parses(name):
    """Cell files the benchmark does not run yet are whole too, so that a
    later benchmark change adds the workload entry alone."""
    cell = json.loads((HERE / "cells" / f"{name}.json").read_text())
    assert cell["name"] == name and NAME.match(cell["traffic"])
    assert 1 <= len(cell["why"]) <= 200
    assert (HERE / "configs" / f"{cell['config']}.json").exists()
    assert set(cell["limits"]) == {"counter_gap", "lane_iter_gap"}


def test_every_config_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def _top_level_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(str(p.relative_to(HERE))
                                        for p in HERE.rglob("*.py")))
def test_no_jax_imports(path):
    names = _top_level_imports(HERE / path)
    assert not names & {"jax", "jaxlib", "flax", "qec_ldpc_tpu"}, names
    if path.startswith("reference"):
        assert "qec_ldpc_tpu_torch" not in names, names


def test_no_file_name_starts_with_underscore():
    for p in HERE.rglob("*"):
        if "__pycache__" not in p.parts:
            assert not p.name.startswith("_"), p
