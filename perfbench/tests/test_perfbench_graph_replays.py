"""The reader ``driver.graph_replays_per_chunk`` on a recording and in a
CPU run of ``run.py --trace 1``, where every chunk runs eagerly."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))
import run  # noqa: E402
from test_perfbench_run import SEED, tiny  # noqa: E402

from qec_ldpc_tpu_torch import tracing  # noqa: E402

READER = HERE / "metrics" / "driver.graph_replays_per_chunk.py"


@pytest.mark.parametrize("replays,want",
                         [(2, 1.0), (1, 0.5), (0, 0.0), (None, None)])
def test_graph_replays_reader(replays, want):
    """Chunks that replayed the driver's captured graph, per chunk: 0 where
    the driver counted only eager chunks, None where nothing counted (the
    quality mode, a program without the graph path)."""
    rec = tracing.profiled()
    rec.clear()
    rec.spans += [["mc.group", 0, 1, None, None]]
    if replays is not None:
        rec.counters["mc.graph_replays"] = replays
    try:
        assert run.load(READER).read({"chunks": 2}) == want
    finally:
        rec.clear()


@pytest.mark.parametrize("workload,want",
                         [("gross-ms-p01", 0.0), ("hi610-osd-w40", None)])
def test_traced_cpu_run_reads_no_replay(workload, want):
    """On the CPU the counting cell's chunks run eagerly and read 0; the
    quality mode does not count replays."""
    tracing.profiled().clear()
    bench, entry, cell, config = tiny(workload)
    out = run.run_cell(bench, entry, cell, config, SEED, 0.5, True, "cpu")
    tracing.profiled().clear()
    assert out["correct"]
    got = out["metrics"].get("driver.graph_replays_per_chunk")
    assert (None if got is None else got["value"]) == want
