"""The reader ``classify.fused_per_chunk`` on a recording and in a CPU run
of ``run.py --trace 1``, where every counting chunk takes the unfused
path."""

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

READER = HERE / "metrics" / "classify.fused_per_chunk.py"


@pytest.mark.parametrize("fused,want",
                         [(2, 1.0), (1, 0.5), (0, 0.0), (None, None)])
def test_fused_reader(fused, want):
    """Chunks counted by the fused kernel, per chunk: 1.0 where every chunk
    counts, None where nothing counted (the quality mode, a program
    without the kernel)."""
    rec = tracing.profiled()
    rec.clear()
    rec.spans += [["mc.group", 0, 1, None, None]]
    if fused is not None:
        rec.counters["classify.fused"] = fused
    try:
        assert run.load(READER).read({"chunks": 2}) == want
    finally:
        rec.clear()


@pytest.mark.parametrize("workload,want",
                         [("gross-ms-p01", 0.0), ("hi610-sp-w15", 0.0),
                          ("hi610-osd-w40", None)])
def test_traced_cpu_run_reads_what_the_cpu_path_counts(workload, want):
    """On the CPU the counting cells' chunks take the unfused path and
    count 0; the quality mode does not count."""
    tracing.profiled().clear()
    bench, entry, cell, config = tiny(workload)
    out = run.run_cell(bench, entry, cell, config, SEED, 0.5, True, "cpu")
    tracing.profiled().clear()
    assert out["correct"]
    got = out["metrics"].get("classify.fused_per_chunk")
    assert (None if got is None else got["value"]) == want
