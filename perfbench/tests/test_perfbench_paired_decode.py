"""The reader ``decode.paired_per_chunk`` on a recording and in a CPU run
of ``run.py --trace 1``, where every chunk decodes one graph a launch."""

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

READER = HERE / "metrics" / "decode.paired_per_chunk.py"


@pytest.mark.parametrize("paired,want",
                         [(4, 1.0), (1, 0.25), (0, 0.0), (None, None)])
def test_paired_reader(paired, want):
    """Chunks decoded by one launch, per chunk: 1.0 where every chunk
    pairs, None where nothing counted (a program without the pair)."""
    rec = tracing.profiled()
    rec.clear()
    rec.spans += [["mc.group", 0, 1, None, None]]
    if paired is not None:
        rec.counters["decode.paired"] = paired
    try:
        assert run.load(READER).read({"chunks": 4}) == want
    finally:
        rec.clear()


@pytest.mark.parametrize("workload", ["gross-ms-p01", "bb756-osd-p10"])
def test_traced_cpu_run_reads_zero(workload):
    """On the CPU the lifted cells' chunks decode one graph a launch, in
    the counting path and in the quality mode alike: the reader reads 0."""
    tracing.profiled().clear()
    bench, entry, cell, config = tiny(workload)
    out = run.run_cell(bench, entry, cell, config, SEED, 0.5, True, "cpu")
    tracing.profiled().clear()
    assert out["correct"]
    assert out["metrics"]["decode.paired_per_chunk"]["value"] == 0.0
