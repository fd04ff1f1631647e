"""The four examples of ``examples_torch/`` on the CPU at a tiny size: each
``main`` runs through the port alone, prints its report and returns its
numbers; the graph-parallel demo's own assertion (the (data x graph)
counters and iterations equal the data-only mesh's) holds at data=1 x
graph=2.  Without a card, the default ``--device cuda`` refuses to run
rather than fall back to the CPU."""

import numpy as np
import pytest
import torch

from examples_torch import (
    bicycle_demo,
    graph_parallel_demo,
    quality_pipeline,
    quickstart,
)
from qec_ldpc_tpu_torch.sampling import C_SYN_X, C_SYN_Z, C_TESTED

torch.set_num_threads(1)

TINY = ["--code", "3", "3", "6", "7", "2", "3"]


def test_quickstart(capsys):
    counters = quickstart.main(["--device", "cpu", *TINY, "--batch", "64",
                                "--weight", "2"])
    out = capsys.readouterr().out
    assert "code: " in out and "tested 64: corrected" in out
    assert counters[C_TESTED] == 64 and counters[3] > 0


def test_bicycle_demo(capsys):
    out = bicycle_demo.main(["[[72,12,6]]", "--device", "cpu", "--batch",
                             "64"])
    text = capsys.readouterr().out
    assert "BP alone" in text and "BP+OSD(20)" in text
    assert "BB(6,6) search" in text and len(out["hits"]) == 2
    assert out["bp"][C_TESTED] == out["bp_osd"][C_TESTED] == 64
    # OSD solves every syndrome-failed lane it is given
    assert out["bp_osd"][C_SYN_X] + out["bp_osd"][C_SYN_Z] == 0


def test_quality_pipeline(capsys):
    out = quality_pipeline.main(["4", "--device", "cpu", *TINY, "--batch",
                                 "64"])
    text = capsys.readouterr().out
    stages = ["layered BP", "+ relay(12)", "+ OSD(lam=60)"]
    assert list(out) == stages and all(s in text for s in stages)
    fails = [int(out[s][C_SYN_X] + out[s][C_SYN_Z]) for s in stages]
    assert fails[0] > 0 and fails[1] <= fails[0] and fails[2] == 0


def test_graph_parallel_demo(capsys):
    out = graph_parallel_demo.main(["--device", "cpu", "--num-data", "1",
                                    "--num-graph", "2", *TINY, "--weight",
                                    "2", "--count", "64", "--batch", "32"])
    assert "bit-match OK" in capsys.readouterr().out
    np.testing.assert_array_equal(out["data"]["counters"],
                                  out["graph"]["counters"])
    assert out["data"]["counters"][C_TESTED] == 64
    assert len(out["graph"]["launches"]) == 2


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a machine without a card")
@pytest.mark.parametrize("example", [quickstart, bicycle_demo,
                                     quality_pipeline, graph_parallel_demo],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_default_device_needs_a_card(example):
    with pytest.raises(SystemExit, match="--device cpu"):
        example.main([])
