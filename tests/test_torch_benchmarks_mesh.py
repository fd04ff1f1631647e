"""The port's multi-rank benchmark scripts on gloo CPU ranks: ``scaling``
at 1 and 2 data ranks, and ``large_code_scaling`` on the [[42]] circulant
code at (1,1) and (1,2) and on [[72,12,6]] at (1,1) and (1,3).  Each
script's ``main`` spawns its own worlds (``parallel/mesh.py::spawn``), one
per rank count: three worlds in all, ~4 s each.  The records carry the JAX
records' keys; the counters and lane-iterations are equal across mesh
shapes, exactly (gated in-run); the all_gather bytes each record reports
are what the rank's ``Mesh`` counted, which for the circulant engine is
one (min; sign) partials gather per loop iteration and one decisions
gather per graph, and for the lifted engine two all_gathers per loop
iteration and six a chunk."""

import contextlib
import io
import json
from pathlib import Path

import pytest
import torch

from benchmarks_torch import large_code_scaling, scaling

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CARD = {"device_kind", "power_limit"}
#: the keys of the JAX script's record (``benchmarks/scaling.py:102-112``;
#: the JAX package committed no scaling record)
SCALING_KEYS = {"metric", "devices", "platform", "bp_iter_codewords_per_s",
                "samples_per_s", "speedup_vs_base", "parallel_efficiency",
                "unit"}
RUN_ADDED = {"loop_iterations", "all_gathers_per_dev",
             "all_gather_bytes_recv_per_dev",
             "all_gather_bytes_recv_per_dev_per_iter", "launches_rank0"}


def jax_lines(relative: str) -> list:
    path = ROOT / "benchmarks" / relative
    return [json.loads(x) for x in path.read_text().splitlines()]


def lines(path: Path) -> list:
    return [json.loads(x) for x in path.read_text().splitlines()]


@pytest.fixture(scope="module")
def scaling_records(tmp_path_factory):
    out = tmp_path_factory.mktemp("scaling") / "scaling.jsonl"
    with contextlib.redirect_stdout(io.StringIO()):
        scaling.main(device="cpu", devices=[1, 2], iters=20,
                     batch_per_device=64, chunks=1, repeats=1, out=str(out))
    return lines(out)


@pytest.fixture(scope="module")
def scaling_shapes(tmp_path_factory):
    out = tmp_path_factory.mktemp("lcs") / "lcs.jsonl"
    with contextlib.redirect_stdout(io.StringIO()):
        large_code_scaling.main(
            device="cpu", codes=("qc_P7", "bb_72"),
            shapes={"qc_P7": ((1, 1), (1, 2)), "bb_72": ((1, 1), (1, 3))},
            out=str(out))
    return lines(out)


def test_scaling_records(scaling_records):
    one, two = scaling_records
    for rec in (one, two):
        assert set(rec) == SCALING_KEYS | CARD | {"note", "launches_rank0"}
        assert rec["platform"] == "cpu" and rec["device_kind"] == "cpu"
        assert rec["power_limit"] is None
        assert rec["launches_rank0"] == 0  # the plain path launches nothing
    assert (one["devices"], two["devices"]) == (1, 2)
    assert one["speedup_vs_base"] == 1.0 and one["parallel_efficiency"] == 1.0
    # both rounded: the speedup to 0.01, the efficiency to 0.001
    assert two["parallel_efficiency"] == pytest.approx(
        two["speedup_vs_base"] / 2, abs=0.0026 + 0.0005)
    assert "gloo CPU ranks" in two["note"]


def test_large_code_scaling_keys(scaling_shapes):
    meta, *runs = scaling_shapes
    rel = jax_lines("data/large_code_scaling_r3.jsonl")
    assert set(meta) == set(rel[0]) | CARD
    qc = [r for r in runs if "memory_model" not in r and "P=7" in r["code"]]
    bb = [r for r in runs if "memory_model" not in r and "[[n=72" in r["code"]]
    assert [(r["num_data"], r["num_graph"]) for r in qc] == [(1, 1), (1, 2)]
    assert [(r["num_data"], r["num_graph"]) for r in bb] == [(1, 1), (1, 3)]
    for rec in qc:
        assert set(rec) == set(rel[1]) | CARD | RUN_ADDED
    for rec in bb:
        assert set(rec) == set(rel[4]) | CARD | RUN_ADDED
    memory = [r["memory_model"] for r in runs if "memory_model" in r]
    assert len(memory) == 3
    for row in memory:
        assert set(row) == set(rel[7]["memory_model"]) | {
            "device_memory_bytes", "min_sum_plan"}
        for key in ("kernel_vmem_bytes_at_tile", "kernel_fits_vmem_at_tile128",
                    "device_memory_bytes", "min_sum_plan"):
            assert row[key] is None, key


def test_counters_equal_across_shapes(scaling_shapes):
    runs = [r for r in scaling_shapes[1:] if "memory_model" not in r]
    for name in ("P=7", "[[n=72"):
        shaped = [r for r in runs if name in r["code"]]
        assert len(shaped) == 2
        assert shaped[0]["counters"] == shaped[1]["counters"]
        assert shaped[0]["lane_iters"] == shaped[1]["lane_iters"]
        assert shaped[0]["counters"][0] == 16


def test_all_gather_bytes(scaling_shapes):
    runs = [r for r in scaling_shapes[1:] if "memory_model" not in r]
    (qc1, qc2), (bb1, bb3) = ([r for r in runs if name in r["code"]]
                              for name in ("P=7", "[[n=72"))
    for rec in (qc1, bb1):
        assert rec["all_gathers_per_dev"] == 0
        assert rec["all_gather_bytes_recv_per_dev"] == 0
    # the [[42]] code: B = 3 block rows in both graphs, L = 6, P = 7; 16
    # lanes; at G = 2 each loop iteration gathers a graph's float32 (min;
    # sign) partials (2*B*P, 16) from the other rank, and each graph's int8
    # decisions (L/G*P, 16) once
    B, Lc, P, lanes, G = 3, 3, 7, 16, 2
    loops = qc2["loop_iterations"]
    assert qc2["all_gathers_per_dev"] == loops + 2
    assert qc2["all_gather_bytes_recv_per_dev"] == (G - 1) * (
        loops * 2 * B * P * lanes * 4 + 2 * Lc * P * lanes)
    assert qc2["all_gather_bytes_recv_per_dev_per_iter"] == pytest.approx(
        qc2["all_gather_bytes_recv_per_dev"] / loops, abs=0.1)
    # the lifted engine: one all_gather a routing, two a loop iteration,
    # and six a chunk
    assert bb3["all_gathers_per_dev"] == 2 * bb3["loop_iterations"] + 6
    assert bb3["all_gather_bytes_recv_per_dev"] > 0
    # the JAX package's analytic figure stays its own
    assert bb3["halo_bytes_recv_per_dev_per_iter_upper"] != bb3[
        "all_gather_bytes_recv_per_dev_per_iter"]
