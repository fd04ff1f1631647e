"""A run of each cell, on the CPU at a tiny size (the port's plain path):
the result line's keys, the reference's agreement with the port, the
comparison's verdict with the timed path broken underneath, and the
control (the reference in bfloat16 in the program's place) refused by the
harness's own comparison.  The control at each cell's own size needs the
card (marked ``cuda``)."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
import control  # noqa: E402
import run  # noqa: E402

BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
#: every cell file, those the benchmark does not run yet included
CELLS = sorted(p.stem for p in (HERE / "cells").glob("*.json"))
SEED = 2**31 + 987654321
CONTRACT = {"correct", "attempted", "failed", "metrics", "device"}


def tiny(workload: str):
    """The cell at a size the CPU holds: its code, decoder and traffic
    unchanged but for the batch, the grouping, the points and the cap."""
    cell = json.loads((HERE / "cells" / f"{workload}.json").read_text())
    config = json.loads(
        (HERE / "configs" / f"{cell['config']}.json").read_text())
    bench, entry = BENCH, {"name": workload, "config": cell["config"],
                           "chips": 1}
    osd = cell.get("osd_lam") is not None
    cell["batch"] = 256 if osd or cell.get("relay_retries") else 128
    cell["chunks_per_group"] = 2
    cell["point_samples"] = cell["batch"] * cell["chunks_per_group"] * 4
    cell["check_groups"] = 2
    cell["trace_skip"], cell["trace_groups"] = 1, 2
    cell["decoder"]["max_iters"] = 20
    return bench, entry, cell, config


def run_tiny(workload: str, trace: bool = False, seconds: float = 0.5):
    bench, entry, cell, config = tiny(workload)
    return run.run_cell(bench, entry, cell, config, SEED, seconds, trace, "cpu")


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_the_port(workload):
    out = run_tiny(workload)
    assert out["correct"], out["checks"]
    assert out["checks"]["counter_gap"]["value"] == 0
    assert out["checks"]["lane_iter_gap"]["value"] == 0.0
    assert out["failed"] == 0 and out["attempted"] > 0


def test_result_line_keys():
    out = run_tiny("gross-ms-p01")
    assert CONTRACT <= set(out) and list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"samples_per_s", "group_ms_p95", "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    traced = run_tiny("gross-ms-p01", trace=True)
    assert CONTRACT | {"breakdown"} <= set(traced) and list(traced)[-1] == "checks"
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(traced)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_each_cell_reports_its_end_to_end_metrics(workload):
    """Those with no ``workloads`` key and those that list the cell; a
    split quantity (``samples_per_s.quality``) is its quantity's number."""
    out = run_tiny(workload)
    want = {m["name"] for m in BENCH["end_to_end"]
            if workload in m.get("workloads", [workload])}
    assert set(out["metrics"]) == want
    for name, m in out["metrics"].items():
        assert m["value"] == out["metrics"][name.split(".")[0]]["value"]


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", WORKLOADS[0], "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


# -- the timed path broken underneath -------------------------------------------

def _unchanged_state(monkeypatch):
    """Every decode returns its initial messages: no iteration runs."""
    from qec_ldpc_tpu_torch.kernels import bp_cuda, min_sum_cuda

    def bp(graph, syndrome, prior, *args, **kwargs):
        b = syndrome.shape[1]
        return (torch.full((graph.num_edges, b), float(prior)),
                torch.zeros(b, dtype=torch.int32))

    def ms(graph, syndrome, llr, *args, **kwargs):
        b = syndrome.shape[1]
        return (torch.full((graph.num_edges, b), float(llr)),
                torch.zeros(b, dtype=torch.int32))

    monkeypatch.setattr(bp_cuda, "bp_run", bp)
    monkeypatch.setattr(min_sum_cuda, "min_sum_run", ms)


def _half_batch(monkeypatch):
    """Classification counts the first half of the lanes, twice."""
    from qec_ldpc_tpu_torch.parallel import montecarlo
    orig = montecarlo.classify_batch

    def half(test, xe, ze, dx, dz, ec, valid=None):
        h = max(1, ec.shape[0] // 2)
        return 2 * orig(test, xe[:, :h], ze[:, :h], dx[:, :h], dz[:, :h],
                        ec[:h], None if valid is None else valid[:h])

    monkeypatch.setattr(montecarlo, "classify_batch", half)


def _answer_altered(monkeypatch):
    """One sample's outcome altered where it is classified: a corrected
    sample counted as a logical error (or the reverse, where none was
    corrected)."""
    from qec_ldpc_tpu_torch.parallel import montecarlo
    from qec_ldpc_tpu_torch.sampling.classify import C_CORRECTED, C_LOGICAL
    orig = montecarlo.classify_batch

    def altered(*args, **kwargs):
        c = orig(*args, **kwargs).clone()
        src, dst = ((C_CORRECTED, C_LOGICAL) if c[C_CORRECTED] > 0
                    else (C_LOGICAL, C_CORRECTED))
        if c[src] > 0:
            c[src] -= 1
            c[dst] += 1
        return c

    monkeypatch.setattr(montecarlo, "classify_batch", altered)


# The cells run on one card each: no exchange between cards to leave out.
FAULTS = {"state_unchanged": _unchanged_state, "half_batch": _half_batch,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = run_tiny(workload)
    assert not out["correct"], out["checks"]


# -- the control --------------------------------------------------------------

def test_control_is_refused_small():
    """bfloat16 in the program's place, at a size the CPU holds, judged by
    ``run.judge``: the program correct, the control not."""
    _, _, cell, config = tiny("hi610-sp-w15")
    recs = control.readings(cell, config, [11, 12, 13], 0.5, "cpu")
    for r in recs:
        assert r["program"]["correct"], r
        assert not r["control"]["correct"], r
    summary = control.summary("hi610-sp-w15", cell["limits"], recs)
    assert summary["program_correct"] and summary["control_refused"]


def test_control_is_judged_by_the_harness(monkeypatch):
    """The control's verdict is ``run.judge``'s: a comparison that passes
    everything lets the control through too."""
    _, _, cell, config = tiny("gross-ms-p01")
    real = run.judge
    monkeypatch.setattr(run, "judge", lambda *a: (real(*a)[0], True))
    recs = control.readings(cell, config, [14], 0.5, "cpu")
    assert recs[0]["control"]["correct"]


def test_witness_orders_the_arithmetic_otherwise():
    """The witness's leave-one-out products and sums and its multiply-add
    are the exact ones to float32 rounding, but not bit for bit."""
    _, ref_decoders, _ = run.reference_modules()
    g = torch.Generator().manual_seed(5)
    terms = [torch.rand(4096, generator=g) * 2 - 1 for _ in range(9)]
    for f in (ref_decoders.loo_products, ref_decoders.loo_sums):
        exact, other = torch.stack(f(terms)), torch.stack(f(terms, False))
        assert torch.allclose(exact, other, rtol=1e-5, atol=1e-6)
        assert not torch.equal(exact, other)
    a, b, c = terms[:3]
    fused = ref_decoders.mul_add(a, b, c)
    assert torch.allclose(fused, ref_decoders.mul_add(a, b, c, False),
                          rtol=1e-5, atol=1e-6)
    assert torch.equal(fused, (a.double() * b.double() + c.double()).float())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_refused_at_the_cell_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("the control at the cell's own size runs on the card")
    _, _, cell, config = run.spec_of(workload)
    recs = control.readings(cell, config, [21, 22, 23], 2.0,
                            torch.device("cuda", 0))
    for r in recs:
        assert r["program"]["correct"], r
        assert not r["control"]["correct"], r
