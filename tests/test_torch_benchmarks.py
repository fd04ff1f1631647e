"""The port's single-device benchmark scripts (``benchmarks_torch/``) on the
CPU at their smallest size: each record carries the JAX record's keys
(read from the JAX package's committed records), plus the card's name and
power limit and the keys listed here, with the TPU-only keys null; every
in-run gate passes; nothing is written under the JAX package's
``benchmarks/``; ``large_code_real`` records only a device out-of-memory
error as a wall and re-raises any other; ``throughput``'s fixed-work
counts equal ``bench_torch``'s on the same seed and the count a
one-iteration decode predicts; the op models and the JAX comm model are
the JAX package's own; the FP32 probe's gate holds the timed call."""

import ast
import contextlib
import io
import json
from pathlib import Path

import pytest
import torch

import bench_torch
from benchmarks_torch import (
    bicycle_ler,
    common,
    dynamic_weight_real,
    large_code_real,
    large_code_scaling,
    relay_tuning,
    roofline_breakdown,
    scaling,
    sharded_step_bench,
    throughput,
)
from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.decoder import (
    CONVERGENCE_FAIL_X,
    CONVERGENCE_FAIL_Z,
    BPConfig,
    CodeGraphs,
    decode_batch,
)
from qec_ldpc_tpu_torch.parallel.montecarlo import (
    chunk_generator,
    sample_syndromes,
)
from qec_ldpc_tpu_torch.sampling import classify_batch, make_rank_basis_test

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
JAX_DATA = ROOT / "benchmarks"
CARD = {"device_kind", "power_limit"}


def jax_keys(relative: str, line: int) -> set:
    """The keys of line ``line`` (1-based) of a JAX package record."""
    with open(JAX_DATA / relative) as f:
        return set(json.loads(f.read().splitlines()[line - 1]))


def snapshot(root: Path) -> dict:
    return {str(p): (p.stat().st_size, p.stat().st_mtime_ns)
            for p in root.rglob("*") if p.is_file()}


@pytest.fixture(scope="module")
def jax_records_before():
    return snapshot(JAX_DATA)


def lines(path: Path) -> list:
    return [json.loads(x) for x in path.read_text().splitlines()]


def run_quiet(fn, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(**kwargs)


def check_record(rec: dict, jax: set, added: set = frozenset(),
                 tpu_only: set = frozenset()) -> None:
    assert set(rec) == jax | CARD | added, set(rec) ^ (jax | CARD | added)
    assert rec["device_kind"] == "cpu" and rec["power_limit"] is None
    for key in tpu_only:
        assert rec[key] is None, key


@pytest.fixture(scope="module")
def throughput_run(tmp_path_factory, jax_records_before):
    out = tmp_path_factory.mktemp("tp") / "throughput.jsonl"
    records = run_quiet(throughput.main, device="cpu", batch=128, chunks=1,
                        repeats=1, out=str(out))
    return records, out


def test_throughput_keys(throughput_run):
    records, out = throughput_run
    written = lines(out)
    assert [r["algorithm"] for r in written] == list(throughput.ALGORITHMS)
    for rec in written:
        check_record(rec, jax_keys("results/throughput_matrix_r4.jsonl", 1),
                     {"executed_lane_iters", "counters"})
        assert rec["kernel"] == "plain"
        # every lane ran 100 iterations or stopped after the first
        assert rec["executed_lane_iters"] % 99 == (2 * 128 * 100) % 99


def test_throughput_counts_equal_bench_torch(throughput_run, monkeypatch):
    """bench_torch's fixed-work runs on the same seed, batch and chunks
    execute the same lane-iterations to the same counters."""
    records, _ = throughput_run
    seen = []
    real = bench_torch.fixed_work_rate

    def capture(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append((args[2], out[1], out[2].tolist()))
        return out

    monkeypatch.setattr(bench_torch, "fixed_work_rate", capture)
    run_quiet(bench_torch.main, device="cpu", batch=128, headline_chunks=1,
              fixed_chunks=1, small_batch=128, small_chunks=1,
              gross_chunks=1, repeats=1)
    assert seen == [(r["algorithm"], r["executed_lane_iters"], r["counters"])
                    for r in records]


def test_throughput_executes_the_first_test_count(throughput_run):
    """The executed lane-iterations are what the first iteration's test
    predicts, and the counters are the classified full decode's, rebuilt
    from the chunk's samples.  On the CPU the plain loops run a graph's
    lanes together: ``iters`` loop iterations over the batch, or one when
    every lane passes that test (none for layered, which tests no sweep at
    fixed work); k, the lanes that pass it, comes from a one-iteration
    decode of the same samples.  (The kernels exit per lane instead:
    ``common.fixed_work_rate`` gates ``iters`` or 1 per lane on the
    card.)"""
    records, _ = throughput_run
    graphs = CodeGraphs.build(construct_code(4, 5, 10, 61, 9, 49))
    test = make_rank_basis_test(graphs.code, "cpu")
    iters, batch = 100, 128
    xe, ze, sx, sz = sample_syndromes(graphs, chunk_generator(0, 0, "cpu"),
                                      15, 0.01, batch, "weight")
    for rec in records:
        algo = rec["algorithm"]
        if algo == "layered-min-sum":
            k = [0, 0]
        else:
            one = decode_batch(graphs, sx, sz, 0.01, BPConfig(
                max_iters=1, algorithm=algo))
            k = [int(((one.error_code & bit) == 0).sum())
                 for bit in (CONVERGENCE_FAIL_X, CONVERGENCE_FAIL_Z)]
            assert 0 < sum(k)
        assert rec["executed_lane_iters"] == sum(
            batch * (1 if k_g == batch else iters) for k_g in k)
        full = decode_batch(graphs, sx, sz, 0.01, BPConfig(
            max_iters=iters, check_every=iters + 1,
            layered_check_every=iters + 1, algorithm=algo))
        counters = classify_batch(test, xe, ze, full.decisions_x.to(xe.dtype),
                                  full.decisions_z.to(ze.dtype),
                                  full.error_code)
        assert rec["counters"] == counters.tolist()


@pytest.mark.parametrize("spec", [(4, 5, 10, 61, 9, 49), (3, 3, 6, 7, 2, 3)])
def test_op_models_equal_bench_py(spec):
    """The fixed-work op models are bench.py's on the same code."""
    import bench
    from qec_ldpc_tpu.codes import construct_code as jax_construct_code
    from qec_ldpc_tpu.decoder import CodeGraphs as JaxCodeGraphs

    port = CodeGraphs.build(construct_code(*spec))
    jax_graphs = JaxCodeGraphs.build(jax_construct_code(*spec))
    models = {"sum-product": bench.bp_flops_per_iter_sample,
              "min-sum": bench.min_sum_flops_per_iter_sample,
              "layered-min-sum": bench.layered_flops_per_sweep_sample}
    assert set(common.FLOP_MODELS) == set(models)
    for algo, model in models.items():
        assert common.FLOP_MODELS[algo](port) == model(jax_graphs), algo


def jax_comm_functions() -> dict:
    """The JAX script's own ``qc_comm`` and ``bb_comm`` (nested in its
    ``main``), compiled from its source."""
    source = (JAX_DATA / "large_code_scaling.py").read_text()
    found = {node.name: node for node in ast.walk(ast.parse(source))
             if isinstance(node, ast.FunctionDef)
             and node.name in ("qc_comm", "bb_comm")}
    assert set(found) == {"qc_comm", "bb_comm"}
    return {name: compile(ast.Module(body=[node], type_ignores=[]),
                          "benchmarks/large_code_scaling.py", "exec")
            for name, node in found.items()}


@pytest.mark.parametrize("spec, shards", [
    ((4, 5, 10, 521, 25, 1), (1, 2, 5)),
    ((3, 3, 6, 7, 2, 3), (1, 2, 3, 6)),
    ("[[756,16,34]]", (1, 3, 7)),
    ("[[72,12,6]]", (1, 2, 3)),
])
def test_jax_comm_model_is_the_jax_scripts(spec, shards):
    """``large_code_scaling.jax_comm_model`` gives what the JAX script's
    ``qc_comm`` / ``bb_comm`` give on the same code and shard counts, at
    its 16 lanes."""
    from qec_ldpc_tpu.codes import construct_code as jax_construct_code
    from qec_ldpc_tpu.codes import known_bicycle_code as jax_bicycle_code
    from qec_ldpc_tpu.decoder import CodeGraphs as JaxCodeGraphs

    port = common.graphs_of(spec)
    if isinstance(spec, str):
        scope = {"bb_graphs": jax_bicycle_code(spec).build_graphs()}
        name = "bb_comm"
    else:
        J, K, L, P = spec[:4]
        JaxCodeGraphs.build(jax_construct_code(*spec))  # the same code
        scope = {"B_x": J, "B_z": K, "L": L, "Pc": P}
        name = "qc_comm"
    exec(jax_comm_functions()[name], scope)
    for ng in shards:
        assert large_code_scaling.jax_comm_model(port, ng) == scope[name](
            1, ng), ng


def test_jax_comm_model_equals_the_jax_record():
    """At the JAX script's shapes the model gives its committed record's
    comm keys."""
    graphs = {"qc_P521": common.graphs_of((4, 5, 10, 521, 25, 1)),
              "bb": common.graphs_of("[[756,16,34]]")}
    rows = [r for r in common.jax_records(
        "data/large_code_scaling_r3.jsonl") if "num_graph" in r]
    assert len(rows) == 6
    for row in rows:
        model = large_code_scaling.jax_comm_model(
            graphs[row["code"].split()[0].split("_[")[0]], row["num_graph"])
        assert model == {k: row[k] for k in model}, row["code"]


def test_dynamic_weight_real(tmp_path, jax_records_before):
    out = tmp_path / "dw.jsonl"
    run_quiet(dynamic_weight_real.main, device="cpu", w_max=3, count=64,
              batch=64, probes=(1, 3), out=str(out))
    meta, dynamic, probe1, probe3, summary = lines(out)
    rel = "data/dynamic_weight_real_r5.jsonl"
    check_record(meta, jax_keys(rel, 1))
    check_record(dynamic, jax_keys(rel, 2), tpu_only={"compiled_programs"})
    check_record(probe1, jax_keys(rel, 3), {"seconds"},
                 {"seconds_incl_compile"})
    # the cap's probe: the draws equal the static sampler's (gated in-run)
    check_record(probe3, jax_keys(rel, 6), {"seconds"},
                 {"seconds_incl_compile"})
    assert probe3["counters_bit_equal"] and probe3["bit_identical_draws"]
    assert probe3["counters_static"] == probe3["counters_dynamic"]
    check_record(summary, jax_keys(rel, 7))


def test_relay_tuning(tmp_path, jax_records_before):
    out = tmp_path / "relay.jsonl"
    run_quiet(relay_tuning.main, device="cpu",
              workloads=("qc42_W3", "bb72_p0.05"), ranges=((0.2, 0.95),),
              seeds=(3,), batch=64, out=str(out))
    meta, qc, bb = lines(out)
    rel = "data/relay_tuning_r4.jsonl"
    check_record(meta, jax_keys(rel, 1))
    for rec in (qc, bb):
        check_record(rec, jax_keys(rel, 2))
    # the [[42]] code at W=3 leaves failures for the relay to repair
    assert qc["bp_failures"] > 0 and qc["unrepaired"] <= qc["bp_failures"]


@pytest.mark.parametrize("failures,unrepaired,passes", [
    (18 * 192, 0, True), (60 * 192, 0, False), (18 * 192, 9 * 192, False)])
def test_relay_tuning_gate(monkeypatch, tmp_path, failures, unrepaired,
                           passes):
    """Each record is held to the JAX package's row of its code and range:
    the BP failure rate and the repair rate within |z| < 4 (here a row
    standing in for the [[42]] code's: its 18 failures of 64 repaired, at
    192 times the count; then a failure rate and a repair rate far off)."""
    row = dict(relay_tuning.jax_row("qc610_W40", 0.2, 0.95))
    row.update(seeds=192, batch_per_seed=64, bp_failures=failures,
               unrepaired=unrepaired)
    monkeypatch.setattr(relay_tuning, "jax_row", lambda *a: row)
    run = lambda: run_quiet(  # noqa: E731
        relay_tuning.main, device="cpu", workloads=("qc42_W3",),
        ranges=((0.2, 0.95),), seeds=(3,), batch=64,
        out=str(tmp_path / "relay.jsonl"))
    if passes:
        run()
    else:
        with pytest.raises(AssertionError, match="against the JAX record"):
            run()


def test_bicycle_ler(tmp_path, jax_records_before):
    out = tmp_path / "bb.jsonl"
    run_quiet(bicycle_ler.main, device="cpu", ps=(0.01,), count=256,
              batch=128, out=str(out))
    run_quiet(bicycle_ler.main, device="cpu", code="[[72,12,6]]", ps=(0.05,),
              count=128, batch=64, relay=8, osd=0, out=str(out) + ".2")
    (gross,), (small,) = lines(out), lines(Path(str(out) + ".2"))
    for rec in (gross, small):
        check_record(rec, jax_keys("results/bicycle_gross_r3.jsonl", 1))
    assert gross["mode"] == "min-sum"
    assert small["mode"] == "min-sum+relay8+osd0"
    # OSD solves every lane's syndrome
    assert small["syndrome_fail_fraction"] == 0.0


def test_sharded_step_bench(tmp_path, jax_records_before):
    out = tmp_path / "step.jsonl"
    run_quiet(sharded_step_bench.main, device="cpu", batches=(8,), iters=2,
              out=str(out))
    meta, *recs = lines(out)
    rel = "data/sharded_step_bench_r5.jsonl"
    check_record(meta, jax_keys(rel, 1))
    assert [r["code"] for r in recs] == ["P521 shard g=0 of G=2",
                                         "P61 shard g=0 of G=2"]
    for rec in recs:
        check_record(rec, jax_keys(rel, 2), tpu_only={
            "compile_s_pallas", "compile_s_xla_lane_layout",
            "compile_s_xla_engine_body", "ms_per_iter_xla_lane_layout",
            "speedup_vs_lane_layout"})
        assert rec["bit_equal_all_three"] is True


@pytest.fixture(scope="module")
def large_code_real_run(tmp_path_factory, jax_records_before):
    out = tmp_path_factory.mktemp("lcr") / "lcr.jsonl"
    run_quiet(large_code_real.main, device="cpu", qc=(61,), bb=False,
              probes=(61,), batch=64, chunks=1, probe_iters=5, repeats=1,
              out=str(out))
    return lines(out)


def test_large_code_real_keys(large_code_real_run):
    meta, fixed, early, probe_fixed, probe_early, probe = large_code_real_run
    rel = "data/large_code_real_r5.jsonl"
    check_record(meta, jax_keys(rel, 1))
    for rec in (fixed, early, probe_fixed, probe_early):
        # the memory keys of the JAX script's mem_stats
        # (benchmarks/large_code_real.py:116-122), absent from its records
        # where the TPU runtime gave no memory_stats
        check_record(rec, jax_keys(rel, 2),
                     {"placement", "bytes_in_use", "peak_bytes_in_use"},
                     {"kernel_tile_batch", "compile_seconds_approx"})
        assert rec["placement"] is None  # a card's plan
        assert rec["bytes_in_use"] is None  # a card's memory
    assert (fixed["fixed_work"], early["fixed_work"]) == (True, False)
    assert probe_fixed["code"] == "qc_P61_probe"
    check_record(probe, jax_keys(rel, 20), {"bit_equal_plain"})
    assert probe["ok"] and probe["bit_equal_plain"]


def test_large_code_real_reraises_errors(monkeypatch, tmp_path):
    """A failed launch is not a wall: the run raises and writes nothing."""
    def launcher(*args, **kwargs):
        raise RuntimeError("qec_min_sum failed: cudaError_t 1")

    monkeypatch.setattr(common, "mc_chunk", launcher)
    out = tmp_path / "lcr.jsonl"
    with pytest.raises(RuntimeError, match="cudaError_t"):
        run_quiet(large_code_real.main, device="cpu", qc=(61,), bb=False,
                  probes=(), batch=64, chunks=1, repeats=1, out=str(out))
    assert not out.exists()


def test_large_code_real_records_out_of_memory(monkeypatch, tmp_path):
    """A device out-of-memory error is the one-card wall: recorded, and the
    run goes on."""
    def launcher(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(common, "mc_chunk", launcher)
    out = tmp_path / "lcr.jsonl"
    run_quiet(large_code_real.main, device="cpu", qc=(61,), bb=False,
              probes=(61,), batch=64, chunks=1, probe_iters=2, repeats=1,
              out=str(out))
    _, code, probe = lines(out)
    assert code == {"code": "qc_P61_[[610,61]]", "ok": False,
                    "error": "OutOfMemoryError: CUDA out of memory",
                    "device_kind": "cpu", "power_limit": None}
    # the JAX record's failed-probe keys
    assert set(probe) == {"probe_P", "n", "kernel", "ok", "error"} | CARD
    assert probe["ok"] is False


def test_roofline_breakdown(tmp_path, jax_records_before):
    out = tmp_path / "roof.jsonl"
    run_quiet(roofline_breakdown.main, device="cpu", chain_n=1024, depth=4,
              reps=2, batch=64, chunks=1, iters=20, stream_n=4096, passes=4,
              repeats=1, out=str(out))
    meta, peak, sp, ms, ly, check, hbm = lines(out)
    rel = "data/roofline_breakdown_r4.jsonl"
    check_record(meta, jax_keys(rel, 1))
    check_record(peak, jax_keys(rel, 2), {"datasheet_fp32_flops_per_s"},
                 {"nominal_issue_slots_per_s"})
    assert [r["algorithm"] for r in (sp, ms, ly)] == [
        "sum-product", "min-sum", "layered-min-sum"]
    for rec in (sp, ms, ly):
        check_record(rec, jax_keys(rel, 3))
    check_record(check, jax_keys(rel, 7))
    check_record(hbm, jax_keys(rel, 8), {"datasheet_bytes_per_s"})
    # no rows for the TPU-only experiments (mxu routing, Pallas tile)
    assert {r["experiment"] for r in (peak, sp, check, hbm)} == {
        "peak_reality", "achieved", "convergence_check", "hbm_bandwidth"}


@pytest.mark.parametrize("fault", ["one_application_short", "last_element"])
def test_roofline_peak_gate_holds_the_timed_call(monkeypatch, tmp_path,
                                                 fault):
    """The probe's gate compares the timed call itself, whole grid and
    whole chain: a probe one application short, or wrong in its last
    element, stops the run."""
    real = roofline_breakdown.peak_chain

    def faulty(x, op, depth, reps, a, b):
        if fault == "one_application_short":
            return real(x, op, depth * reps - 1, 1, a, b)
        y = real(x, op, depth, reps, a, b).clone()
        y[-1] = 0.0
        return y

    monkeypatch.setattr(roofline_breakdown, "peak_chain", faulty)
    out = tmp_path / "roof.jsonl"
    with pytest.raises(AssertionError, match="peak_chain fma differs"):
        run_quiet(roofline_breakdown.main, device="cpu",
                  experiments=("peak",), chain_n=1024, depth=4, reps=2,
                  repeats=1, out=str(out))
    assert not out.exists()


def test_out_path_refuses_the_jax_records():
    with pytest.raises(ValueError, match="JAX package"):
        common.out_path("throughput", JAX_DATA / "data" / "x.jsonl")
    assert common.out_path("throughput") == (
        ROOT / "benchmarks_torch" / "data" / "throughput_h100.jsonl")


def test_nothing_written_under_the_jax_records(jax_records_before,
                                               throughput_run,
                                               large_code_real_run):
    assert snapshot(JAX_DATA) == jax_records_before


def test_card_is_required_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for script in (throughput, dynamic_weight_real, relay_tuning,
                   bicycle_ler, sharded_step_bench, large_code_real,
                   roofline_breakdown, scaling, large_code_scaling):
        with pytest.raises(SystemExit, match="is_available"):
            script.main()
