"""The port's reference-corpus scripts (``benchmarks_torch/golden_sweep``,
``golden_sweep42``, ``golden_deep``, ``golden_dated``, ``ler_sweep``)
against the JAX package's, on the CPU:

* the copied statistics equal the JAX scripts' on a grid of counts;
* ``common.reference_points`` gives, for every point of each JAX record,
  the record's reference counts (fraction-only records rounded back to
  whole counts), and the same points from a corpus-format directory
  written here with ``to_reference_text`` (``--ref-dir``);
* one chunk's nine counters through the port's body (syndromes, plain
  decode, classification) equal JAX's (``decode_batch`` through XLA,
  ``classify_batch``) exactly on shared NumPy-seeded errors, on [[42,0]],
  the J=2 [[42,7]] code and [[610,61]], at each corpus cap and prior, and
  the merged-logical comparison of golden_dated on both;
* each script's ``main`` at a tiny cut with ``device="cpu"`` writes records
  whose keys are the JAX record's plus the card's name, its power limit
  and ``ref_source``, and passes its in-run gates.

Codes come from ``construct_code``; nothing reads the reference corpus.
"""

import ast
import contextlib
import io
import json
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import golden_dated as jax_golden_dated
from benchmarks import golden_deep as jax_golden_deep
from benchmarks_torch import (
    common,
    golden_dated,
    golden_deep,
    golden_sweep,
    golden_sweep42,
    ler_sweep,
)
from qec_ldpc_tpu.codes import construct_code as jax_construct_code
from qec_ldpc_tpu.decoder import BPConfig as JaxBPConfig
from qec_ldpc_tpu.decoder import CodeGraphs as JaxCodeGraphs
from qec_ldpc_tpu.decoder import decode_batch as jax_decode_batch
from qec_ldpc_tpu.sampling import classify_batch as jax_classify_batch
from qec_ldpc_tpu.sampling.classify import (
    make_rank_basis_test as jax_make_rank_basis_test,
)
from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.decoder import BPConfig, CodeGraphs, decode_batch
from qec_ldpc_tpu_torch.harness.stats import CodeStatistics
from qec_ldpc_tpu_torch.sampling import classify_batch, make_rank_basis_test

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
JAX_DATA = ROOT / "benchmarks"
SCRIPTS = ("golden_sweep", "golden_sweep42", "golden_deep", "golden_dated",
           "ler_sweep")
ADDED = {"device_kind", "power_limit", "ref_source"}


def records(relative: str) -> list:
    return common.jax_records(relative)


# -- the statistics --------------------------------------------------------------

BINOM_GRID = [(0, 0, 0.5), (0, 5, 0.3), (3, 10, 0.5), (1, 101, 0.0909),
              (7, 40, 0.9), (1, 100001, 100000 / 1148576),
              (209, 1267, 100000 / 1148576), (0, 12, 0.0), (12, 12, 1.0)]
RATE_GRID = [(1, 100000, 11, 1048576), (0, 10000, 0, 1048576),
             (40, 10000, 4114, 1048576), (5, 100000, 3, 10240),
             (4831, 10000, 50000, 102400)]
CI_GRID = [0, 1, 2, 6, 11, 80, 1000]
Z_GRID = [(9998, 10000, 10238, 10240), (100000, 100000, 1048576, 1048576),
          (0, 100000, 0, 1048576), (5, 100000, 0, 10240),
          (65204, 100000, 79, 128)]


def close(a: float, b: float) -> bool:
    return a == b or math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0)


@pytest.mark.parametrize("k,n,p", BINOM_GRID)
def test_binom_test_is_the_jax_scripts(k, n, p):
    assert close(golden_deep.binom_test_two_sided(k, n, p),
                 jax_golden_deep.binom_test_two_sided(k, n, p))


@pytest.mark.parametrize("counts", RATE_GRID)
def test_rate_parity_pvalue_is_the_jax_scripts(counts):
    assert close(golden_deep.rate_parity_pvalue(*counts),
                 jax_golden_deep.rate_parity_pvalue(*counts))


@pytest.mark.parametrize("k", CI_GRID)
def test_poisson_ci_is_the_jax_scripts(k):
    for a, b in zip(golden_deep.poisson_ci(k), jax_golden_deep.poisson_ci(k)):
        assert close(a, b)


@pytest.mark.parametrize("counts", Z_GRID)
def test_z_is_golden_dated_s(counts):
    assert close(golden_deep._z(*counts), jax_golden_dated._z(*counts))


# -- the reference reader --------------------------------------------------------

def expected_points(script: str) -> list:
    """The reference's side of each JAX record point, read here directly:
    (weight, cap, p, counts, section, code, file)."""
    relative, fields = common.REFERENCE[script]
    if script == "ler_sweep":
        relative = common.REFERENCE["golden_sweep"][0]
    out, seen = [], set()
    for r in records(relative)[1:]:
        n = r["ref_tested"]
        counts = {}
        for f in fields:
            if f == "tested":
                counts[f] = n
            elif f"ref_{f}" in r:
                counts[f] = r[f"ref_{f}"]
            else:
                exact = r[f"ref_{f}_fraction"] * n
                assert abs(exact - round(exact)) < 1e-6, (r, f)
                counts[f] = round(exact)
        point = (r["weight"], r.get("max_iters"),
                 r.get("p", r.get("p_label")), counts, r.get("section"),
                 common.parse_code_params(r["code"])
                 if script == "golden_dated" else None, r.get("file"))
        key = str(point)
        if key not in seen:
            seen.add(key)
            out.append(point)
    return out


@pytest.mark.parametrize("script", SCRIPTS)
def test_reference_points_are_the_records(script):
    points, source = common.reference_points(script)
    assert [tuple(pt) for pt in points] == expected_points(script)
    relative = common.REFERENCE[
        "golden_sweep" if script == "ler_sweep" else script][0]
    assert source == f"benchmarks/{relative}"
    # every corpus point: 122 [[610]] points, 58 of [[42,0]], the
    # seven deep weights, 81 + 15 + 20 dated points
    assert len(points) == {"golden_sweep": 122, "golden_sweep42": 58,
                           "golden_deep": 7, "golden_dated": 116,
                           "ler_sweep": 122}[script]


def test_fraction_records_round_to_counts_in_both_depths():
    """Both golden_sweep42 records carry the same reference fractions; each
    times 100,000 is a whole count within 1e-6."""
    r4 = {(r["weight"], r["max_iters"]): r
          for r in records("data/golden_sweep42_r4.jsonl")[1:]}
    points, _ = common.reference_points("golden_sweep42")
    assert len(r4) == len(points)
    for pt in points:
        rec = r4[(pt.weight, pt.max_iters)]
        for f in ("corrected", "logical", "syn_x", "conv_x"):
            exact = rec[f"ref_{f}_fraction"] * rec["ref_tested"]
            assert abs(exact - pt.counts[f]) < 1e-6


def test_ler_sweep_reads_the_42_code_from_its_sweep_record():
    points, source = common.reference_points("ler_sweep", code=common.CODE42)
    assert source == "benchmarks/data/golden_sweep42_deep_r5.jsonl"
    assert ler_sweep.reference_fractions(points, 10, 100, 0.02) == (
        5 / 100000, 20366 / 100000, 100000)
    assert common.reference_points("ler_sweep", code=(2, 3, 6, 7, 2, 3)) == (
        [], None)


def write_reference(path: Path, code: str, weight: int, counts: dict) -> None:
    stats = CodeStatistics(
        code_str=code, rand_seed=1, num_errors_tested=counts["tested"],
        num_x_errors_tested=counts["tested"],
        num_z_errors_tested=counts["tested"], error_weight=weight,
        corrected=counts["corrected"], syndrome_errors_x=counts["syn_x"],
        syndrome_errors_z=counts["syn_z"],
        logical_errors=counts.get("logical", 0),
        convergence_fail_x=counts.get("conv_x", 0),
        convergence_fail_z=counts.get("conv_z", 0),
        duration_micro_seconds=1)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a") as f:
        f.write(stats.to_reference_text() + "\n\n")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory) -> Path:
    """One corpus ``results`` directory written from the five records'
    reference sides, in the corpus's own layout (the named-code
    directories, the headline file at the root, archive/ and the dated
    directories), with an empty file in each place the corpus has one."""
    root = tmp_path_factory.mktemp("results")
    flagship = str(construct_code(*common.FLAGSHIP))
    deep = {pt.weight: pt.counts
            for pt in common.reference_points("golden_deep")[0]}
    for pt in common.reference_points("golden_sweep")[0]:
        counts = dict(pt.counts)
        if pt.p == 0.01 and pt.max_iters == 100 and pt.weight in deep \
                and pt.weight != 15:
            counts.update(conv_x=deep[pt.weight]["conv_x"],
                          conv_z=deep[pt.weight]["conv_z"])
        write_reference(root / "[4,5,10,61,9,49]" /
                        f"{flagship}_W_{pt.weight}_MAX_{pt.max_iters}_p_"
                        f"{pt.p}.txt", flagship, pt.weight, counts)
    write_reference(root / common.HEADLINE_FILE, flagship, 15, deep[15])
    (root / "[4,5,10,61,9,49]" / f"{flagship}_W_60_MAX_100000_p_0.02.txt"
     ).touch()
    code42 = str(construct_code(*common.CODE42))
    for pt in common.reference_points("golden_sweep42")[0]:
        write_reference(root / "[2,3,6,7,2,3]" /
                        f"{code42}_W_{pt.weight}_MAX_{pt.max_iters}_p_"
                        f"{pt.p}.txt", code42, pt.weight, pt.counts)
    dirs = {"max_sweep": dict((m, d) for d, m in common.MAX_SWEEP_DIRS)}
    for pt in common.reference_points("golden_dated")[0]:
        if pt.section == "archive":
            code = str(construct_code(*pt.code))
            path = (root / "archive" /
                    f"{code}_W_{pt.weight}_MAX_{pt.max_iters}_p_{pt.p}.txt")
        else:
            # the 2017 pretty-printer's code string
            code = ("code: J={},K={},L={},P={},sigma={},tau={} "
                    "[[n=42,k=7]]".format(*pt.code))
            directory = (dirs["max_sweep"][pt.max_iters]
                         if pt.section == "max_sweep"
                         else common.PRE_DETECTION_DIR)
            path = root / directory / pt.file
        write_reference(path, code, pt.weight, pt.counts)
    (root / common.PRE_DETECTION_DIR / "ResultsCPU_RELEASE_2.txt").touch()
    return root


@pytest.mark.parametrize("script", SCRIPTS)
def test_ref_dir_gives_the_record_points(corpus, script):
    from_records, _ = common.reference_points(script)
    from_corpus, source = common.reference_points(script, corpus)
    assert source == str(corpus)
    if script == "golden_deep":   # every p_0.01 MAX=100 file of the corpus
        weights = {pt.weight for pt in from_records}
        assert len(from_corpus) == 60
        from_corpus = [pt for pt in from_corpus if pt.weight in weights]
    assert from_corpus == from_records


# -- one chunk, JAX against the port -----------------------------------------------

J2 = (2, 3, 6, 7, 2, 3)
CHUNK_CASES = [  # (code, weight, cap, prior)
    (common.CODE42, 5, 100, 0.02), (common.CODE42, 21, 1000, 0.02),
    (J2, 3, 50, 0.02), (J2, 4, 1000, 0.02),
    (common.FLAGSHIP, 40, 100, 0.01), (common.FLAGSHIP, 40, 100, 0.02)]
CHUNK_BATCH = 256


def shared_errors(n: int, weight: int, seed: int):
    """Weight-``weight`` Pauli errors (n, CHUNK_BATCH) int32 from NumPy:
    ``weight`` draws of a qubit and a type each, bits OR'd in."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (weight, CHUNK_BATCH))
    typ = rng.integers(0, 3, (weight, CHUNK_BATCH))
    xe = np.zeros((n, CHUNK_BATCH), np.int32)
    ze = np.zeros((n, CHUNK_BATCH), np.int32)
    lanes = np.broadcast_to(np.arange(CHUNK_BATCH), idx.shape)
    np.maximum.at(xe, (idx, lanes), (typ <= 1).astype(np.int32))
    np.maximum.at(ze, (idx, lanes), (typ >= 1).astype(np.int32))
    return xe, ze


@pytest.fixture(scope="module")
def chunk_counters():
    """(port, JAX) counters of every CHUNK_CASES case."""
    out = {}
    for case in CHUNK_CASES:
        params, weight, cap, prior = case
        code, jcode = construct_code(*params), jax_construct_code(*params)
        graphs, jgraphs = CodeGraphs.build(code), JaxCodeGraphs.build(jcode)
        xe, ze = shared_errors(code.n, weight, seed=sum(params) + weight + cap)
        # the port's chunk body on the CPU
        txe, tze = torch.from_numpy(xe), torch.from_numpy(ze)
        res = decode_batch(graphs, graphs.x.syndrome(txe),
                           graphs.z.syndrome(tze), prior,
                           BPConfig(max_iters=cap))
        port = classify_batch(make_rank_basis_test(code, "cpu"), txe, tze,
                              res.decisions_x.to(torch.int32),
                              res.decisions_z.to(torch.int32),
                              res.error_code).numpy()
        # JAX's: XLA's decode, its classification
        jxe, jze = jnp.asarray(xe), jnp.asarray(ze)
        jres = jax_decode_batch(jgraphs, jgraphs.x.syndrome(jxe),
                                jgraphs.z.syndrome(jze), prior,
                                JaxBPConfig(max_iters=cap, kernel="xla"))
        theirs = np.asarray(jax_classify_batch(
            jax_make_rank_basis_test(jcode), jxe, jze,
            jres.decisions_x.astype(jnp.int32),
            jres.decisions_z.astype(jnp.int32), jres.error_code))
        out[case] = port.astype(np.int64), theirs.astype(np.int64)
    return out


@pytest.mark.parametrize("case", CHUNK_CASES, ids=str)
def test_chunk_counters_equal_jax(chunk_counters, case):
    port, theirs = chunk_counters[case]
    np.testing.assert_array_equal(port, theirs)
    assert port[0] == CHUNK_BATCH


def test_chunk_cases_reach_both_outcomes(chunk_counters):
    """The cases hold converged and failed lanes: J=2 and [[42,0]] lanes
    that run to their cap, [[610,61]] lanes corrected and failed."""
    for (params, weight, cap, prior), (port, _) in chunk_counters.items():
        assert 0 < port[3] + port[6] + port[4] + port[5], params
        if params != common.FLAGSHIP:
            assert port[7] + port[8] > 0, (params, weight, cap)
        else:
            assert 0 < port[3] < CHUNK_BATCH


def test_merged_logical_comparison_equal_on_both(chunk_counters):
    """golden_dated's comparison of either side's counters with one
    reference point: the same record, its corrected count the port's
    corrected + logical."""
    ref = {"tested": 100000, "corrected": 40000, "syn_x": 20000,
           "syn_z": 19000, "conv_x": 2000, "conv_z": 1900}
    for port, theirs in chunk_counters.values():
        a = golden_dated.compare({}, ref, port)
        assert a == golden_dated.compare({}, ref, theirs)
        assert a["ours_corrected"] == port[3] + port[6]
        assert a["ours_logical_raw"] == port[6] and a["merged_logical"]


# -- each script's main, tiny ------------------------------------------------------

def run_quiet(fn, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(**kwargs)


def lines(path: Path) -> list:
    return [json.loads(x) for x in path.read_text().splitlines()]


def keys_of(relative: str, pick) -> set:
    """The keys of the first line of a JAX record that ``pick`` accepts."""
    return set(next(r for r in records(relative) if pick(r)))


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    """Each script's main at a tiny cut on the CPU: {script: (records
    returned, records written)}; the JAX package's records untouched."""
    before = {str(p): p.stat().st_mtime_ns for p in JAX_DATA.rglob("*")
              if p.is_file()}
    tmp = tmp_path_factory.mktemp("golden")
    cuts = {
        "golden_sweep": (golden_sweep.main,
                         dict(weights=(1, 2), samples=64, batch=64)),
        "golden_sweep42": (golden_sweep42.main,
                           dict(points=((10, 100), (11, 1000)),
                                samples_per_point=64, batch=64)),
        "golden_deep": (golden_deep.main,
                        dict(weights=(58,), samples_per_point=64, batch=64)),
        "golden_dated": (golden_dated.main,
                         dict(points=(("archive", 2), ("max_sweep", 1),
                                      ("pre_detection", 3)),
                              candidates=(50, 100), samples_per_point=64,
                              batch=64)),
        "ler_sweep": (ler_sweep.main,
                      dict(weights=(1, 20), count=64, batch=64,
                           steps_per_call=1)),
    }
    out = {}
    for name, (main, cut) in cuts.items():
        path = tmp / f"{name}.jsonl"
        returned = run_quiet(main, device="cpu", out=str(path), **cut)
        out[name] = returned, lines(path)
    after = {str(p): p.stat().st_mtime_ns for p in JAX_DATA.rglob("*")
             if p.is_file()}
    assert after == before
    return out


def check_keys(rec: dict, jax: set) -> None:
    assert set(rec) == jax | ADDED, set(rec) ^ (jax | ADDED)
    assert rec["device_kind"] == "cpu" and rec["power_limit"] is None


def test_golden_sweep_keys(tiny_runs):
    _, written = tiny_runs["golden_sweep"]
    rel = "data/golden_sweep_r3.jsonl"
    check_keys(written[0], keys_of(rel, lambda r: "artifact" in r))
    assert written[0]["kernel"] == "plain"
    assert [(r["weight"], r["p"], r["max_iters"]) for r in written[1:]] == [
        (1, 0.01, 100), (1, 0.02, 100), (2, 0.01, 100), (2, 0.02, 100)]
    for rec in written[1:]:
        check_keys(rec, keys_of(rel, lambda r, p=rec["p"]: r.get("p") == p))
        assert rec["ref_source"] == "benchmarks/data/golden_sweep_r3.jsonl"


def test_golden_sweep42_keys(tiny_runs):
    _, written = tiny_runs["golden_sweep42"]
    rel = "data/golden_sweep42_deep_r5.jsonl"
    check_keys(written[0], keys_of(rel, lambda r: "artifact" in r))
    for rec in written[1:]:
        check_keys(rec, keys_of(rel, lambda r: "weight" in r))
        # the r4 record's keys are a subset: the depth's own record
        assert keys_of("data/golden_sweep42_r4.jsonl",
                       lambda r: "weight" in r) - {"seconds"} <= set(rec)
    assert [r["ours_tested"] for r in written[1:]] == [64, 64]


def test_golden_sweep42_budget_caps_the_long_points():
    """The lane-iteration budget: at MAX=100,000 a point takes 40,000
    samples, rounded up to 20 chunks of 2048 (the r5 record's 40,960)."""
    cap = max(2048, golden_sweep42.ITER_BUDGET // (2 * 100_000))
    assert -(-min(golden_sweep42.DEEP_SAMPLES, cap) // 2048) * 2048 == 40960
    deep = {(r["weight"], r["max_iters"]): r["ours_tested"]
            for r in records("data/golden_sweep42_deep_r5.jsonl")[1:]}
    for (w, m), tested in deep.items():
        cap = max(2048, golden_sweep42.ITER_BUDGET // (2 * m))
        assert -(-min(golden_sweep42.DEEP_SAMPLES, cap) // 2048) * 2048 \
            == tested, (w, m)


def test_golden_deep_keys(tiny_runs):
    _, written = tiny_runs["golden_deep"]
    rel = "data/golden_deep_r4.jsonl"
    check_keys(written[0], keys_of(rel, lambda r: "artifact" in r))
    check_keys(written[1], keys_of(rel, lambda r: "weight" in r))
    assert written[1]["ours_tested_prior001"] == 64
    assert written[1]["ref_tested"] == 10000


def test_golden_dated_keys(tiny_runs):
    _, written = tiny_runs["golden_dated"]
    rel = "data/golden_dated_r5.jsonl"
    check_keys(written[0], keys_of(rel, lambda r: "artifact" in r))
    sections = [r["section"] for r in written[1:]]
    # archive W=2 is on both codes; max_sweep W=1 at three caps; the
    # pre-detection W=3 file at the two candidates
    assert sections == ["archive"] * 2 + ["max_sweep"] * 3 + \
        ["pre_detection"] * 2
    for rec in written[1:]:
        check_keys(rec, keys_of(rel, lambda r, s=rec["section"]:
                                r.get("section") == s))
        assert rec["merged_logical"]


def jax_ler_sweep_keys() -> set:
    """The keys of a line that benchmarks/ler_sweep.py emits: its ``rec``
    dict and the keys assigned into it, read from its source."""
    tree = ast.parse((JAX_DATA / "ler_sweep.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "rec"
                and isinstance(node.value, ast.Dict)):
            keys |= {k.value for k in node.value.keys}
        if (isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Subscript)
                and isinstance(node.targets[0].value, ast.Name)
                and node.targets[0].value.id == "rec"):
            keys.add(node.targets[0].slice.value)
    return keys


def test_ler_sweep_keys(tiny_runs):
    returned, written = tiny_runs["ler_sweep"]
    assert returned == [{k: v for k, v in r.items() if k not in ADDED}
                        for r in written]
    for rec in written:
        check_keys(rec, jax_ler_sweep_keys())
        assert rec["tested"] == 64 and rec["ref_tested"] == 10000


def test_every_record_names_its_reference(tiny_runs):
    for name, (_, written) in tiny_runs.items():
        relative = common.REFERENCE[
            "golden_sweep" if name == "ler_sweep" else name][0]
        assert {r["ref_source"] for r in written} == {
            f"benchmarks/{relative}"}, name


def test_main_reads_the_corpus_through_ref_dir(corpus, tmp_path):
    records_ = run_quiet(golden_deep.main, device="cpu", weights=(58,),
                         samples_per_point=64, batch=64, ref_dir=str(corpus),
                         out=str(tmp_path / "gd.jsonl"))
    assert {r["ref_source"] for r in lines(tmp_path / "gd.jsonl")} == {
        str(corpus)}
    assert records_[1]["ref_conv_x"] == 8632   # W=58 in the corpus


def test_gate_parity_raises():
    common.gate_parity("x", [("a", 4.9), ("b", -4.9)], full=False)
    with pytest.raises(AssertionError):
        common.gate_parity("x", [("a", 5.0)], full=False)
    with pytest.raises(AssertionError):
        common.gate_parity("x", [("a", 1.5), ("b", 1.2)], full=True)
    assert common.gate_parity("x", [("a", 1.5), ("b", 0.1), ("c", 0.2)],
                              full=True) == 0.2
