"""The committed H100 records of the port's reference-corpus scripts
(``benchmarks_torch/data/golden_*_h100.jsonl``, ``ler_sweep_h100.jsonl``)
and its run of the reference's literal experiment
(``benchmarks_torch/data/ref_run_h100/``), held to:

* the JAX tests' own thresholds against the reference
  (``tests/test_golden_parity.py``, ``test_golden_deep.py``,
  ``test_golden_sweep42.py``, ``test_ref_run_artifact.py``), each point at
  the prior and depth those tests gate;
* JAX's run of the same points and depth on IEEE arithmetic: the
  ``*_jaxstream_h100.jsonl`` records, the JAX records' own samples
  (``jax_stream``) decoded on the card by the port, which is JAX's decoder
  bit for bit; the two-proportion z of every count below 5, their median
  |z| at most 1.  Those records hold the JAX records' points and depths,
  and JAX's own body on the CPU exactly where ``common.JAX_CPU_RUNS`` has
  it; the TPU records differ from them on the same samples (the TPU's
  arithmetic), which is why the port is not gated on the TPU records;
* an NVIDIA card and its power limit named on every line.

The reference's counts are the JAX records' (``common.reference_points``);
nothing reads the reference corpus.
"""

import glob
import json
from pathlib import Path

import numpy as np
import pytest

from benchmarks_torch.common import JAX_CPU_RUNS, two_proportion_z
from qec_ldpc_tpu_torch.harness.stats import parse_reference_text

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "benchmarks_torch" / "data"
JAX = ROOT / "benchmarks" / "data"
RECORDS = ("golden_sweep", "golden_sweep42", "golden_sweep42_deep",
           "golden_deep", "golden_dated", "ler_sweep")
TWINS = ("golden_sweep", "golden_sweep42", "golden_sweep42_deep",
         "golden_deep", "golden_dated")
#: each twin's TPU record, whose points and depth it keeps (and its
#: samples, but for golden_sweep42's r4: that record predates the JAX
#: script's seed rule 4200 + W + 101 * MAX and drew 4200 + W)
TPU_RECORDS = {"golden_sweep": "golden_sweep_r3.jsonl",
               "golden_sweep42": "golden_sweep42_r4.jsonl",
               "golden_sweep42_deep": "golden_sweep42_deep_r5.jsonl",
               "golden_deep": "golden_deep_r4.jsonl",
               "golden_dated": "golden_dated_r5.jsonl"}


def load(path: Path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def port(name: str) -> tuple[dict | None, list]:
    """(meta line, point lines) of the port's record ``name``; ler_sweep
    has no meta line."""
    recs = load(PORT / f"{name}_h100.jsonl")
    if name == "ler_sweep":
        return None, recs
    return recs[0], recs[1:]


def jax(relative: str) -> list:
    return load(JAX / relative)[1:]


def twin(name: str) -> list:
    """The point lines of ``<name>_jaxstream_h100.jsonl``."""
    return load(PORT / f"{name}_jaxstream_h100.jsonl")[1:]


def parity(zs: list) -> None:
    """The port-vs-JAX gate: every |z| < 5, the median |z| <= 1."""
    assert zs
    worst = max(zs, key=lambda wz: abs(wz[1]))
    assert abs(worst[1]) < 5, worst
    assert float(np.median([abs(z) for _, z in zs])) <= 1.0


@pytest.mark.parametrize("name", RECORDS + tuple(f"{t}_jaxstream"
                                                for t in TWINS))
def test_every_line_names_an_nvidia_card(name):
    for rec in load(PORT / f"{name}_h100.jsonl"):
        assert rec["device_kind"].startswith("NVIDIA"), rec["device_kind"]
        assert rec["power_limit"].endswith(" W"), rec["power_limit"]
        assert rec["ref_source"].startswith("benchmarks/data/")


# -- golden_sweep: tests/test_golden_parity.py::test_full_610_weight_sweep ----

def test_golden_sweep_coverage_and_depth():
    meta, recs = port("golden_sweep")
    assert meta["decoder"] == "sum-product" and meta["kernel"] == "cuda"
    assert len(recs) == 122
    have = {(r["weight"], r["p"]) for r in recs}
    assert all((w, p) in have for w in range(1, 59) for p in (0.01, 0.02))
    for r in recs:
        assert r["ref_tested"] >= 100 and r["ours_tested"] >= r["ref_tested"]


def test_golden_sweep_provenance_corrected_z():
    _, recs = port("golden_sweep")
    zs = [abs(r.get("z_score_prior002", r["z_score"])) for r in recs]
    assert max(zs) < 4.5
    assert float(np.median(zs)) < 1.5


def test_golden_sweep_corrected_curve_falls():
    _, recs = port("golden_sweep")
    fracs = [r["ours_corrected_fraction"] for r in
             sorted((r for r in recs if r["p"] == 0.01),
                    key=lambda r: r["weight"])]
    assert all(fracs[i + 3] <= fracs[i] + 0.02 for i in range(len(fracs) - 3))


def test_golden_sweep_against_jax():
    _, recs = port("golden_sweep")
    theirs = {(r["weight"], r["p"], r["max_iters"]): r
              for r in twin("golden_sweep")}
    zs = []
    for r in recs:
        j = theirs[(r["weight"], r["p"], r["max_iters"])]
        assert r["ours_tested"] == j["ours_tested"]   # equal depth
        zs += [(f"{r['weight']} {r['p']} {c}",
                two_proportion_z(r[f"ours_{c}"], r["ours_tested"],
                                 j[f"ours_{c}"], j["ours_tested"]))
               for c in ("corrected", "logical", "syn_x", "syn_z")]
    parity(zs)


# -- golden_deep: tests/test_golden_deep.py ---------------------------------------

def tag(weight: int) -> str:
    return "_prior001" if weight == 15 else ""


def deep_points() -> dict:
    meta, recs = port("golden_deep")
    assert meta["samples_per_point"] >= 1_000_000
    return {r["weight"]: r for r in recs}


def test_golden_deep_depth_and_coverage():
    points = deep_points()
    assert set(points) == {15, 20, 25, 30, 40, 50, 58}
    for w, rec in points.items():
        assert rec[f"ours_tested{tag(w)}"] >= 1_000_000
    assert points[15]["ref_tested"] == 100_000
    assert points[15]["ref_logical"] == 1


def test_golden_deep_corrected_z():
    for w, rec in deep_points().items():
        assert abs(rec[f"z_corrected{tag(w)}"]) < 3.0, w


def test_golden_deep_rare_event_pvalues():
    for w, rec in deep_points().items():
        for c in ("logical", "syn_x", "syn_z", "conv_x", "conv_z"):
            assert rec[f"pvalue_{c}{tag(w)}"] >= 0.01, (w, c)


def test_golden_deep_headline_ler_point():
    rec = deep_points()[15]
    lo, hi = rec["ours_logical_rate_ci95_prior001"]
    assert lo <= rec["ref_logical_rate_prior001"] <= hi
    assert 1e-6 <= rec["ours_logical_rate_prior001"] <= 3e-5


def test_golden_deep_conv_fail_curve():
    points = deep_points()
    rate = {w: points[w][f"ours_conv_x{tag(w)}"]
            / points[w][f"ours_tested{tag(w)}"] for w in (30, 40, 50, 58)}
    assert rate[30] < 2e-3
    assert 0.02 < rate[40] < 0.12
    assert 0.35 < rate[50] < 0.60
    assert 0.75 < rate[58] < 0.95
    assert rate[30] < rate[40] < rate[50] < rate[58]


def test_golden_deep_against_jax():
    theirs = {r["weight"]: r for r in twin("golden_deep")}
    zs = []
    for w, r in deep_points().items():
        for t in ("", "_prior001"):
            assert r[f"ours_tested{t}"] == theirs[w][f"ours_tested{t}"]
            zs += [(f"{w}{t} {c}", two_proportion_z(
                r[f"ours_{c}{t}"], r[f"ours_tested{t}"],
                theirs[w][f"ours_{c}{t}"], theirs[w][f"ours_tested{t}"]))
                for c in ("corrected", "logical", "syn_x", "syn_z", "conv_x",
                          "conv_z")]
    parity(zs)


# -- golden_sweep42: tests/test_golden_sweep42.py -----------------------------------

GATED = ("corrected", "logical", "syn_x", "conv_x")


def test_golden_sweep42_coverage():
    meta, recs = port("golden_sweep42")
    assert meta["points"] == len(recs) == 58
    assert meta["samples_per_point"] == 10240
    assert all(r["p"] == 0.02 for r in recs)
    assert {r["max_iters"] for r in recs} == {100, 1000, 5000, 10000, 100000}
    assert all(r["ours_tested"] >= 10_000 for r in recs)


def test_golden_sweep42_parity_distribution():
    _, recs = port("golden_sweep42")
    zs = sorted(abs(r[f"z_{c}"]) for r in recs for c in GATED)
    assert zs[len(zs) // 2] <= 1.0
    assert sum(z > 3 for z in zs) / len(zs) <= 0.05


def test_golden_sweep42_no_large_deviation_where_approximation_holds():
    _, recs = port("golden_sweep42")
    for r in recs:
        for c in GATED:
            if r[f"ref_{c}_fraction"] * r["ours_tested"] >= 25:
                assert abs(r[f"z_{c}"]) <= 4.0, (r["weight"], r["max_iters"],
                                                  c)


@pytest.mark.parametrize("name", ("golden_sweep42", "golden_sweep42_deep"))
def test_golden_sweep42_failure_regime(name):
    _, recs = port(name)
    w10 = next(r for r in recs if r["weight"] == 10 and r["max_iters"] == 100)
    assert w10["ours_corrected_fraction"] < 0.01
    assert 0.4 < w10["ours_conv_x_fraction"] < 0.65


@pytest.mark.parametrize("name", ("golden_sweep42", "golden_sweep42_deep"))
def test_golden_sweep42_against_jax(name):
    _, recs = port(name)
    theirs = {(r["weight"], r["max_iters"]): r for r in twin(name)}
    assert len(recs) == len(theirs)
    zs = []
    for r in recs:
        j = theirs[(r["weight"], r["max_iters"])]
        assert r["ours_tested"] == j["ours_tested"]   # equal depth
        n = r["ours_tested"]
        zs += [(f"{r['weight']} {r['max_iters']} {c}", two_proportion_z(
            round(r[f"ours_{c}_fraction"] * n), n,
            round(j[f"ours_{c}_fraction"] * n), n))
            for c in GATED + ("syn_z", "conv_z")]
    parity(zs)


# -- golden_dated ---------------------------------------------------------------------

def dated_key(r: dict) -> tuple:
    return (r["section"], r["code"], r.get("file"), r["weight"],
            r.get("max_iters", r.get("max_iters_candidate")))


def test_golden_dated_coverage():
    meta, recs = port("golden_dated")
    assert meta["samples_per_point"] == 1048576
    theirs = jax("golden_dated_r5.jsonl")
    assert [dated_key(r) for r in recs] == [dated_key(r) for r in theirs]
    assert all(r["merged_logical"] for r in recs)


def test_golden_dated_against_jax():
    _, recs = port("golden_dated")
    theirs = {dated_key(r): r for r in twin("golden_dated")}
    zs = []
    for r in recs:
        j = theirs[dated_key(r)]
        assert r["ours_tested"] == j["ours_tested"]   # equal depth
        zs += [(f"{dated_key(r)} {c}", two_proportion_z(
            r[f"ours_{c}"], r["ours_tested"], j[f"ours_{c}"],
            j["ours_tested"]))
            for c in ("corrected", "syn_x", "syn_z", "conv_x", "conv_z",
                      "logical_raw")]
    parity(zs)


# -- ler_sweep ----------------------------------------------------------------------

def test_ler_sweep_against_the_reference():
    """The JAX script's defaults (W=10..50, 10,000 rounded up to whole
    groups of 32 chunks of 2048, decoded at 0.02 against the p_0.01 files)
    and the golden sweep's gate on the corrected fraction."""
    _, recs = port("ler_sweep")
    assert [r["weight"] for r in recs] == [10, 20, 30, 40, 50]
    for r in recs:
        assert r["tested"] == 65536 and r["p"] == 0.02
        assert r["algorithm"] == "sum-product" and r["osd"] == -1
        fr, fo = r["ref_corrected_frac"], r["corrected_frac"]
        sigma = (fr * (1 - fr) / r["ref_tested"]
                 + fo * (1 - fo) / r["tested"]) ** 0.5
        assert abs(fo - fr) < 4.5 * sigma + 1e-5, r["weight"]


# -- the reference's literal experiment: tests/test_ref_run_artifact.py -------------

def ref_run_records() -> tuple[dict, dict]:
    def one(directory: Path) -> dict:
        files = glob.glob(str(directory / "*W_15*.txt").replace("[", "[[]"))
        assert len(files) == 1, files
        recs = parse_reference_text(Path(files[0]).read_text())
        assert len(recs) == 1
        return recs[0]

    return one(PORT / "ref_run_h100"), one(JAX / "ref_run_r4")


def test_ref_run_same_record_fields():
    ours, theirs = ref_run_records()
    assert set(ours) == set(theirs)
    for field in ("Code", "Rand Seed", "Errors Tested", "Errors With X",
                  "Errors With Z", "Error Weight"):
        assert ours[field] == theirs[field], field


def test_ref_run_outcome_fractions_against_the_reference():
    """Within |z| < 4 of the reference's W=15 counts (its 100,000-sample
    headline file, as golden_deep_r4.jsonl carries them)."""
    ours, _ = ref_run_records()
    ref = next(r for r in jax("golden_deep_r4.jsonl") if r["weight"] == 15)
    n_o, n_r = int(ours["Errors Tested"]), ref["ref_tested"]
    assert n_r == 100_000 and ref["ref_corrected"] == 99_539
    for field, key in (("Corrected", "corrected"),
                       ("Syndrome Errors X", "syn_x"),
                       ("Syndrome Errors Z", "syn_z")):
        fo, fr = int(ours[field]) / n_o, ref[f"ref_{key}"] / n_r
        sigma = (fr * (1 - fr) / n_r + fo * (1 - fo) / n_o) ** 0.5
        assert abs(fo - fr) < 4 * sigma, (field, fo, fr)
    assert int(ours["Logical Errors"]) <= 10
    assert int(ours["Convergence Fail X"]) == int(
        ours["Convergence Fail Z"]) == 0


def test_ref_run_journal_and_log():
    lines = load(PORT / "ref_run_h100" / "journal.jsonl")
    assert lines and all(r["run_id"].endswith("|torch=cuda") for r in lines)
    assert sum(r["counters"][0] for r in lines) == 100352
    log = (PORT / "ref_run_h100" / "output_log.txt").read_text()
    assert "(cuda); seed=2287037912" in log and "Run complete." in log


# -- the twins: the JAX records' samples on IEEE arithmetic ---------------------------

def point_key(name: str, r: dict) -> tuple:
    if name == "golden_dated":
        return dated_key(r)
    return (r["weight"], r.get("p"), r["max_iters"])


@pytest.mark.parametrize("name", TWINS)
def test_twin_keeps_the_tpu_records_points_and_depth(name):
    meta = load(PORT / f"{name}_jaxstream_h100.jsonl")[0]
    assert meta["stream"] == "jax" and meta["kernel"] == "cuda"
    ours, theirs = twin(name), jax(TPU_RECORDS[name])
    assert [point_key(name, r) for r in ours] == [point_key(name, r)
                                                  for r in theirs]
    for a, b in zip(ours, theirs):
        for t in ("", "_prior001") if name == "golden_deep" else ("",):
            assert a[f"ours_tested{t}"] == b[f"ours_tested{t}"]


def test_twins_hold_jax_on_the_cpu_and_the_tpu_records_do_not():
    """At the JAX_CPU_RUNS points the twins' counts are JAX's own body on
    the CPU (the same samples); the TPU records' are not."""
    sweep = {point_key("golden_sweep", r): r for r in twin("golden_sweep")}
    tpu_sweep = {point_key("golden_sweep", r): r
                 for r in jax("golden_sweep_r3.jsonl")}
    dated = {(r["section"], r["code"], r["weight"]): r
             for r in twin("golden_dated") if r["section"] == "archive"}
    tpu_dated = {(r["section"], r["code"], r["weight"]): r
                 for r in jax("golden_dated_r5.jsonl")
                 if r["section"] == "archive"}
    k42 = "[J=3,K=3,L=6,P=7,s=2,t=3][[n=42,k=0]]"
    for key, want in JAX_CPU_RUNS.items():
        if key[0] == "golden_sweep":
            point = (key[1], key[2], key[3])
            got, tpu = sweep[point], tpu_sweep[point]
            assert [got[f"ours_{c}"] for c in ("tested", "corrected",
                                               "logical", "syn_x", "syn_z")] \
                == [want[0], want[3], want[6], want[4], want[5]]
            assert tpu["ours_corrected"] != want[3]
        else:
            point = ("archive", k42, key[3])
            got, tpu = dated[point], tpu_dated[point]
            merged = want[3] + want[6]
            assert [got[f"ours_{c}"] for c in ("tested", "corrected", "syn_x",
                                               "syn_z", "conv_x", "conv_z")] \
                == [want[0], merged, want[4], want[5], want[7], want[8]]
            assert got["ours_logical_raw"] == want[6]
            assert tpu["ours_corrected"] != merged


@pytest.mark.parametrize("name,syndrome_failures", [
    ("golden_deep", lambda r: sum(r[f"ours_syn_{g}{t}"] for g in "xz"
                                  for t in ("", "_prior001"))),
    ("golden_sweep42_deep", lambda r: round(
        (r["ours_syn_x_fraction"] + r["ours_syn_z_fraction"])
        * r["ours_tested"])),
    ("golden_dated", lambda r: r["ours_syn_x"] + r["ours_syn_z"])])
def test_tpu_records_fail_fewer_syndromes_on_the_same_samples(
        name, syndrome_failures):
    """The TPU's arithmetic, on the samples its record drew: at every point
    it leaves at most as many syndrome failures as JAX's decoder on IEEE
    arithmetic (the twin), and fewer in all."""
    ours, theirs = twin(name), jax(TPU_RECORDS[name])
    pairs = [(syndrome_failures(t), syndrome_failures(o))
             for o, t in zip(ours, theirs)]
    assert all(tpu <= ieee for tpu, ieee in pairs)
    assert sum(tpu for tpu, _ in pairs) < sum(ieee for _, ieee in pairs)
