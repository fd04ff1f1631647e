"""Deep count parity against the [[610,61]] golden corpus, on the card; and
the corpus scripts' statistics.

The port of ``benchmarks/golden_deep.py``.  At every corpus weight W in
{15, 20, 25, 30, 40, 50, 58}, MAX=100, 1,048,576 samples a point are drawn
with the dynamic sampler (cap 64) from the generators of (7000 + W, chunk)
and decoded with plain sum-product (K1 on the card), each at prior 0.02
(the unsuffixed fields) and at prior 0.01 (``_prior001``).  Every
rare-event counter (logical errors, convergence failures X/Z per
``DecoderCPU.h:514-521``, syndrome failures X/Z) is compared with the
reference's by the exact conditional-binomial two-sample test, the
corrected fraction by its z, and the logical rate gets its exact 95%
Poisson interval.

Provenance (the JAX record's own finding): the W >= 20 corpus files were
generated at prior 0.02, the 100,000-sample W=15 headline file at its
labelled prior 0.01; each point is gated at its generation prior.

The reference's counts come from the committed JAX record
(``benchmarks/data/golden_deep_r4.jsonl``) unless ``--ref-dir`` names the
corpus's ``results`` directory (``common.reference_points``).  Gates, in
run: the JAX test's thresholds (``tests/test_golden_deep.py``) on the
port's counts, and the port against JAX's run of the same points
(two-proportion |z| < 5 for every counter, median |z| <= 1 over the full
run): the JAX record's own samples decoded on IEEE arithmetic
(``--stream jax``, ``golden_deep_jaxstream_h100.jsonl``; see
``common.jax_twin``), not the TPU record, whose arithmetic is the TPU's.

    python benchmarks_torch/golden_deep.py [--out PATH] [--ref-dir DIR]
    python benchmarks_torch/golden_deep.py --device cpu --weights 15 \\
        --samples 256 --batch 128

The statistics (``binom_test_two_sided``, ``rate_parity_pvalue``,
``poisson_ci``, ``_z``) are copies of the JAX scripts' (golden_deep.py and
golden_dated.py), which the other corpus scripts import from here.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from pathlib import Path

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmarks_torch.common import (  # noqa: E402
    COUNTERS,
    FLAGSHIP,
    card,
    gate,
    JAX_STREAM_NOTE,
    gate_parity,
    jax_twin,
    out_path,
    reference_points,
    resolve_device,
    route,
    run_chunks,
    stream_name,
    two_proportion_z,
    write_records,
)
from qec_ldpc_tpu_torch import construct_code  # noqa: E402
from qec_ldpc_tpu_torch.decoder import BPConfig, CodeGraphs  # noqa: E402
from qec_ldpc_tpu_torch.sampling import make_rank_basis_test  # noqa: E402

WEIGHTS = (15, 20, 25, 30, 40, 50, 58)
MAX_ITERS = 100
SAMPLES = 2048 * 512
W_MAX = 64  # the dynamic sampler's cap: the corpus tops out at W=58
RARE = ("logical", "syn_x", "syn_z", "conv_x", "conv_z")
#: the conv-fail-X rate bands of the JAX test (W=30: 4 -> W=58: 8632 of
#: 10,000 in the corpus; tests/test_golden_deep.py::test_conv_fail_curve)
CONV_X_BANDS = {30: (-math.inf, 2e-3), 40: (0.02, 0.12), 50: (0.35, 0.60),
                58: (0.75, 0.95)}


def _log_binom_pmf(k: int, n: int, p: float) -> float:
    if p <= 0.0:
        return 0.0 if k == 0 else -math.inf
    if p >= 1.0:
        return 0.0 if k == n else -math.inf
    return (math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)
            + k * math.log(p) + (n - k) * math.log1p(-p))


def binom_test_two_sided(k: int, n: int, p: float) -> float:
    """Exact two-sided binomial test (sum of outcomes no more likely than k),
    the classic "minlike" definition.  n here is small-ish (<= total event
    count across both sides), so the O(n) sum is fine."""
    if n == 0:
        return 1.0
    lp_k = _log_binom_pmf(k, n, p)
    tot = 0.0
    for j in range(n + 1):
        lp = _log_binom_pmf(j, n, p)
        if lp <= lp_k + 1e-9:
            tot += math.exp(lp)
    return min(1.0, tot)


def rate_parity_pvalue(k_ref: int, n_ref: int, k_ours: int, n_ours: int) -> float:
    """Two-sample rate comparison: under H0 (same Poisson/binomial rate),
    k_ref | (k_ref + k_ours) ~ Binomial(k_ref + k_ours, n_ref/(n_ref+n_ours)).
    Exact, valid for arbitrarily small counts (the regime this artifact
    exists for: 1 logical error in 100 000 reference samples)."""
    total = k_ref + k_ours
    return binom_test_two_sided(k_ref, total, n_ref / (n_ref + n_ours))


def poisson_ci(k: int, alpha: float = 0.05) -> tuple[float, float]:
    """Exact (Garwood) Poisson CI for an event count, via the chi-square /
    gamma duality; used to report rate intervals alongside the tests."""
    from math import inf

    def gamma_ppf(q, shape):
        # bisection on the regularized lower incomplete gamma
        if shape <= 0:
            return 0.0
        lo, hi = 0.0, shape + 10 * math.sqrt(shape) + 10
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if _reg_gamma_lower(shape, mid) < q:
                lo = mid
            else:
                hi = mid
        return 0.5 * (lo + hi)

    lo = gamma_ppf(alpha / 2, k) if k > 0 else 0.0
    hi = gamma_ppf(1 - alpha / 2, k + 1)
    return lo, hi if hi != inf else inf


def _reg_gamma_lower(s: float, x: float) -> float:
    """Regularized lower incomplete gamma P(s, x) by series/continued
    fraction (Numerical-Recipes-style; plenty accurate for CI bisection)."""
    if x <= 0:
        return 0.0
    if x < s + 1:
        term = 1.0 / s
        total = term
        a = s
        for _ in range(500):
            a += 1
            term *= x / a
            total += term
            if term < total * 1e-12:
                break
        return total * math.exp(-x + s * math.log(x) - math.lgamma(s))
    # continued fraction for Q(s,x), P = 1 - Q
    b = x + 1 - s
    c = 1e300
    d = 1.0 / b
    h = d
    for i in range(1, 500):
        an = -i * (i - s)
        b += 2
        d = an * d + b
        d = 1.0 / (d if abs(d) > 1e-300 else 1e-300)
        c = b + an / c
        c = c if abs(c) > 1e-300 else 1e-300
        de = d * c
        h *= de
        if abs(de - 1.0) < 1e-12:
            break
    q = h * math.exp(-x + s * math.log(x) - math.lgamma(s))
    return 1.0 - q


def _z(k_ref, n_ref, k_ours, n_ours):
    fr, fo = k_ref / n_ref, k_ours / n_ours
    sigma = float(np.sqrt(fr * (1 - fr) / n_ref
                          + fo * (1 - fo) / n_ours)) or 1e-9
    return round((fo - fr) / sigma, 3)


def _tag(weight: int) -> str:
    """The field suffix of the point's generation prior: 0.01 for the W=15
    headline file, 0.02 (unsuffixed) for the rest."""
    return "_prior001" if weight == 15 else ""


def check(records: list, full: bool) -> float:
    """The in-run gates on the point records (see the module docstring);
    returns the median port-vs-JAX |z|."""
    points = {r["weight"]: r for r in records}
    for w, rec in points.items():
        t = _tag(w)
        gate(abs(rec[f"z_corrected{t}"]) < 3.0,
             f"golden_deep W={w}: corrected z = {rec[f'z_corrected{t}']}")
        for c in RARE:
            gate(rec[f"pvalue_{c}{t}"] >= 0.01,
                 f"golden_deep W={w} {c}: two-sample p = "
                 f"{rec[f'pvalue_{c}{t}']}")
    if 15 in points:
        rec = points[15]
        lo, hi = rec["ours_logical_rate_ci95_prior001"]
        gate(lo <= rec["ref_logical_rate_prior001"] <= hi,
             f"golden_deep W=15: the reference's logical rate outside the "
             f"port's 95% interval [{lo}, {hi}]")
        if rec["ours_tested_prior001"] >= 1_000_000:
            gate(1e-6 <= rec["ours_logical_rate_prior001"] <= 3e-5,
                 f"golden_deep W=15: logical rate "
                 f"{rec['ours_logical_rate_prior001']} outside [1e-6, 3e-5]")
    rates = []
    for w, (lo, hi) in CONV_X_BANDS.items():
        if w in points:
            r = points[w]
            rate = r[f"ours_conv_x{_tag(w)}"] / r[f"ours_tested{_tag(w)}"]
            gate(lo < rate < hi,
                 f"golden_deep W={w}: conv-fail X rate {rate} outside "
                 f"({lo}, {hi})")
            rates.append(rate)
    gate(rates == sorted(set(rates)),
         f"golden_deep: the conv-fail X curve does not rise ({rates})")
    theirs = {r["weight"]: r for r in jax_twin("golden_deep")}
    zs = [(f"W={w}{t} {c}",
           two_proportion_z(rec[f"ours_{c}{t}"], rec[f"ours_tested{t}"],
                            theirs[w][f"ours_{c}{t}"],
                            theirs[w][f"ours_tested{t}"]))
          for w, rec in points.items() if w in theirs
          for t in ("", "_prior001")
          for c in ("corrected",) + RARE]
    return gate_parity("golden_deep", zs, full)


def main(device: str = "cuda", samples_per_point: int = SAMPLES,
         weights=WEIGHTS, batch: int = 2048, ref_dir: str | None = None,
         out: str | None = None, stream: str = "port") -> list:
    """The deep points at ``weights``; returns the records (meta line
    first).  ``stream="jax"``: the JAX record's samples instead
    (``common.run_chunks``), written as ``golden_deep_jaxstream``, ungated:
    the port's runs are held to it."""
    device = resolve_device(device)
    points, source = reference_points("golden_deep", ref_dir)
    by_weight = {pt.weight: pt.counts for pt in points}
    code = construct_code(*FLAGSHIP)
    graphs = CodeGraphs.build(code)
    test = make_rank_basis_test(code, device)
    cfg = BPConfig(max_iters=MAX_ITERS)
    chunks = -(-samples_per_point // batch)
    t_all = time.perf_counter()
    records = []
    for i, w in enumerate(weights):
        refc = by_weight[w]
        n_ref = refc["tested"]
        rec = {"weight": w, "max_iters": MAX_ITERS, "p_label": 0.01,
               "ref_tested": n_ref,
               **{f"ref_{k}": refc[k] for k in COUNTERS if k != "tested"}}
        for prior, tag in ((0.02, ""), (0.01, "_prior001")):
            t0 = time.perf_counter()
            counters, _ = run_chunks(graphs, test, cfg, seed=7000 + w,
                                     weight=w, error_probability=prior,
                                     batch=batch, chunks=chunks,
                                     device=device, weight_cap=W_MAX,
                                     stream=stream)
            dt = time.perf_counter() - t0
            n_ours = int(counters[COUNTERS["tested"][1]])
            ours = {k: int(counters[COUNTERS[k][1]])
                    for k in COUNTERS if k != "tested"}
            side = {"ours_tested": n_ours, "seconds": round(dt, 2)}
            for k, v in ours.items():
                side[f"ours_{k}"] = v
            side["z_corrected"] = _z(refc["corrected"], n_ref,
                                     ours["corrected"], n_ours)
            for k in RARE:
                side[f"pvalue_{k}"] = round(
                    rate_parity_pvalue(refc[k], n_ref, ours[k], n_ours), 6)
            lo, hi = poisson_ci(ours["logical"])
            side["ours_logical_rate"] = ours["logical"] / n_ours
            side["ours_logical_rate_ci95"] = [lo / n_ours, hi / n_ours]
            side["ref_logical_rate"] = refc["logical"] / n_ref
            rec.update({k + tag: v for k, v in side.items()})
            print(f"[{i + 1}/{len(weights)}] W={w} prior={prior}: "
                  f"corrected z={side['z_corrected']:+.2f} "
                  f"logical {ours['logical']}/{n_ours} "
                  f"(ref {refc['logical']}/{n_ref}, "
                  f"p={side['pvalue_logical']:.3f}) "
                  f"conv_x p={side['pvalue_conv_x']:.3f} ({dt:.1f}s)",
                  flush=True)
        records.append(rec)
    where = card(device)
    meta = {
        "artifact": "golden_deep", "code": str(code),
        "decoder": "sum-product", "kernel": route(device),
        "samples_per_point": samples_per_point,
        "device_kind": where["device_kind"],
        "points": len(records),
        "total_seconds": round(time.perf_counter() - t_all, 1),
        "note": ("deep count parity against the reference's deepest "
                 "[[610]] corpus files; unsuffixed fields decode at prior "
                 "0.02, _prior001 fields at 0.01 (W=15, the 100,000-sample "
                 "headline file, is gated at 0.01, W >= 20 at 0.02); "
                 "pvalue_* are exact conditional-binomial two-sample rate "
                 "tests; the reference's counts from ref_source; samples "
                 "from the port's generators of (7000 + W, chunk), not "
                 "JAX's, so the port meets JAX's run of the same points "
                 "(golden_deep_jaxstream_h100.jsonl) by two-sample tests"),
    }
    if stream == "jax":
        meta.update(stream="jax", note=JAX_STREAM_NOTE)
    write_records(out_path(stream_name("golden_deep", stream), out),
                  [meta] + records, {**where, "ref_source": source})
    if stream == "port":
        check(records, set(weights) == set(WEIGHTS))
    return [meta] + records


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--samples", type=int, default=SAMPLES)
    ap.add_argument("--weights", default=",".join(map(str, WEIGHTS)))
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--ref-dir", default=None,
                    help="the corpus's results directory (default: the "
                         "reference's counts in the JAX record)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--stream", choices=("port", "jax"), default="port",
                    help="jax: the JAX record's own samples (its keys), "
                         "the comparison the port's runs are gated on")
    a = ap.parse_args(argv)
    main(a.device, a.samples, tuple(int(w) for w in a.weights.split(",")),
         a.batch, a.ref_dir, a.out, a.stream)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
