"""The full [[42,0]] golden-corpus sweep on the card: plain sum-product.

The port of ``benchmarks/golden_sweep42.py``.  Every corpus point of the
reference's second code, [[42,0]] (``construct_code(3, 3, 6, 7, 2, 3)``;
W=1..42 at MAX in {100, 1000, 5000, 10000, 100000}, all p=0.02), is decoded
at its labelled prior (this corpus matches as labelled, the r3 provenance
finding) with the dynamic sampler (cap 48) from the generators of
(4200 + W + 101 * MAX, chunk), so no two caps of a weight share a stream.
The code is degenerate (k=0) and BP mostly fails, so the failure
counters (syndrome-fail, conv-fail, the reference's "logical") are the
signal, and a failing lane runs to its cap: K1 sees caps up to 10^5.
Each point takes ``min(samples, max(batch, ITER_BUDGET // (2 * MAX)))``
samples, the JAX script's budget of pessimistic lane-iterations.

Two depths: the default 10,240 samples a point (the JAX r4 record) and
``--samples 1048576`` (the r5 deep record, ``golden_sweep42_deep_h100``).

The reference's counts are rounded back from the committed JAX record's
fractions (``benchmarks/data/golden_sweep42_deep_r5.jsonl``) unless
``--ref-dir`` names the corpus's ``results`` directory
(``common.reference_points``).  Gates, in run: at 10,240 samples or fewer
the JAX test's (``tests/test_golden_sweep42.py``) on its four counters,
|z| <= 4 where the expected count is >= 25 and, over the full sweep, a
median |z| <= 1 with <= 5% beyond 3; the W=10, MAX=100 failure regime at
any depth; and the port against JAX's run of the same points at its depth
(two-proportion |z| < 5 on every count, median |z| <= 1 over the full
sweep): the JAX script's own samples at its depth (r4's up to 10,240,
r5's above) decoded on IEEE arithmetic (``--stream jax``,
``golden_sweep42[_deep]_jaxstream_h100.jsonl``; see ``common.jax_twin``),
not the TPU records, whose arithmetic is the TPU's (the r4 record
predates the script's seed rule and drew 4200 + W, so only r5's are its
samples).  The deep record's W=3..6, MAX=100 cluster against the
reference is the reference's iteration-cap provenance (the r5 note), not
gated.

    python benchmarks_torch/golden_sweep42.py [--samples N] [--out PATH]
    python benchmarks_torch/golden_sweep42.py --device cpu \\
        --points 10:100,3:1000 --samples 128 --batch 128
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmarks_torch.common import (  # noqa: E402
    CODE42,
    COUNTERS,
    JAX_STREAM_NOTE,
    card,
    gate,
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
from benchmarks_torch.golden_deep import _z, rate_parity_pvalue  # noqa: E402
from qec_ldpc_tpu_torch import construct_code  # noqa: E402
from qec_ldpc_tpu_torch.decoder import BPConfig, CodeGraphs  # noqa: E402
from qec_ldpc_tpu_torch.sampling import make_rank_basis_test  # noqa: E402

#: the dynamic sampler's cap: the corpus runs to W=42.  The JAX script's
#: cap is 32 ("the corpus tops out at W=30"), and its sampler draws a weight
#: above the cap as the cap, so its W=33..42 points are weight-32 samples;
#: the port's sampler refuses such a weight, and takes golden_dated's cap
#: for this code
W_MAX = 48
#: the JAX script's cap, which its stream (``--stream jax``) keeps
JAX_W_MAX = 32
SAMPLES = 10240
DEEP_SAMPLES = 1048576
#: the worst-case lane-iterations a point may take (every lane to its cap)
ITER_BUDGET = 8_000_000_000
#: the counters of a record, in the JAX record's order, each with the
#: reference file's field whose name its p-value key takes
FIELDS = ("corrected", "logical", "syn_x", "conv_x", "syn_z", "conv_z")
#: the counters the JAX test gates, and the r4 record holds
GATED = ("corrected", "logical", "syn_x", "conv_x")


def check(records: list, samples: int, full: bool) -> float:
    """The in-run gates on the point records (see the module docstring);
    returns the median port-vs-JAX |z|."""
    if samples <= SAMPLES:
        zs = []
        for r in records:
            for c in GATED:
                z = r[f"z_{c}"]
                zs.append(abs(z))
                if r[f"ref_{c}_fraction"] * r["ours_tested"] >= 25:
                    gate(abs(z) <= 4.0,
                         f"golden_sweep42 W={r['weight']} MAX="
                         f"{r['max_iters']} {c}: z = {z}")
        if full:
            median = sorted(zs)[len(zs) // 2]
            gate(median <= 1.0, f"golden_sweep42: median |z| = {median}")
            beyond = sum(z > 3 for z in zs) / len(zs)
            gate(beyond <= 0.05,
                 f"golden_sweep42: {beyond:.1%} of |z| beyond 3")
    for r in records:
        if r["weight"] == 10 and r["max_iters"] == 100:
            gate(r["ours_corrected_fraction"] < 0.01
                 and 0.4 < r["ours_conv_x_fraction"] < 0.65,
                 f"golden_sweep42 W=10 MAX=100: not the failure regime "
                 f"(corrected {r['ours_corrected_fraction']}, conv_x "
                 f"{r['ours_conv_x_fraction']})")
    theirs = {(r["weight"], r["max_iters"]): r
              for r in jax_twin(record_name(samples))}
    pairs = [(f"W={r['weight']} MAX={r['max_iters']} {c}",
              two_proportion_z(
                  round(r[f"ours_{c}_fraction"] * r["ours_tested"]),
                  r["ours_tested"],
                  round(j[f"ours_{c}_fraction"] * j["ours_tested"]),
                  j["ours_tested"]))
             for r in records
             if (j := theirs.get((r["weight"], r["max_iters"]))) is not None
             for c in FIELDS]
    return gate_parity("golden_sweep42", pairs, full)


def record_name(samples_per_point: int) -> str:
    """``golden_sweep42`` at 10,240 samples a point or fewer (the JAX r4
    record's depth), ``golden_sweep42_deep`` deeper (r5's)."""
    return "golden_sweep42" if samples_per_point <= SAMPLES \
        else "golden_sweep42_deep"


def main(device: str = "cuda", samples_per_point: int = SAMPLES,
         points=None, batch: int = 2048, ref_dir: str | None = None,
         out: str | None = None, stream: str = "port") -> list:
    """Every corpus point (the (W, MAX) pairs ``points`` when given) at
    ``samples_per_point`` within the iteration budget; returns the records
    (meta line first).  The default output is ``golden_sweep42_h100`` at
    10,240 samples a point and ``golden_sweep42_deep_h100`` deeper.
    ``stream="jax"``: the JAX record's samples instead (its cap of 32
    too; ``common.run_chunks``), written as ``..._jaxstream``, ungated: the
    port's runs are held to it."""
    device = resolve_device(device)
    ref_points, source = reference_points("golden_sweep42", ref_dir)
    run = [pt for pt in ref_points
           if points is None or (pt.weight, pt.max_iters) in points]
    code = construct_code(*CODE42)
    graphs = CodeGraphs.build(code)
    test = make_rank_basis_test(code, device)
    t_all = time.perf_counter()
    records = []
    for i, pt in enumerate(run):
        w, max_iters, p, ref = pt.weight, pt.max_iters, pt.p, pt.counts
        n_ref = ref["tested"]
        cfg = BPConfig(max_iters=max_iters)
        # the pessimistic (every lane to its cap) lane-iteration budget
        samples_cap = max(batch, ITER_BUDGET // (2 * max_iters))
        chunks = -(-min(samples_per_point, samples_cap) // batch)
        t0 = time.perf_counter()
        # the seed folds in MAX, so the caps of a weight draw independent
        # streams (the JAX r4 W=11 "z-cluster" was three caps sharing one)
        counters, _ = run_chunks(graphs, test, cfg,
                                 seed=4200 + w + 101 * max_iters, weight=w,
                                 error_probability=p, batch=batch,
                                 chunks=chunks, device=device,
                                 weight_cap=W_MAX if stream == "port"
                                 else JAX_W_MAX, stream=stream)
        dt = time.perf_counter() - t0
        n_ours = int(counters[COUNTERS["tested"][1]])
        rec = {"weight": w, "p": p, "max_iters": max_iters,
               "ref_tested": n_ref, "ours_tested": n_ours}
        pvals = {}
        for c in FIELDS:
            kr, ko = ref[c], int(counters[COUNTERS[c][1]])
            rec[f"ref_{c}_fraction"] = round(kr / n_ref, 6)
            rec[f"ours_{c}_fraction"] = round(ko / n_ours, 6)
            rec[f"z_{c}"] = _z(kr, n_ref, ko, n_ours)
            field = COUNTERS[c][0].lower().replace(" ", "_")
            pvals[f"pvalue_{field}"] = round(
                rate_parity_pvalue(kr, n_ref, ko, n_ours), 6)
        # the JAX record's order: the p-values after every z
        rec.update(pvals)
        rec["seconds"] = round(dt, 3)
        records.append(rec)
        print(f"[{i + 1}/{len(run)}] W={w} MAX={max_iters}: "
              f"corrected z={rec['z_corrected']:+.2f} logical "
              f"z={rec['z_logical']:+.2f} syn_x z={rec['z_syn_x']:+.2f} "
              f"conv_x z={rec['z_conv_x']:+.2f} ({dt:.1f}s)", flush=True)
    zs = np.array([[abs(r[f"z_{c}"]) for c in GATED] for r in records])
    where = card(device)
    meta = {
        "artifact": "golden_sweep42", "code": str(code),
        "decoder": "sum-product", "kernel": route(device),
        "samples_per_point": samples_per_point,
        "iter_budget_per_point": ITER_BUDGET,
        "device_kind": where["device_kind"],
        "points": len(records),
        "total_seconds": round(time.perf_counter() - t_all, 1),
        "note": ("every [[42,0]] corpus point at its labelled prior (the "
                 "reference's counts from ref_source); the failure-regime "
                 "counters are the signal (k=0, BP mostly fails, a failing "
                 "lane runs to its cap); per-point seeds fold in MAX; "
                 "exact conditional-binomial two-sample pvalue_* beside "
                 "every z; samples from the port's generators of "
                 "(4200 + W + 101 * MAX, chunk): median |z| against the "
                 f"reference {np.median(zs):.3f}, max {zs.max():.3f}"),
    }
    if stream == "jax":
        meta.update(stream="jax", note=JAX_STREAM_NOTE)
    print(f"golden_sweep42: {len(records)} points; median |z| "
          f"{np.median(zs):.2f}, max |z| {zs.max():.2f}")
    write_records(out_path(stream_name(record_name(samples_per_point),
                                       stream), out),
                  [meta] + records, {**where, "ref_source": source})
    if stream == "port":
        check(records, samples_per_point, len(run) == len(ref_points))
    return [meta] + records


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--samples", type=int, default=SAMPLES,
                    help=f"samples a point before the iteration budget "
                         f"(default {SAMPLES}; the deep record "
                         f"{DEEP_SAMPLES})")
    ap.add_argument("--points", default=None,
                    help="comma-separated W:MAX pairs (default: every "
                         "corpus point)")
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--ref-dir", default=None,
                    help="the corpus's results directory (default: the "
                         "reference's counts in the JAX record)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--stream", choices=("port", "jax"), default="port",
                    help="jax: the JAX record's own samples (its keys), "
                         "the comparison the port's runs are gated on")
    a = ap.parse_args(argv)
    points = (None if a.points is None else
              {tuple(int(x) for x in pair.split(":"))
               for pair in a.points.split(",")})
    main(a.device, a.samples, points, a.batch, a.ref_dir, a.out, a.stream)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
