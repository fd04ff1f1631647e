"""The full [[610,61]] golden-corpus weight sweep on the card: plain
sum-product.

The port of ``benchmarks/golden_sweep.py``.  Every [[610,61]] corpus point
(W=1..60 at both p labels, MAX=100, and the W=60 points at MAX=1000 and
10,000) is decoded with the reference's decoder family (probability-domain
sum-product, no relay or OSD; K1 on the card) at its W, MAX and p, with
the sample count rounded up from the corpus file's to whole chunks of 2048
(10,240 at the p_0.01 label, 2,048 at p_0.02), drawn with the dynamic
sampler (cap 64) from the generators of (1000 + W, chunk).

Provenance (round-2 finding): the reference's p_0.01-labelled [[610]]
files were generated at prior 0.02, so those points are decoded at 0.02
too and carry ``z_score_prior002``, the gated z; their uncorrected
``z_score`` documents the mislabelling and is not gated.

The reference's counts come from the committed JAX record
(``benchmarks/data/golden_sweep_r3.jsonl``) unless ``--ref-dir`` names the
corpus's ``results`` directory (``common.reference_points``).  Gates, in
run: the JAX test's (``tests/test_golden_parity.py::
test_full_610_weight_sweep_artifact``): the provenance-corrected |z| <
4.5 at every point, and over the full sweep its median < 1.5, both labels
at W=1..58, each point at least as deep as the corpus file and the
corrected curve falling with W; and the port against JAX's run of the same
points and depth (two-proportion |z| < 5 on every count, median |z| <= 1
over the full sweep): the JAX record's own samples decoded on IEEE
arithmetic (``--stream jax``, ``golden_sweep_jaxstream_h100.jsonl``; see
``common.jax_twin``), not the TPU record, whose arithmetic is the TPU's.

    python benchmarks_torch/golden_sweep.py [--out PATH] [--ref-dir DIR]
    python benchmarks_torch/golden_sweep.py --device cpu --weights 1,2 \\
        --samples 128 --batch 128
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
    COUNTERS,
    FLAGSHIP,
    JAX_STREAM_NOTE,
    card,
    gate,
    gate_jax_cpu,
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
from benchmarks_torch.golden_deep import _z  # noqa: E402
from qec_ldpc_tpu_torch import construct_code  # noqa: E402
from qec_ldpc_tpu_torch.decoder import BPConfig, CodeGraphs  # noqa: E402
from qec_ldpc_tpu_torch.sampling import make_rank_basis_test  # noqa: E402

W_MAX = 64  # the dynamic sampler's cap: the corpus tops out at W=60
#: the counts a record holds on both sides
COUNTS = ("corrected", "logical", "syn_x", "syn_z")


def check(records: list, full: bool) -> float:
    """The in-run gates on the point records (see the module docstring);
    returns the median port-vs-JAX |z|."""
    zs = []
    for r in records:
        z = r.get("z_score_prior002", r["z_score"])
        zs.append(abs(z))
        gate(abs(z) < 4.5, f"golden_sweep W={r['weight']} p={r['p']} "
                           f"MAX={r['max_iters']}: z = {z}")
    curve = [r["ours_corrected_fraction"] for r in
             sorted((r for r in records if r["p"] == 0.01),
                    key=lambda r: r["weight"])]
    gate(all(curve[i + 3] <= curve[i] + 0.02 for i in range(len(curve) - 3)),
         "golden_sweep: the corrected fraction does not fall with W")
    if full:
        gate(all(r["ref_tested"] >= 100 and r["ours_tested"] >= r["ref_tested"]
                 for r in records),
             "golden_sweep: a point has fewer samples than its corpus file")
        gate(float(np.median(zs)) < 1.5,
             f"golden_sweep: median |z| = {float(np.median(zs)):.3f}")
        have = {(r["weight"], r["p"]) for r in records}
        gate(all((w, p) in have for w in range(1, 59) for p in (0.01, 0.02)),
             "golden_sweep: a weight of 1..58 lacks a label")
    theirs = {(r["weight"], r["p"], r["max_iters"]): r
              for r in jax_twin("golden_sweep")}
    pairs = []
    for r in records:
        j = theirs.get((r["weight"], r["p"], r["max_iters"]))
        if j is None:
            continue
        pairs += [(f"W={r['weight']} p={r['p']} MAX={r['max_iters']} {c}",
                   two_proportion_z(r[f"ours_{c}"], r["ours_tested"],
                                    j[f"ours_{c}"], j["ours_tested"]))
                  for c in COUNTS]
        if "ours_corrected_fraction_prior002" in r:
            pairs.append((f"W={r['weight']} p={r['p']} corrected at 0.02",
                          two_proportion_z(
                              round(r["ours_corrected_fraction_prior002"]
                                    * r["ours_tested"]), r["ours_tested"],
                              round(j["ours_corrected_fraction_prior002"]
                                    * j["ours_tested"]), j["ours_tested"])))
    return gate_parity("golden_sweep", pairs, full)


def main(device: str = "cuda", weights=None, batch: int = 2048,
         samples: int | None = None, ref_dir: str | None = None,
         out: str | None = None, stream: str = "port") -> list:
    """Every corpus point (those at ``weights`` when given), each at the
    corpus file's depth (``samples`` when given); returns the records
    (meta line first).  ``stream="jax"``: the JAX record's samples instead
    (``common.run_chunks``), written as ``golden_sweep_jaxstream``, gated
    only on ``JAX_CPU_RUNS``: the port's runs are held to it."""
    device = resolve_device(device)
    points, source = reference_points("golden_sweep", ref_dir)
    run = [pt for pt in points if weights is None or pt.weight in weights]
    code = construct_code(*FLAGSHIP)
    graphs = CodeGraphs.build(code)
    test = make_rank_basis_test(code, device)
    t_all = time.perf_counter()

    def sweep_point(w, p, cfg, chunks):
        return run_chunks(graphs, test, cfg, seed=1000 + w, weight=w,
                          error_probability=p, batch=batch, chunks=chunks,
                          device=device, weight_cap=W_MAX,
                          stream=stream)[0]

    records = []
    for i, pt in enumerate(run):
        w, max_iters, p, ref = pt.weight, pt.max_iters, pt.p, pt.counts
        ref_tested, ref_corrected = ref["tested"], ref["corrected"]
        cfg = BPConfig(max_iters=max_iters)
        chunks = -(-(samples or ref_tested) // batch)
        t0 = time.perf_counter()
        counters = sweep_point(w, p, cfg, chunks)
        dt = time.perf_counter() - t0
        if stream == "jax":
            gate_jax_cpu(("golden_sweep", w, p, max_iters), counters, batch)
        tested = int(counters[COUNTERS["tested"][1]])
        ours = {c: int(counters[COUNTERS[c][1]]) for c in COUNTS}
        pr, po = ref_corrected / ref_tested, ours["corrected"] / tested
        # the p_0.01-labelled files were generated at prior 0.02: decode
        # those points at 0.02 too, the z that is gated
        corrected_extra = {}
        if p == 0.01:
            c2 = sweep_point(w, 0.02, cfg, chunks)
            n2 = int(c2[COUNTERS["tested"][1]])
            k2 = int(c2[COUNTERS["corrected"][1]])
            corrected_extra = {
                "ours_corrected_fraction_prior002": round(k2 / n2, 6),
                "z_score_prior002": _z(ref_corrected, ref_tested, k2, n2),
            }
        rec = {
            "weight": w, "p": p, "max_iters": max_iters,
            "ref_tested": ref_tested, "ref_corrected": ref_corrected,
            "ref_logical": ref["logical"], "ref_syn_x": ref["syn_x"],
            "ref_syn_z": ref["syn_z"],
            "ours_tested": tested, "ours_corrected": ours["corrected"],
            "ours_logical": ours["logical"], "ours_syn_x": ours["syn_x"],
            "ours_syn_z": ours["syn_z"],
            "ref_corrected_fraction": round(pr, 6),
            "ours_corrected_fraction": round(po, 6),
            "z_score": _z(ref_corrected, ref_tested, ours["corrected"],
                          tested),
            **corrected_extra,
            "seconds": round(dt, 3),
        }
        records.append(rec)
        print(f"[{i + 1}/{len(run)}] W={w} p={p} MAX={max_iters}: ref "
              f"{pr:.4f} ours {po:.4f} z={rec['z_score']:+.2f}"
              + (f" z@0.02={rec['z_score_prior002']:+.2f}"
                 if corrected_extra else "")
              + f" ({dt:.1f}s)", flush=True)
    zs = np.array([abs(r.get("z_score_prior002", r["z_score"]))
                   for r in records])
    where = card(device)
    meta = {
        "artifact": "golden_sweep", "code": str(code),
        "decoder": "sum-product", "kernel": route(device),
        "device_kind": where["device_kind"],
        "points": len(records),
        "total_seconds": round(time.perf_counter() - t_all, 1),
        "note": ("apples-to-apples plain BP against the reference corpus "
                 "(the reference's counts from ref_source); the p=0.02 "
                 "files hold 1000 samples each; the p_0.01-labelled files "
                 "were generated at prior 0.02 (round-2 provenance "
                 "finding), so those points carry z_score_prior002, the "
                 "gated z; samples from the port's generators of "
                 "(1000 + W, chunk): provenance-corrected median |z| "
                 f"{np.median(zs):.3f}, max {zs.max():.3f}"),
    }
    if stream == "jax":
        meta.update(stream="jax", note=JAX_STREAM_NOTE)
    print(f"golden_sweep: {len(records)} points, provenance-corrected "
          f"median |z| = {np.median(zs):.2f}, max |z| = {zs.max():.2f}")
    write_records(out_path(stream_name("golden_sweep", stream), out),
                  [meta] + records, {**where, "ref_source": source})
    if stream == "port":
        check(records, len(run) == len(points) and samples is None)
    return [meta] + records


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--weights", default=None,
                    help="comma-separated weights (default: every point)")
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--samples", type=int, default=None,
                    help="samples a point (default: the corpus file's, "
                         "rounded up to whole batches)")
    ap.add_argument("--ref-dir", default=None,
                    help="the corpus's results directory (default: the "
                         "reference's counts in the JAX record)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--stream", choices=("port", "jax"), default="port",
                    help="jax: the JAX record's own samples (its keys), "
                         "the comparison the port's runs are gated on")
    a = ap.parse_args(argv)
    weights = (None if a.weights is None
               else tuple(int(w) for w in a.weights.split(",")))
    main(a.device, weights, a.batch, a.samples, a.ref_dir, a.out, a.stream)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
