"""The dated-directory and archive golden-corpus sweep on the card.

The port of ``benchmarks/golden_dated.py``: the corpus directories the
named-code sweeps skip, each point decoded with plain sum-product (K1 on
the card) at 1,048,576 samples a point, drawn with the dynamic sampler.

* ``archive`` -- two codes at MAX=100, p=0.02: [[42,0]] W=0..7 and 21..42
  (cap 48; seeds 5200 + W + 3) and [[610,61]] W=1..51 (cap 56; seeds
  5200 + W + 4).
* ``max_sweep`` -- the 11-20-2017 directories: the J=2 [[42,7]] code
  (``construct_code(2, 3, 6, 7, 2, 3)``, column weight 2), W=1..5 at MAX
  50, 100 and 1000 (cap 24; seeds 5300 + MAX + W), the corpus's only axis
  that varies the iteration cap at a fixed code and weight.
* ``pre_detection`` -- the 11-18-2017 directory: the same code from a
  build that predates logical-error detection, MAX unrecorded, so each
  file is decoded at the candidates MAX in {50, 100, 1000, 10000} (seeds
  5400 + MAX + W).

The dated directories record no p: 0.02 is assumed (every named [[42]]
file is p_0.02).  Every section is pre-detection data (the JAX record's
PROVENANCE FINDING: the reference's logical counter is 0 throughout and
its Corrected equals our corrected + logical within noise), so every point
compares ``merged_logical``: the reference's Corrected against the port's
corrected + logical, the port's logical kept as ``ours_logical_raw``.

The reference's counts come from the committed JAX record
(``benchmarks/data/golden_dated_r5.jsonl``) unless ``--ref-dir`` names the
corpus's ``results`` directory (``common.reference_points``).  The JAX
package has no test of its record; its archive points sit 3-8 sigma off
the reference (the reference's unrecorded per-file caps, the record's
note), so the gate, in run, is the port against JAX's run of the same points
(two-proportion |z| < 5 on every count, median |z| <= 1 over the full
sweep): the JAX record's own samples decoded on IEEE arithmetic
(``--stream jax``, ``golden_dated_jaxstream_h100.jsonl``; see
``common.jax_twin``), not the TPU record, whose arithmetic is the TPU's.

    python benchmarks_torch/golden_dated.py [--out PATH] [--ref-dir DIR]
    python benchmarks_torch/golden_dated.py --device cpu --samples 128 \\
        --batch 128 --points archive:3,max_sweep:2,pre_detection:1 \\
        --candidates 50,100
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
    JAX_STREAM_NOTE,
    card,
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
from benchmarks_torch.golden_deep import _z, rate_parity_pvalue  # noqa: E402
from qec_ldpc_tpu_torch import construct_code  # noqa: E402
from qec_ldpc_tpu_torch.decoder import BPConfig, CodeGraphs  # noqa: E402
from qec_ldpc_tpu_torch.sampling import make_rank_basis_test  # noqa: E402

SAMPLES = 2048 * 512
CANDIDATES = (50, 100, 1000, 10000)  # the pre-detection files' caps
P_ASSUMED = 0.02
#: the dynamic sampler's cap of each code
W_CAPS = {(3, 3, 6, 7, 2, 3): 48, (4, 5, 10, 61, 9, 49): 56,
          (2, 3, 6, 7, 2, 3): 24}
#: the counts a record compares, after the merged corrected
COUNTS = ("corrected", "syn_x", "syn_z", "conv_x", "conv_z")


def compare(rec: dict, ref: dict, counters: np.ndarray) -> dict:
    """The z and p-value fields against the reference's counts ``ref``,
    merging the port's logical errors into its corrected count (see the
    module docstring); ``ours_logical_raw`` keeps them."""
    rec["merged_logical"] = True
    logical = int(counters[COUNTERS["logical"][1]])
    rec["ours_logical_raw"] = logical
    n_ref, n_ours = ref["tested"], int(counters[COUNTERS["tested"][1]])
    rec.update({"ref_tested": n_ref, "ours_tested": n_ours})
    for name in COUNTS:
        kr = ref[name]
        ko = int(counters[COUNTERS[name][1]]) + (
            logical if name == "corrected" else 0)
        rec[f"ref_{name}"] = kr
        rec[f"ours_{name}"] = ko
        rec[f"z_{name}"] = _z(kr, n_ref, ko, n_ours)
        rec[f"pvalue_{name}"] = round(
            rate_parity_pvalue(kr, n_ref, ko, n_ours), 6)
    return rec


def _key(rec: dict) -> tuple:
    """A point's identity in both records: section, code, file, weight and
    cap (the candidate's, in the pre-detection section)."""
    return (rec["section"], rec["code"], rec.get("file"), rec["weight"],
            rec.get("max_iters", rec.get("max_iters_candidate")))


def check(records: list, full: bool) -> float:
    """The in-run gate (see the module docstring); returns the median
    port-vs-JAX |z|."""
    theirs = {_key(r): r for r in jax_twin("golden_dated")}
    pairs = [(f"{'/'.join(str(k) for k in _key(r))} {c}",
              two_proportion_z(r[f"ours_{c}"], r["ours_tested"],
                               j[f"ours_{c}"], j["ours_tested"]))
             for r in records if (j := theirs.get(_key(r))) is not None
             for c in COUNTS + ("logical_raw",)]
    return gate_parity("golden_dated", pairs, full)


def main(device: str = "cuda", samples_per_point: int = SAMPLES,
         points=None, candidates=CANDIDATES, batch: int = 2048,
         ref_dir: str | None = None, out: str | None = None,
         stream: str = "port") -> list:
    """Every point of the three sections (the (section, W) pairs ``points``
    when given; the pre-detection files at ``candidates``); returns the
    records (meta line first).  ``stream="jax"``: the JAX record's samples
    instead (``common.run_chunks``), written as ``golden_dated_jaxstream``,
    gated only on ``JAX_CPU_RUNS``: the port's runs are held to it."""
    device = resolve_device(device)
    ref_points, source = reference_points("golden_dated", ref_dir)
    run = [pt for pt in ref_points
           if points is None or (pt.section, pt.weight) in points]
    chunks = -(-samples_per_point // batch)
    codes = {}

    def code_of(params):
        if params not in codes:
            code = construct_code(*params)
            codes[params] = (code, CodeGraphs.build(code),
                             make_rank_basis_test(code, device))
        return codes[params]

    def run_point(params, seed, w, max_iters, p):
        _, graphs, test = code_of(params)
        t0 = time.perf_counter()
        counters, _ = run_chunks(graphs, test, BPConfig(max_iters=max_iters),
                                 seed=seed, weight=w, error_probability=p,
                                 batch=batch, chunks=chunks, device=device,
                                 weight_cap=W_CAPS[params], stream=stream)
        return counters, time.perf_counter() - t0

    t_all = time.perf_counter()
    records = []
    for pt in run:
        code = str(code_of(pt.code)[0])
        if pt.section == "archive":
            counters, dt = run_point(pt.code, 5200 + pt.weight + pt.code[0],
                                     pt.weight, pt.max_iters, pt.p)
            if stream == "jax":
                gate_jax_cpu(("golden_dated", "archive", pt.code, pt.weight),
                             counters, batch)
            rec = compare({"section": "archive", "code": code,
                           "weight": pt.weight, "max_iters": pt.max_iters,
                           "p": pt.p, "seconds": round(dt, 2)},
                          pt.counts, counters)
        elif pt.section == "max_sweep":
            counters, dt = run_point(pt.code, 5300 + pt.max_iters + pt.weight,
                                     pt.weight, pt.max_iters, P_ASSUMED)
            rec = compare({"section": "max_sweep", "code": code,
                           "file": pt.file, "weight": pt.weight,
                           "max_iters": pt.max_iters, "p_assumed": P_ASSUMED,
                           "seconds": round(dt, 2)}, pt.counts, counters)
        else:
            for max_iters in candidates:
                counters, dt = run_point(pt.code, 5400 + max_iters + pt.weight,
                                         pt.weight, max_iters, P_ASSUMED)
                records.append(compare(
                    {"section": "pre_detection", "code": code,
                     "file": pt.file, "weight": pt.weight,
                     "max_iters_candidate": max_iters,
                     "p_assumed": P_ASSUMED, "seconds": round(dt, 2)},
                    pt.counts, counters))
                print(f"[pre_detection {pt.file} W={pt.weight} MAX?="
                      f"{max_iters}] corrected z="
                      f"{records[-1]['z_corrected']:+.2f} conv_z z="
                      f"{records[-1]['z_conv_z']:+.2f} ({dt:.1f}s)",
                      flush=True)
            continue
        records.append(rec)
        print(f"[{pt.section} n={code_of(pt.code)[0].n}] W={pt.weight} "
              f"MAX={pt.max_iters}: corrected z={rec['z_corrected']:+.2f} "
              f"syn_x z={rec['z_syn_x']:+.2f} ({dt:.1f}s)", flush=True)
    zs = np.array([abs(r[k]) for r in records for k in r
                   if k.startswith("z_") and r["section"] != "pre_detection"])
    where = card(device)
    meta = {
        "artifact": "golden_dated",
        "decoder": "sum-product", "kernel": route(device),
        "samples_per_point": samples_per_point,
        "device_kind": where["device_kind"],
        "points": len(records),
        "total_seconds": round(time.perf_counter() - t_all, 1),
        "note": ("parity sweep over the archive/ ([[42,0]] W=0..7,21..42 "
                 "and [[610,61]] W=1..51), the 11-20-2017 MAX-sweep "
                 "directories (J=2 [[42,7]] at MAX 50/100/1000) and the "
                 "11-18-2017 directory (MAX unrecorded -> candidates "
                 "{50,100,1000,10000}); every section is pre-detection "
                 "data, compared with merged_logical=true; p=0.02 assumed "
                 "where the files record none; the reference's counts "
                 "from ref_source; samples from the port's generators of "
                 "(5200/5300/5400 + ..., chunk): the sections other than "
                 f"pre_detection median |z| {np.median(zs):.3f} against "
                 f"the reference, max {zs.max():.3f}"),
    }
    if stream == "jax":
        meta.update(stream="jax", note=JAX_STREAM_NOTE)
    print(f"golden_dated: {len(records)} records; median |z| "
          f"{np.median(zs):.2f}, max |z| {zs.max():.2f} (pre_detection "
          f"aside)")
    write_records(out_path(stream_name("golden_dated", stream), out),
                  [meta] + records, {**where, "ref_source": source})
    if stream == "port":
        check(records, points is None and tuple(candidates) == CANDIDATES)
    return [meta] + records


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--samples", type=int, default=SAMPLES)
    ap.add_argument("--points", default=None,
                    help="comma-separated section:W pairs (default: every "
                         "point)")
    ap.add_argument("--candidates", default=",".join(map(str, CANDIDATES)),
                    help="the pre-detection files' candidate caps")
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
              {(s, int(w)) for s, w in (pair.split(":")
                                        for pair in a.points.split(","))})
    main(a.device, a.samples, points,
         tuple(int(m) for m in a.candidates.split(",")), a.batch, a.ref_dir,
         a.out, a.stream)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
