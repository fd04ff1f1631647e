"""The logical-error-rate curve against the reference's golden corpus, on
the card.

The port of ``benchmarks/ler_sweep.py``: the production Monte-Carlo
driver (``parallel/montecarlo.py::run_monte_carlo``, early exit on, each
lane's own iterations counted; ``run_monte_carlo_osd`` with ``--osd``) over
a weight sweep on the [[610,61]] flagship code, one JSON line per weight,
beside the reference's fractions where the corpus has the point.  On the
card ``sum-product`` launches K1, ``min-sum`` K2 (K4 at P >= 768),
``layered-min-sum`` K3, ``--relay`` K2 damped and ``--osd 0`` K7.

Corpus provenance (established on the JAX package, 2026-08): the
reference's [[610,61]] files labelled ``p_0.01`` and ``p_0.02`` hold
statistically identical fractions, and both match the decoder only at the
BP prior 2/3 * 0.02; so the sweep decodes at ``--p 0.02`` by default and
reads the reference from the ``p_0.01``-labelled files
(``--ref-label-p``).

The reference's counts come from the committed JAX record of the code's
sweep (``benchmarks/data/golden_sweep_r3.jsonl`` for [[610,61]], whose
``p_0.01`` rows are the files the JAX script reads;
``golden_sweep42_deep_r5.jsonl`` for [[42,0]]) unless ``--ref-dir`` names
the corpus's ``results`` directory (``common.reference_points``).  Gate,
in run, with the reference's decoder (sum-product, no relay or OSD): the
corrected fraction within |z| < 4.5 of the reference's where it has the
point (the golden sweep's gate on the same files).

Every line is printed and written to ``benchmarks_torch/data/
ler_sweep_h100.jsonl`` (``--out``), with the card's name and power limit
and ``ref_source``.  The count is rounded up to whole groups of
``--steps-per-call`` chunks (the driver's host fetches), and each weight
runs one group first as a warm-up.

    python benchmarks_torch/ler_sweep.py --weights 10,20,30,40,50 --count 10000
    python benchmarks_torch/ler_sweep.py --device cpu --weights 1 --count 64 \\
        --batch 64 --steps-per-call 1 --iters 10
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmarks_torch.common import (  # noqa: E402
    FLAGSHIP,
    card,
    emit,
    gate,
    out_path,
    reference_points,
    resolve_device,
    write_records,
)
from benchmarks_torch.golden_deep import _z  # noqa: E402
from qec_ldpc_tpu_torch import construct_code  # noqa: E402
from qec_ldpc_tpu_torch.decoder import BPConfig, CodeGraphs  # noqa: E402
from qec_ldpc_tpu_torch.parallel import (  # noqa: E402
    run_monte_carlo,
    run_monte_carlo_osd,
)
from qec_ldpc_tpu_torch.sampling import (  # noqa: E402
    C_CONV_X,
    C_CONV_Z,
    C_CORRECTED,
    C_LOGICAL,
    C_SYN_X,
    C_SYN_Z,
    C_TESTED,
)


def reference_fractions(points: list, weight: int, max_iters: int,
                        p_label: float):
    """(corrected, logical, tested) of the reference at this weight, cap
    and file-name p, summed over its files, or None.  ``points``:
    ``common.reference_points("ler_sweep", ...)``'s."""
    match = [pt.counts for pt in points if (pt.weight, pt.max_iters, pt.p)
             == (weight, max_iters, p_label)]
    if not match:
        return None
    tested = sum(c["tested"] for c in match)
    corrected = sum(c["corrected"] for c in match)
    logical = sum(c["logical"] for c in match)
    return corrected / tested, logical / tested, tested


def main(device: str = "cuda", code=FLAGSHIP, weights=(10, 20, 30, 40, 50),
         count: int = 10_000, iters: int = 100, p: float = 0.02,
         ref_label_p: float = 0.01, algorithm: str = "sum-product",
         batch: int = 2048, steps_per_call: int = 32,
         seed: int = 20260818, osd: int = -1, relay: int = 0,
         ref_dir: str | None = None, out: str | None = None) -> list:
    """One record per weight; returns them."""
    device = resolve_device(device)
    points, source = reference_points("ler_sweep", ref_dir, tuple(code))
    qcode = construct_code(*code)
    graphs = CodeGraphs.build(qcode)
    cfg = BPConfig(max_iters=iters, algorithm=algorithm)
    # whole groups: every weight runs the same number of host fetches,
    # one group first as a warm-up
    group = batch * steps_per_call
    count = -(-count // group) * group
    records = []
    for w in weights:
        if osd >= 0:
            # the quality mode (relay optionally first)
            run_monte_carlo_osd(graphs, w, batch, p, cfg, seed=seed + w,
                                batch_size=batch, lam=osd,
                                relay_retries=relay, device=device)
            t0 = time.perf_counter()
            counters, bp_iters = run_monte_carlo_osd(
                graphs, w, count, p, cfg, seed=seed + w, batch_size=batch,
                lam=osd, relay_retries=relay, device=device)
        else:
            run_monte_carlo(graphs, w, group, p, cfg, seed=seed + w,
                            batch_size=batch, steps_per_call=steps_per_call,
                            relay_retries=relay, device=device)
            t0 = time.perf_counter()
            counters, bp_iters = run_monte_carlo(
                graphs, w, count, p, cfg, seed=seed + w, batch_size=batch,
                steps_per_call=steps_per_call, relay_retries=relay,
                device=device)
        secs = time.perf_counter() - t0
        tested = int(counters[C_TESTED])
        rec = {
            "metric": "ler_sweep",
            "algorithm": algorithm,
            "osd": osd,
            "relay": relay,
            "weight": w,
            "p": p,
            "max_iters": iters,
            "tested": tested,
            "corrected_frac": round(counters[C_CORRECTED] / tested, 5),
            "logical_frac": round(counters[C_LOGICAL] / tested, 5),
            "syndrome_fail_frac": round(
                (counters[C_SYN_X] + counters[C_SYN_Z]) / tested, 5),
            "convergence_fail_frac": round(
                (counters[C_CONV_X] + counters[C_CONV_Z]) / tested, 5),
            "samples_per_s": round(tested / secs, 1),
            "bp_iters_total": int(bp_iters),
        }
        ref = reference_fractions(points, w, iters, ref_label_p)
        if ref is not None:
            rec["ref_corrected_frac"] = round(ref[0], 5)
            rec["ref_logical_frac"] = round(ref[1], 5)
            rec["ref_tested"] = ref[2]
            if algorithm == "sum-product" and osd < 0 and relay == 0:
                z = _z(round(ref[0] * ref[2]), ref[2],
                       int(counters[C_CORRECTED]), tested)
                gate(abs(z) < 4.5, f"ler_sweep W={w}: corrected z = {z} "
                                   f"against the reference")
        emit(rec)
        records.append(rec)
    write_records(out_path("ler_sweep", out), records,
                  {**card(device), "ref_source": source})
    return records


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--code", type=int, nargs=6, default=list(FLAGSHIP),
                    metavar=("J", "K", "L", "P", "sigma", "tau"))
    ap.add_argument("--weights", default="10,20,30,40,50")
    ap.add_argument("--count", type=int, default=10_000)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--p", type=float, default=0.02,
                    help="decode prior p (default 0.02: what the [[610]] "
                         "corpus actually used; see the provenance note)")
    ap.add_argument("--ref-label-p", type=float, default=0.01,
                    help="p as it appears in reference file names")
    ap.add_argument("--algorithm", default="sum-product",
                    help="sum-product (reference-faithful) | min-sum | "
                         "layered-min-sum")
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--steps-per-call", type=int, default=32,
                    help="chunks per host fetch of the Monte-Carlo driver")
    ap.add_argument("--seed", type=int, default=20260818)
    ap.add_argument("--osd", type=int, default=-1, metavar="LAM",
                    help="OSD post-processing of BP failures: -1 off, 0 "
                         "OSD-0 (K7 on the card), >0 combination-sweep "
                         "depth (the quality mode)")
    ap.add_argument("--relay", type=int, default=0, metavar="RETRIES",
                    help="relay repairs before OSD: the number of "
                         "randomised damped min-sum retries")
    ap.add_argument("--ref-dir", default=None,
                    help="the corpus's results directory (default: the "
                         "reference's counts in the JAX records)")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    main(a.device, tuple(a.code), tuple(int(x) for x in a.weights.split(",")),
         a.count, a.iters, a.p, a.ref_label_p, a.algorithm, a.batch,
         a.steps_per_call, a.seed, a.osd, a.relay, a.ref_dir, a.out)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
