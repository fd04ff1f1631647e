"""Bivariate-bicycle LER / throughput benchmark (code-capacity noise), on
the card.

The port of ``benchmarks/bicycle_ler.py``.  Sweeps the depolarizing error
probability on a BB code (default: the [[144,12,12]] gross code,
``codes/bicycle.py``) with the lifted-graph decode stack and emits one JSON
line per (p, mode):

  python benchmarks_torch/bicycle_ler.py --ps 0.01,0.02,0.03 --count 20000
  python benchmarks_torch/bicycle_ler.py --relay 12 --osd 20   # quality stack
  python benchmarks_torch/bicycle_ler.py --device cpu --code "[[72,12,6]]" \\
      --ps 0.03 --count 128 --batch 64

Modes compose like the flagship harness: flooding min-sum on the lifted
min-sum kernel (K5), optional relay repair (K5 damped), optional OSD on what
still fails: ``--osd 0`` solves on the card (OSD-0, K7), ``--osd LAM > 0``
on the host (``native/gf2.cpp``).  The JAX script's ``--kernel`` and
``--tile`` are TPU choices (its Pallas or XLA engine, the Pallas batch
tile) and are dropped: on a CUDA tensor the port always runs the kernels,
one lane per CTA (the plain versions take 100-800 ms a decode on the card,
PERF.md §6, and no switch routes the sweep through them).

Each record with a counterpart in the JAX package's record
``benchmarks/results/bicycle_gross_r3.jsonl`` (same code, p and mode) is
held to it: |z| < 4 on the corrected fraction (gated).  Records go to
``benchmarks_torch/data/bicycle_ler_h100.jsonl`` (``--out``) and to
standard output.
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
    card,
    emit,
    gate,
    jax_records,
    out_path,
    resolve_device,
    two_proportion_z,
    write_records,
)
from qec_ldpc_tpu_torch.codes import known_bicycle_code  # noqa: E402
from qec_ldpc_tpu_torch.decoder import BPConfig  # noqa: E402
from qec_ldpc_tpu_torch.parallel import (  # noqa: E402
    run_monte_carlo,
    run_monte_carlo_osd,
)
from qec_ldpc_tpu_torch.sampling import make_rank_basis_test  # noqa: E402

Z_LIMIT = 4.0


def jax_row(code: str, mode: str, p: float) -> dict | None:
    for rec in jax_records("results/bicycle_gross_r3.jsonl"):
        if (rec["code"], rec["mode"], rec["p"]) == (code, mode, p):
            return rec
    return None


def main(device: str = "cuda", code: str = "[[144,12,12]]",
         ps=(0.01, 0.02, 0.03, 0.04, 0.05), count: int = 20_000,
         iters: int = 100, batch: int = 2048, steps_per_call: int = 8,
         seed: int = 20260820, osd: int = -1, relay: int = 0,
         out: str | None = None) -> list:
    """One record per p; returns them.  The counts default to the JAX
    script's."""
    device = resolve_device(device)
    where = card(device)
    bb = known_bicycle_code(code)
    graphs = bb.build_graphs()
    test = make_rank_basis_test(bb, device)
    cfg = BPConfig(max_iters=iters, algorithm="min-sum")
    mode = "min-sum"
    if relay:
        mode += f"+relay{relay}"
    if osd >= 0:
        mode += f"+osd{osd}"

    def run(p):
        if osd >= 0:
            return run_monte_carlo_osd(
                graphs, 0, count, p, cfg, seed, batch_size=batch, lam=osd,
                error_model="depolarizing", relay_retries=relay,
                i_minus_p=test, device=device)
        return run_monte_carlo(
            graphs, 0, count, p, cfg, seed, batch_size=batch,
            error_model="depolarizing", steps_per_call=steps_per_call,
            relay_retries=relay, i_minus_p=test, device=device)

    run(ps[0])  # warm-up: builds and loads the kernels (shapes are p-free)
    records = []
    for p in ps:
        t0 = time.perf_counter()
        counters, iters_done = run(p)
        dt = time.perf_counter() - t0
        c = np.asarray(counters, dtype=np.int64)
        rec = {
            "benchmark": "bicycle_ler",
            "code": str(bb),
            "mode": mode,
            "p": p,
            "tested": int(c[0]),
            "corrected_fraction": round(float(c[3] / c[0]), 6),
            "logical_fraction": round(float(c[6] / c[0]), 6),
            "syndrome_fail_fraction": round(float((c[4] + c[5]) / c[0]), 6),
            "samples_per_s": round(c[0] / dt, 1),
            "executed_bp_lane_iters_per_s": round(int(iters_done) / dt, 1),
            "max_iters": iters,
            "seed": seed,
        }
        emit({**rec, **where})
        records.append(rec)
        ref = jax_row(rec["code"], mode, p)
        if ref is None:
            print(f"p={p} {mode}: no JAX record to hold it to", flush=True)
            continue
        z = two_proportion_z(int(c[3]), int(c[0]),
                             round(ref["corrected_fraction"] * ref["tested"]),
                             ref["tested"])
        print(f"p={p} {mode}: corrected {rec['corrected_fraction']} vs JAX "
              f"{ref['corrected_fraction']} of {ref['tested']}: z={z:+.2f}",
              flush=True)
        gate(abs(z) < Z_LIMIT, f"bicycle_ler p={p} {mode}: z={z:+.2f} against "
                               f"benchmarks/results/bicycle_gross_r3.jsonl")
    write_records(out_path("bicycle_ler", out), records, where)
    return records


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--code", default="[[144,12,12]]",
                    help="published BB instance label (codes/bicycle.py)")
    ap.add_argument("--ps", default="0.01,0.02,0.03,0.04,0.05")
    ap.add_argument("--count", type=int, default=20_000)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--steps-per-call", type=int, default=8)
    ap.add_argument("--seed", type=int, default=20260820)
    ap.add_argument("--osd", type=int, default=-1, metavar="LAM",
                    help="-1 off; 0 OSD-0 on the card (K7); > 0 host OSD "
                         "with a lam-column combination sweep")
    ap.add_argument("--relay", type=int, default=0, metavar="RETRIES")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    main(a.device, a.code, tuple(float(x) for x in a.ps.split(",")), a.count,
         a.iters, a.batch, a.steps_per_call, a.seed, a.osd, a.relay, a.out)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
