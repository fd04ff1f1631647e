"""Single-card decode-throughput matrix: one record per algorithm.

The port of ``benchmarks/throughput.py``.  Runs the full Monte-Carlo
pipeline (sample -> syndromes -> batched X/Z decode -> classify ->
counters, ``parallel/montecarlo.py::mc_chunk``) at a fixed iteration cap
for each requested algorithm: sum-product (K1), min-sum (K2) and layered
min-sum (K3) on the card:

  python benchmarks_torch/throughput.py                 # default matrix
  python benchmarks_torch/throughput.py --algorithms sum-product,min-sum \\
      --iters 100 --batch 2048 --chunks 64
  python benchmarks_torch/throughput.py --device cpu --batch 64 --chunks 1

The JAX script asserts that every lane ran ``iters`` iterations.  The
port's kernels exit per lane, so a lane that passes the convergence test
at the first iteration (the only one at ``check_every = iters + 1``) stops
there; the rule of ``benchmarks_torch/common.py::fixed_work_rate``
(bench_torch's) applies instead: every lane ran ``iters`` iterations or 1,
which is gated, and the rate counts the executed lane-iterations.

The JAX script's ``algorithm:engine`` pairs (pallas / xla) have no
counterpart: on a CUDA tensor the port always runs the algorithm's kernel
(``decoder/sum_product.py``), so each record says ``"kernel": "cuda"``.
The plain PyTorch versions take 100-800 ms a decode on the card (PERF.md
§6), minutes for a 64-chunk matrix; there is no switch to route the
pipeline through them.

Baseline: the reference CPU harness at W=15/MAX=100/p=0.01 decodes 887
samples/s, i.e. <= 8.87e4 BP-iteration*samples/s for the whole machine
(SURVEY §6).  Records go to ``benchmarks_torch/data/throughput_h100.jsonl``
(``--out``) and to standard output.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmarks_torch.common import (  # noqa: E402
    BASELINE_ITER_SAMPLES_PER_S,
    card,
    emit,
    fixed_work_rate,
    out_path,
    resolve_device,
    route,
    write_records,
)
from qec_ldpc_tpu_torch import construct_code  # noqa: E402
from qec_ldpc_tpu_torch.decoder import CodeGraphs  # noqa: E402
from qec_ldpc_tpu_torch.sampling import make_rank_basis_test  # noqa: E402

ALGORITHMS = ("sum-product", "min-sum", "layered-min-sum")


def main(device: str = "cuda", code=(4, 5, 10, 61, 9, 49),
         algorithms=ALGORITHMS, iters: int = 100, batch: int = 2048,
         chunks: int = 64, weight: int = 15, p: float = 0.01,
         repeats: int = 3, out: str | None = None) -> list:
    """One record per algorithm; returns them.  The counts default to the
    JAX script's.  Each record also carries the executed lane-iterations
    and the counters of the timed run (``executed_lane_iters``,
    ``counters``), which equal ``bench_torch``'s fixed-work run on the same
    seed."""
    device = resolve_device(device)
    where = card(device)
    code = construct_code(*code)
    graphs = CodeGraphs.build(code)
    test = make_rank_basis_test(code, device)
    records = []
    for algorithm in algorithms:
        rate, executed, counters, secs = fixed_work_rate(
            graphs, test, algorithm, weight=weight, error_probability=p,
            max_iters=iters, batch=batch, chunks=chunks, repeats=repeats,
            device=device)
        samples = chunks * batch
        rec = {
            "metric": "bp_iteration_codewords_per_s_per_chip",
            "algorithm": algorithm,
            "kernel": route(device),
            "value": round(rate, 1),
            "samples_per_s": round(samples / secs, 1),
            "unit": (f"BP-iter*codewords/s/card (full pipeline, n={code.n} "
                     f"code, fixed {iters} iters, a lane that passes the "
                     f"first test stops: executed lane-iterations, "
                     f"{chunks}x{batch} samples/run)"),
            "vs_baseline": round(rate / BASELINE_ITER_SAMPLES_PER_S, 2),
            "executed_lane_iters": executed,
            "counters": [int(c) for c in counters],
        }
        emit({**rec, **where})
        records.append(rec)
    write_records(out_path("throughput", out), records, where)
    return records


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--code", type=int, nargs=6, default=[4, 5, 10, 61, 9, 49],
                    metavar=("J", "K", "L", "P", "sigma", "tau"))
    ap.add_argument("--algorithms", default=",".join(ALGORITHMS))
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--chunks", type=int, default=64)
    ap.add_argument("--weight", type=int, default=15)
    ap.add_argument("--p", type=float, default=0.01)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    main(a.device, tuple(a.code), tuple(a.algorithms.split(",")), a.iters,
         a.batch, a.chunks, a.weight, a.p, out=a.out)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
