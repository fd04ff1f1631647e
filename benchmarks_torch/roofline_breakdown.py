"""Where the non-compute time goes: a measured roofline breakdown on the
card.

The port of ``benchmarks/roofline_breakdown.py``, the experiments that
exist on this card:

1. **Peak reality**: the float32 rate of a pure fma chain, a pure multiply
   chain and a multiply-min pair chain, each a dependent chain per element
   in registers (``kernels/peak_chain_cuda.py`` -> ``csrc/peak_chain.cu``;
   a chain of PyTorch elementwise calls would measure device-memory
   traffic, not the FP32 pipes), the last timed call held bit for bit to
   its plain PyTorch version on the same inputs (gated).  Recorded beside
   the 67 TFLOP/s data-sheet figure (H100 SXM, float32 outside the tensor
   cores) that PERF.md §2's bounds divide by.
2. **Per-algorithm achieved op rate**: fixed-work executed lane-iterations/s
   of sum-product (K1), min-sum (K2) and layered min-sum (K3) through the
   pipeline (``benchmarks_torch/common.py::fixed_work_rate``) times
   bench.py's analytic op models.
4. **Convergence-check cost**: min-sum at W=58 (most lanes never converge)
   with a test every 10 iterations against none, per executed
   lane-iteration.
6. **HBM stream**: 64 passes of ``y + 1`` (in place) over a 256 MB float32
   tensor: 8 bytes an element a pass.

Experiments 3 (``kernel_roll_impl='mxu'``: permutation matmuls on the TPU's
matrix unit) and 5 (the Pallas batch tile) are TPU choices with no
counterpart here: the port emits no rows for them.  The JAX record's
``nominal_issue_slots_per_s`` (the TPU's VPU slots) is null; the card's
data-sheet rate is ``datasheet_fp32_flops_per_s`` and ``fraction_of_nominal``
is taken against it.  Every decode runs the kernels on the card (the plain
versions take 100-800 ms a decode there, PERF.md §6; no switch routes the
experiments through them).

    python benchmarks_torch/roofline_breakdown.py [--out PATH]
    python benchmarks_torch/roofline_breakdown.py --device cpu --small
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmarks_torch.common import (  # noqa: E402
    FLOP_MODELS,
    best_of,
    bits_equal,
    card,
    event_time,
    fixed_work_rate,
    gate,
    out_path,
    resolve_device,
    run_chunks,
    write_records,
)
from qec_ldpc_tpu_torch import construct_code  # noqa: E402
from qec_ldpc_tpu_torch.decoder import BPConfig, CodeGraphs  # noqa: E402
from qec_ldpc_tpu_torch.kernels.peak_chain_cuda import (  # noqa: E402
    FLOPS_PER_OP,
    peak_chain,
    peak_chain_plain,
)
from qec_ldpc_tpu_torch.sampling import make_rank_basis_test  # noqa: E402

#: H100 SXM data sheet: float32 outside the tensor cores, HBM3 bandwidth
DATASHEET_FP32_FLOPS = 67e12
DATASHEET_BYTES_PER_S = 3.35e12
EXPERIMENTS = ("peak", "achieved", "check", "hbm")
CHAIN_A, CHAIN_B = 0.9999999, 1e-7


def main(device: str = "cuda", experiments=EXPERIMENTS,
         chain_n: int = 2 * 1024 * 1024, depth: int = 192, reps: int = 128,
         batch: int = 2048, chunks: int = 64, iters: int = 100,
         stream_n: int = 64 * 1024 * 1024, passes: int = 64,
         repeats: int = 3, out: str | None = None) -> list:
    """The experiments named in ``experiments``; returns the records (meta
    line first).  The sizes default to the JAX script's."""
    device = resolve_device(device)
    where = card(device)
    records = []
    mul_ops = None

    if "peak" in experiments:
        # every element its own start, so that an element read or written
        # at another's index shows: b * U[0.5, 1.5), where min(y * a, b)
        # keeps some chains below b and sends the others to b
        gen = torch.Generator(device=device).manual_seed(0)
        x = CHAIN_B * (0.5 + torch.rand(chain_n, generator=gen,
                                        device=device))
        rates = {}
        for op in ("fma", "mul", "min"):
            last = {}

            def run(op=op):
                last["y"] = peak_chain(x, op, depth, reps, CHAIN_A, CHAIN_B)

            secs = event_time(run, repeats)
            # the last timed call against the plain version, whole grid
            # and whole chain
            gate(bits_equal(last["y"], peak_chain_plain(
                x, op, depth, reps, CHAIN_A, CHAIN_B)),
                 f"peak_chain {op} differs from its plain version")
            rates[op] = depth * reps * chain_n / secs  # applications / s
        mul_ops = rates["mul"]
        records.append({
            "experiment": "peak_reality",
            "device_kind": where["device_kind"],
            "nominal_issue_slots_per_s": None,
            "fma_ops_per_s": round(rates["fma"], 1),
            "fma_flops_per_s": round(FLOPS_PER_OP["fma"] * rates["fma"], 1),
            "mul_ops_per_s": round(rates["mul"], 1),
            "mul_min_pair_ops_per_s": round(rates["min"], 1),
            "datasheet_fp32_flops_per_s": DATASHEET_FP32_FLOPS,
        })
        print(f"peak: fma {2 * rates['fma'] / 1e12:.2f} TFLOP/s, mul "
              f"{rates['mul'] / 1e12:.2f} Tops/s, mul+min "
              f"{rates['min'] / 1e12:.2f} Tpairs/s (data sheet "
              f"{DATASHEET_FP32_FLOPS / 1e12:.0f} TFLOP/s)", flush=True)

    code = construct_code(4, 5, 10, 61, 9, 49)
    graphs = CodeGraphs.build(code)
    test = make_rank_basis_test(code, device)

    if "achieved" in experiments:
        for algo in ("sum-product", "min-sum", "layered-min-sum"):
            rate = fixed_work_rate(
                graphs, test, algo, weight=15, error_probability=0.01,
                max_iters=iters, batch=batch, chunks=chunks, repeats=repeats,
                device=device)[0]
            model = FLOP_MODELS[algo](graphs)
            flops = rate * model
            records.append({
                "experiment": "achieved", "algorithm": algo,
                "fixed_work_iter_cw_per_s": round(rate, 1),
                "flop_model_per_iter_sample": model,
                "achieved_flops_per_s": round(flops, 1),
                "fraction_of_nominal": round(flops / DATASHEET_FP32_FLOPS, 4),
                "fraction_of_measured_mul": (round(flops / mul_ops, 4)
                                             if mul_ops else None),
            })
            print(f"{algo}: {rate / 1e6:.1f}M iter-cw/s -> "
                  f"{flops / 1e12:.3f} TFLOP/s by the model "
                  f"({flops / DATASHEET_FP32_FLOPS:.2%} of the data sheet)",
                  flush=True)

    if "check" in experiments:
        # W=58: most lanes never converge within the cap, so the checked
        # run executes nearly full work; per executed lane-iteration the
        # two compare
        def executed_rate(check: bool) -> float:
            cfg = BPConfig(max_iters=iters,
                           check_every=10 if check else iters + 1,
                           algorithm="min-sum")

            (_, its), _, best = best_of(
                lambda: run_chunks(graphs, test, cfg, seed=0, weight=58,
                                   error_probability=0.01, batch=batch,
                                   chunks=chunks, device=device), repeats)
            return int(its.sum()) / 2 / best

        unchecked, checked = executed_rate(False), executed_rate(True)
        records.append({
            "experiment": "convergence_check",
            "unchecked_iter_cw_per_s": round(unchecked, 1),
            "checked_every10_iter_cw_per_s": round(checked, 1),
            "check_overhead_fraction": round(1 - checked / unchecked, 4),
        })
        print(f"check cost: {1 - checked / unchecked:.1%} of iteration time",
              flush=True)

    if "hbm" in experiments:
        y = torch.zeros(stream_n, dtype=torch.float32, device=device)

        def bump():
            for _ in range(passes):
                y.add_(1.0)

        bw = passes * 2 * 4 * stream_n / event_time(bump, repeats)
        edge_state = (graphs.x.num_edges + graphs.z.num_edges) * 4 * batch
        records.append({
            "experiment": "hbm_bandwidth",
            "measured_stream_bytes_per_s": round(bw, 1),
            "edge_state_bytes_at_batch2048": edge_state,
            "per_iteration_hbm_floor_seconds": round(2 * edge_state / bw, 6),
            "note": ("floor for ANY per-iteration kernel between halo "
                     "collectives (the edge state read and written once); "
                     "the decode kernels keep a lane's state in shared "
                     "memory for the whole loop instead"),
            "datasheet_bytes_per_s": DATASHEET_BYTES_PER_S,
        })
        print(f"HBM stream: {bw / 1e9:.0f} GB/s; per-iteration floor "
              f"{2 * edge_state / bw * 1e3:.3f} ms at batch {batch}",
              flush=True)

    records.insert(0, {
        "artifact": "roofline_breakdown", "device_kind": where["device_kind"],
        "note": ("controlled decomposition of the gap to peak on the card: "
                 "FP32 issue rate (fma, mul and mul+min chains in "
                 "registers, csrc/peak_chain.cu), per-algorithm achieved op "
                 "rates by bench.py's models, convergence-check cost, HBM "
                 "stream; the TPU-only experiments (mxu routing, Pallas "
                 "tile) have no rows"),
    })
    write_records(out_path("roofline_breakdown", out), records, where)
    return records


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--experiments", default=",".join(EXPERIMENTS))
    ap.add_argument("--small", action="store_true",
                    help="tiny sizes: a functional run")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    sizes = (dict(chain_n=4096, depth=4, reps=2, batch=64, chunks=1,
                  stream_n=4096, passes=4) if a.small else {})
    main(a.device, tuple(a.experiments.split(",")), out=a.out, **sizes)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
