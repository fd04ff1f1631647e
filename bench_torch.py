#!/usr/bin/env python3
"""Headline benchmark of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 bench_torch.py

Runs the workloads of ``bench.py`` (the JAX package's headline benchmark)
through ``qec_ldpc_tpu_torch`` and prints ONE JSON line with bench.py's
keys.  The headline metric is **samples decoded per second** on the
reference's headline workload: the [[610,61]] code, weight-15 Pauli errors,
p = 0.01, at most 100 sum-product iterations with a convergence check every
10 and early exit, through the whole Monte-Carlo pipeline (sample -> X/Z
syndromes -> decode, K1 on a card -> classify -> counters).  The
reference's CPU harness decoded 887 samples/s on it.  Statistical parity is
a gate in the same run: the corrected fraction must lie within
4 sigma + 1e-4 of the reference's 0.99539 (sigma the binomial standard
error at the run's count).

Secondaries, each timed as its best of ``repeats`` runs after one warm-up:

  * layered min-sum on the headline workload (K3), gated at
    corrected >= 0.99539 - 4 sigma;
  * fixed-work rates: sum-product (K1), min-sum (K2) and layered (K3) with
    the convergence test only at the first iteration (``check_every =
    max_iters + 1``; layered tests none).  The kernels exit per lane, so a
    lane that passes that test stops after one iteration, where JAX's
    kernels run its 128-lane tile on: each chunk is checked to have run
    every lane 100 iterations or 1, and the rate counts the executed
    lane-iterations (X and Z, halved: one iteration-codeword is an X and a
    Z iteration).  Their achieved FLOP/s use bench.py's per-edge counts
    (18, 15 and 14 per edge and iteration);
  * the [[42]] code at W=1, p = 0.02, batch 8192 (K1);
  * the gross code [[144,12,12]], min-sum, depolarizing p = 0.01 (K5),
    gated at corrected > 0.99.

The keys that bench.py derives from its TPU vector-unit peak
(``vpu_peak_*``, ``*_vpu_utilization``) are null: that peak is a TPU
figure.  ``main()`` takes the counts as parameters, bench.py's by default,
so that tests and ``chip_smoke.py`` run it small; a failed gate raises and
prints no result.  It runs on the card unless the caller passes a CPU
device, and never falls back to the CPU.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.codes import known_bicycle_code
from qec_ldpc_tpu_torch.decoder import BPConfig, CodeGraphs
from qec_ldpc_tpu_torch.parallel import mc_chunk, run_monte_carlo
from qec_ldpc_tpu_torch.sampling import C_CORRECTED, C_TESTED, make_rank_basis_test

BASELINE_SAMPLES_PER_S = 887.0       # the reference's headline (bench.py)
BASELINE_ITER_SAMPLES_PER_S = 8.87e4  # 887 samples/s x <= 100 iterations
REFERENCE_CORRECTED_FRACTION = 0.99539
BASELINE_SMALL_CODE_SAMPLES_PER_S = 110_000.0  # [[42]] W=1 p=0.02
MAX_ITERS = 100
WEIGHT = 15
P_ERR = 0.01


def _total_edges(graphs: CodeGraphs) -> int:
    return graphs.x.num_edges + graphs.z.num_edges


# bench.py's analytic float operations per iteration (sweep) of one sample,
# X and Z graphs: a deliberate undercount (no convergence, init or masking)
def bp_flops_per_iter_sample(graphs: CodeGraphs) -> float:
    return 18.0 * _total_edges(graphs)


def min_sum_flops_per_iter_sample(graphs: CodeGraphs) -> float:
    return 15.0 * _total_edges(graphs)


def layered_flops_per_sweep_sample(graphs: CodeGraphs) -> float:
    return 14.0 * _total_edges(graphs)


def gate(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"bench_torch: {what}")


def best_of(run, repeats: int):
    """(last result, first run's seconds, best of ``repeats`` more); each
    ``run`` ends in a host read, so its wall clock covers the device work."""
    t0 = time.perf_counter()
    result = run()
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        result = run()
        best = min(best, time.perf_counter() - t0)
    return result, first, best


def corrected_fraction(counters) -> float:
    return float(counters[C_CORRECTED] / counters[C_TESTED])


def main(device: str = "cuda", batch: int = 2048, headline_chunks: int = 512,
         fixed_chunks: int = 64, small_batch: int = 8192,
         small_chunks: int = 256, gross_chunks: int = 64,
         repeats: int = 3) -> dict:
    """Run every workload on ``device`` and print the JSON line; returns it
    as a dict.  The counts default to bench.py's."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_torch: torch.cuda.is_available() is false; "
                         "the benchmark measures the card")
    code = construct_code(4, 5, 10, 61, 9, 49)
    graphs = CodeGraphs.build(code)
    test = make_rank_basis_test(code, device)

    def monte_carlo(g, weight, chunks, p, cfg, lt, b=batch, **kw):
        return run_monte_carlo(g, weight, chunks * b, p, cfg, seed=1,
                               batch_size=b, steps_per_call=chunks,
                               i_minus_p=lt, device=device, **kw)

    # headline: the reference workload, early exit (a check every 10)
    count = headline_chunks * batch
    ee_cfg = BPConfig(max_iters=MAX_ITERS, check_every=10)
    (counters, lane_iters), first_ee, best_ee = best_of(
        lambda: monte_carlo(graphs, WEIGHT, headline_chunks, P_ERR, ee_cfg,
                            test), repeats)
    tested = int(counters[C_TESTED])
    gate(tested == count, f"headline tested {tested} of {count}")
    fraction = corrected_fraction(counters)
    sigma = (REFERENCE_CORRECTED_FRACTION
             * (1 - REFERENCE_CORRECTED_FRACTION) / tested) ** 0.5
    gate(abs(fraction - REFERENCE_CORRECTED_FRACTION) < 4 * sigma + 1e-4,
         f"headline corrected fraction {fraction} off the reference's "
         f"{REFERENCE_CORRECTED_FRACTION} (4 sigma = {4 * sigma:.6f})")
    samples_per_s = tested / best_ee

    # layered min-sum on the same workload: a stronger decoder, one-sided
    ly_cfg = BPConfig(max_iters=MAX_ITERS, algorithm="layered-min-sum")
    (ly_counters, _), _, best_ly = best_of(
        lambda: monte_carlo(graphs, WEIGHT, headline_chunks, P_ERR, ly_cfg,
                            test), repeats)
    ly_fraction = corrected_fraction(ly_counters)
    gate(ly_fraction >= REFERENCE_CORRECTED_FRACTION - 4 * sigma,
         f"layered corrected fraction {ly_fraction}")
    layered_samples_per_s = int(ly_counters[C_TESTED]) / best_ly

    # fixed work: a lane stops only where it passes the first iteration's
    # test, so each graph of a chunk runs batch * 100 - 99 * k
    # lane-iterations, k the lanes that passed it
    def fixed_work_rate(algorithm: str) -> float:
        cfg = BPConfig(max_iters=MAX_ITERS, check_every=MAX_ITERS + 1,
                       layered_check_every=MAX_ITERS + 1, algorithm=algorithm)

        def run():
            counters = torch.zeros(9, dtype=torch.int64, device=device)
            executed = torch.zeros((), dtype=torch.int64, device=device)
            off = torch.zeros((), dtype=torch.int64, device=device)
            for c in range(fixed_chunks):
                cnt, its = mc_chunk(graphs, test, 0, c, WEIGHT, P_ERR, cfg,
                                    batch, device=device)
                counters += cnt
                executed += its.sum()
                off += ((MAX_ITERS * batch - its) % (MAX_ITERS - 1)).sum()
            return torch.cat([counters, executed[None], off[None]]).cpu()

        host, _, best = best_of(run, repeats)
        gate(int(host[C_TESTED]) == fixed_chunks * batch,
             f"{algorithm} fixed work tested {int(host[C_TESTED])}")
        gate(int(host[-1]) == 0,
             f"{algorithm} fixed work: a lane stopped after a later test")
        return int(host[-2]) / 2 / best

    iter_samples_per_s = fixed_work_rate("sum-product")
    ms_iter_per_s = fixed_work_rate("min-sum")
    ly_iter_per_s = fixed_work_rate("layered-min-sum")

    # the [[42]] code: small graphs, where launch overhead shows
    small = CodeGraphs.build(construct_code(3, 3, 6, 7, 2, 3))
    small_test = make_rank_basis_test(small.code, device)
    sm_cfg = BPConfig(max_iters=MAX_ITERS, check_every=10)
    (sm_counters, _), _, best_sm = best_of(
        lambda: monte_carlo(small, 1, small_chunks, 0.02, sm_cfg, small_test,
                            b=small_batch), repeats)
    small_samples_per_s = int(sm_counters[C_TESTED]) / best_sm

    # the gross code [[144,12,12]]: min-sum on the lifted graph (K5)
    gross = known_bicycle_code("[[144,12,12]]").build_graphs()
    gross_test = make_rank_basis_test(gross.code, device)
    bb_cfg = BPConfig(max_iters=MAX_ITERS, algorithm="min-sum")
    (bb_counters, _), _, best_bb = best_of(
        lambda: monte_carlo(gross, 0, gross_chunks, P_ERR, bb_cfg, gross_test,
                            error_model="depolarizing"), repeats)
    bb_fraction = corrected_fraction(bb_counters)
    gate(bb_fraction > 0.99, f"gross corrected fraction {bb_fraction}")
    bb_samples_per_s = int(bb_counters[C_TESTED]) / best_bb

    achieved_flops = iter_samples_per_s * bp_flops_per_iter_sample(graphs)
    result = {
        "metric": "samples_per_s_per_chip_reference_headline_workload",
        "value": round(samples_per_s, 1),
        "unit": ("samples/s/chip ([[610,61]], W=15, p=0.01, MAX=100, "
                 "early exit, full pipeline sample+X/Z decode+classify, "
                 "sum-product CUDA kernel; reference CPU: 887 samples/s "
                 "on the identical workload)"),
        "vs_baseline": round(samples_per_s / BASELINE_SAMPLES_PER_S, 2),
        "corrected_fraction": round(fraction, 5),
        "reference_corrected_fraction": REFERENCE_CORRECTED_FRACTION,
        "executed_bp_lane_iters_per_s": round(int(lane_iters) / best_ee, 1),
        "layered_min_sum_samples_per_s": round(layered_samples_per_s, 1),
        "layered_min_sum_vs_baseline": round(
            layered_samples_per_s / BASELINE_SAMPLES_PER_S, 2),
        "layered_min_sum_corrected_fraction": round(ly_fraction, 5),
        "fixed_work_bp_iter_codewords_per_s_per_chip": round(
            iter_samples_per_s, 1),
        "fixed_work_vs_baseline": round(
            iter_samples_per_s / BASELINE_ITER_SAMPLES_PER_S, 2),
        "achieved_vpu_flops_per_s": round(achieved_flops, 1),
        "vpu_peak_estimate_flops_per_s": None,
        "vpu_peak_measured_flops_per_s": None,
        "vpu_utilization": None,
        "min_sum_fixed_work_iter_cw_per_s": round(ms_iter_per_s, 1),
        "min_sum_achieved_flops_per_s": round(
            ms_iter_per_s * min_sum_flops_per_iter_sample(graphs), 1),
        "min_sum_vpu_utilization": None,
        "layered_fixed_work_sweep_cw_per_s": round(ly_iter_per_s, 1),
        "layered_achieved_flops_per_s": round(
            ly_iter_per_s * layered_flops_per_sweep_sample(graphs), 1),
        "layered_vpu_utilization": None,
        "device_kind": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else device.type),
        # the first headline run includes building the kernels
        "headline_first_dispatch_s": round(first_ee, 2),
        "headline_steady_dispatch_s": round(best_ee, 2),
        "headline_compile_phase_s": round(max(first_ee - best_ee, 0.0), 2),
        "small_code_42_samples_per_s": round(small_samples_per_s, 1),
        "small_code_42_vs_baseline": round(
            small_samples_per_s / BASELINE_SMALL_CODE_SAMPLES_PER_S, 2),
        "small_code_42_corrected_fraction": round(
            corrected_fraction(sm_counters), 5),
        "bicycle_gross_samples_per_s": round(bb_samples_per_s, 1),
        "bicycle_gross_corrected_fraction": round(bb_fraction, 5),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
    sys.exit(0)
