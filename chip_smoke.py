#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives each decode path of the port through ``run_monte_carlo``, the entry
point a user calls, and holds every CUDA kernel of those paths against its
plain PyTorch version on the card.  The headline workload is the
reference's: the [[610,61]] code, weight-15 Pauli errors, p = 0.01, up to
100 iterations; the lifted-graph workload is bench.py's ``bicycle_gross``
line: the gross code [[144,12,12]], depolarizing p = 0.01.  Fails (non-zero
exit) if any phase fails:

  1. device  needs CUDA; prints the card's name and power limit
  2. build   compiles the five CUDA sources (csrc/bp_sum_product.cu,
             min_sum.cu, layered_min_sum.cu, lifted_min_sum.cu,
             lifted_bp.cu) with nvcc, all at once, and prints ptxas's
             register and spill lines
  3. check   K1 (sum-product) vs the plain PyTorch BP on the card:
             [[610,61]] X and Z at batch 2048, early exit and fixed 100
             iterations, and the [[42]] code at 30 fixed iterations
  4. time    K1: fixed-work X decode at batch 2048, kernel vs plain
  5. main    sum-product run_monte_carlo on the headline workload, 64
             chunks of 2048, after a warm-up that may synchronise with the
             host only once per group of chunks; every chunk must launch K1
             twice (X and Z), and the corrected fraction must lie within
             4 sigma + 1e-4 of the reference's 0.99539 (the gate of bench.py)
  6. check   K2 (min-sum): [[610,61]] X and Z at batch 2048 with early exit
             and fixed 100 iterations, [[42]] at 30 fixed iterations, and a
             damped run with random gammas; K3 (layered min-sum): [[610,61]]
             X and Z with a parity test every sweep and 100 fixed sweeps,
             [[42]]; K4 (min-sum, P >= 768 route): the P=1051 probe code X
             and Z at batch 2048, fixed 20 iterations and early exit
  7. time    K2 100 iterations and K3 100 sweeps on [[610,61]] X, K4 20
             iterations on the P=1051 X graph, batch 2048, kernel vs plain
  8. main    run_monte_carlo with layered min-sum and with min-sum (check
             every 10) on the headline workload, each gated by bench.py's
             gate for layered (corrected >= 0.99539 - 4 sigma), and min-sum
             on the P=1051 probe code (W=258, 10 iterations), held to the
             JAX package's 1861 of 2048 corrected by a two-proportion test
             (|z| < 4); each run must launch its kernel twice per chunk and
             synchronise at most once per group in a 2-group warm-up
  9. relay   [[610,61]], W=40, p=0.02, min-sum with 16 relay retries, 8
             chunks of 2048: the BP failure rate and the repair rate are
             held to the JAX package's tuning run (509 failures in 12,288
             samples, 0.7367 repaired) by two-proportion tests (|z| < 4),
             and every repaired lane must satisfy its syndrome
 10. check   K5 (lifted min-sum) and K6 (lifted sum-product): the gross
             code X and Z at batch 2048 with early exit and fixed 100
             iterations, K5 damped with random gammas, the d=32 toric code
             X and Z at 20 fixed iterations (P = 1024, which must not take
             the circulant wide route) and [[756,16,34]] X at 20 fixed
             iterations
 11. time    K5 and K6: 100 iterations on the gross X graph, batch 2048,
             kernel vs plain
 12. main    run_monte_carlo on the gross code, depolarizing p = 0.01, 64
             chunks of 2048: min-sum held to the JAX package's record
             (benchmarks/results/bicycle_gross_r3.jsonl line 2) and
             sum-product to a JAX-package CPU run (GROSS_SUM_PRODUCT) by
             two-proportion tests (|z| < 4); each run launches its kernel
             twice per chunk and syncs at most once per group
 13. relay   the gross code at p = 0.03, min-sum with 8 relay retries, 4
             chunks: K5 must launch damped retries and every repaired lane
             must satisfy its syndrome; the repair rate is printed

A check passes with 0 mismatches: finite messages bit for bit, NaN masks,
decisions, failure flags and the max iteration count.  The last three lines
are the card's ``nvidia-smi`` name and power limit, a JSON object
describing each kernel (with its bound: the larger of its float operations
over 67 TFLOP/s and its bytes over 3.35 TB/s), and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.codes import find_code_params, known_bicycle_code, toric_code
from qec_ldpc_tpu_torch.decoder import layered, min_sum, sum_product
from qec_ldpc_tpu_torch.decoder.decode import (
    BPConfig,
    CodeGraphs,
    decide,
    decode_batch,
    syndrome_fail,
)
from qec_ldpc_tpu_torch.decoder.relay import relay_decode_batch
from qec_ldpc_tpu_torch.harness.stats import CodeStatistics
from qec_ldpc_tpu_torch.kernels import (
    bp_cuda,
    build,
    layered_cuda,
    lifted_bp_cuda,
    lifted_min_sum_cuda,
    min_sum_cuda,
)
from qec_ldpc_tpu_torch.parallel.montecarlo import (
    chunk_generator,
    relay_generator,
    run_monte_carlo,
)
from qec_ldpc_tpu_torch.sampling import (
    C_CORRECTED,
    C_LOGICAL,
    C_TESTED,
    make_rank_basis_test,
)
from qec_ldpc_tpu_torch.sampling.errors import (
    sample_depolarizing_errors,
    sample_weight_w_errors,
)

from workloads import (
    BATCH,
    CHUNKS,
    GROSS,
    GROSS_P,
    GROSS_RELAY_CHUNKS,
    GROSS_RELAY_P,
    GROSS_RELAY_RETRIES,
    HEADLINE_CODE,
    MAX_ITERS,
    P_ERR,
    RELAY_CHUNKS,
    RELAY_P,
    RELAY_RETRIES,
    RELAY_WEIGHT,
    STEPS_PER_CALL,
    WEIGHT,
)

REFERENCE_CORRECTED_FRACTION = 0.99539  # bench.py: the reference's 100k run
# the P=1051 probe of benchmarks/large_code_real.py (min-sum, 10 iterations,
# W = round(15 n / 610)); the JAX package's XLA and Pallas rows agree:
# 1861 of 2048 corrected (benchmarks/data/large_code_real_r5.jsonl:18-22)
PROBE_P = 1051
PROBE_ITERS = 10
PROBE_CHUNKS = 4
PROBE_CORRECTED = (1861, 2048)
# the JAX package's tuning run at the relay setting (RELAY_*)
RELAY_BP_FAILURES = (509, 12288)
RELAY_REPAIRED = (375, 509)  # repair rate 0.7367
# the JAX package's min-sum record at the gross setting: corrected 0.999454 of
# 262,144 (benchmarks/results/bicycle_gross_r3.jsonl line 2)
GROSS_MIN_SUM_CORRECTED = (262001, 262144)
# the JAX package's sum-product (XLA path) on the CPU at this setting,
# counters [262144, 162528, 162472, 261945, 109, 90, 1, 0, 1] from
#   run_monte_carlo(known_bicycle_code("[[144,12,12]]").build_graphs(), 0,
#       262144, 0.01, BPConfig(max_iters=100, kernel="xla"), seed=1,
#       batch_size=2048, error_model="depolarizing", steps_per_call=8)
GROSS_SUM_PRODUCT_CORRECTED = (261945, 262144)

LIBRARIES = (("qec_bp", bp_cuda.SOURCES), ("qec_min_sum", min_sum_cuda.SOURCES),
             ("qec_layered", layered_cuda.SOURCES),
             ("qec_lifted_min_sum", lifted_min_sum_cuda.SOURCES),
             ("qec_lifted_bp", lifted_bp_cuda.SOURCES))
KERNEL_MODULES = (bp_cuda, min_sum_cuda, layered_cuda, lifted_min_sum_cuda,
                  lifted_bp_cuda)

# The bound of a fixed-work decode: the larger of its float operations over
# the H100 SXM's 67 TFLOP/s (float32 outside the tensor cores) and its bytes
# over 3.35 TB/s (each input read once, each output written once).  The
# operations per edge and iteration are counted from the plain versions:
#   sum-product  CN 1-2v (2), prefix/suffix/leave-one-out products (3),
#                0.5 - s*prod (2); VN 1-e (1), products of e and 1-e (6),
#                p*prod (1), fma (2), division (1)                      = 18
#   min-sum      CN |v|, sign, 3 minima, 3 sign products, 3 multiplies
#                (11); VN prefix/suffix/leave-one-out sums, + prior (4) = 15
#   damped       + 1-d, d*v, fma (4)                                    = 19
#   layered      t = q - r (1), |t|, sign, 3 minima, 3 sign products,
#                3 multiplies (11), q = t + r (1)                       = 13
# The convergence tests of a fixed-work run (n = 0 only) are left out.
PEAK_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
OPS_PER_EDGE_ITERATION = {"sum-product": 18, "min-sum": 15,
                          "min-sum-damped": 19, "layered": 13}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def reset_counts() -> None:
    bp_cuda.launches = 0
    min_sum_cuda.launches = 0
    min_sum_cuda.wide_launches = 0
    layered_cuda.launches = 0
    lifted_min_sum_cuda.launches = 0
    lifted_bp_cuda.launches = 0


def read_counts() -> dict[str, int]:
    return {"bp_sum_product": bp_cuda.launches,
            "min_sum": min_sum_cuda.launches,
            "min_sum_wide": min_sum_cuda.wide_launches,
            "layered_min_sum": layered_cuda.launches,
            "lifted_min_sum": lifted_min_sum_cuda.launches,
            "lifted_bp": lifted_bp_cuda.launches}


def bound(graph, batch: int, iters: int, algorithm: str,
          out_rows: int | None = None) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take
    for ``iters`` fixed iterations of ``algorithm`` on ``graph`` at
    ``batch``.  Bytes: the int32 syndrome and (damped) the float32 damping
    read once, the float32 output (``out_rows`` rows, default one per edge)
    and the int32 iteration counts written once."""
    out_rows = graph.num_edges if out_rows is None else out_rows
    nbytes = 4 * batch * (graph.num_checks + out_rows + 1)
    if algorithm == "min-sum-damped":
        nbytes += 4 * batch * graph.num_edges
    flops = OPS_PER_EDGE_ITERATION[algorithm] * graph.num_edges * batch * iters
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def two_proportion_z(k1: int, n1: int, k2: int, n2: int) -> float:
    pool = (k1 + k2) / (n1 + n2)
    return (k1 / n1 - k2 / n2) / math.sqrt(pool * (1 - pool) * (1 / n1 + 1 / n2))


def syndromes(graphs: CodeGraphs, weight: int, seed: int, device,
              p_err: float | None = None):
    """One batch of syndromes: weight-``weight`` Pauli errors, or
    depolarizing ones at ``p_err``."""
    gen = chunk_generator(seed, 0, device)
    if p_err is None:
        xe, ze = sample_weight_w_errors(gen, graphs.code.n, weight, BATCH)
    else:
        xe, ze = sample_depolarizing_errors(gen, graphs.code.n, p_err, BATCH)
    return (graphs.x.syndrome(xe.to(torch.int32)),
            graphs.z.syndrome(ze.to(torch.int32)))


def bit_mismatches(got: torch.Tensor, want: torch.Tensor):
    """(mismatches, max |diff| on finite entries, NaN entries): NaN masks
    must agree and every other entry (infinities too: saturated min-sum
    LLRs overflow) match bit for bit."""
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    differ = (got.view(torch.int32) != want.view(torch.int32)) & ~nan_g & ~nan_w
    mismatches = int((nan_g != nan_w).sum()) + int(differ.sum())
    finite = torch.isfinite(got) & torch.isfinite(want)
    max_err = float((got - want).abs()[finite].max()) if finite.any() else 0.0
    return mismatches, max_err, int(nan_w.sum())


def flag_mismatches(got, want) -> int:
    return sum(int((a != b).sum()) for a, b in zip(got, want))


def compare_bp(graph, syndrome, prior: np.float32, cfg: BPConfig):
    """K1 vs plain BP on one graph."""
    v_k, it_k = bp_cuda.bp_run(graph, syndrome, prior, cfg.max_iters,
                               cfg.check_every, cfg.conv_low, cfg.conv_high)
    v_p, n_p = sum_product.bp_run(
        graph, syndrome, torch.tensor(prior, device=syndrome.device),
        cfg.max_iters, cfg.check_every, cfg.conv_low, cfg.conv_high)
    torch.cuda.synchronize()
    mism, err, nans = bit_mismatches(v_k, v_p)
    mism += flag_mismatches(decide(graph, v_k, syndrome, cfg),
                            decide(graph, v_p, syndrome, cfg))
    mism += int(int(it_k.max()) != int(n_p))
    return mism, err, int(n_p), nans


def compare_min_sum(graph, syndrome, llr: float, cfg: BPConfig, damping=None):
    """K2 (or K4, by the graph's P) vs plain min-sum on one graph."""
    v_k, it_k = min_sum_cuda.min_sum_run(graph, syndrome, llr, cfg.max_iters,
                                         cfg.check_every, cfg.conv_low,
                                         cfg.min_sum_alpha, damping=damping)
    v_p, n_p = min_sum.min_sum_run(graph, syndrome, llr, cfg.max_iters,
                                   cfg.check_every, cfg.conv_low,
                                   cfg.min_sum_alpha, damping=damping)
    torch.cuda.synchronize()
    mism, err, nans = bit_mismatches(v_k, v_p)
    mism += flag_mismatches(decide(graph, v_k, syndrome, cfg),
                            decide(graph, v_p, syndrome, cfg))
    mism += int(int(it_k.max()) != int(n_p))
    return mism, err, int(n_p), nans


def compare_layered(graph, syndrome, llr: float, cfg: BPConfig):
    """K3 vs plain layered min-sum on one graph."""
    q_k, it_k = layered_cuda.layered_run(graph, syndrome, llr, cfg.max_iters,
                                         cfg.layered_check_every,
                                         cfg.min_sum_alpha)
    q_p, n_p = layered.layered_min_sum_run(graph, syndrome, llr,
                                           cfg.max_iters,
                                           cfg.layered_check_every,
                                           cfg.min_sum_alpha)
    torch.cuda.synchronize()
    mism, err, nans = bit_mismatches(q_k, q_p)
    d_k, d_p = (q_k <= 0).to(torch.int8), (q_p <= 0).to(torch.int8)
    mism += int((d_k != d_p).sum())
    mism += int((syndrome_fail(graph, d_k, syndrome)
                 != syndrome_fail(graph, d_p, syndrome)).sum())
    mism += int(int(it_k.max()) != int(n_p))
    return mism, err, int(n_p), nans


def run_checks(kernel: str, cases, compare) -> float:
    """Run ``compare`` on each case; fail on any mismatch.  Returns the
    largest finite |kernel - plain| seen."""
    worst = 0.0
    for code, side, mode, graph, syn, *args in cases:
        mism, err, iters, nans = compare(graph, syn, *args)
        say("check", kernel=kernel, code=code, graph=side, mode=mode,
            batch=syn.shape[1], iters=iters, nan_entries=nans,
            mismatches=mism, max_abs_err=err)
        check(mism == 0, f"{kernel} disagrees with its plain version "
                         f"({code} {side} {mode})")
        worst = max(worst, err)
    return worst


def time_ms(fn, reps: int) -> float:
    fn()  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_pair(label: str, kernel, plain, kernel_reps: int, plain_reps: int,
              **fields) -> tuple[float, float]:
    """Kernel vs plain in turns (plain, kernel, kernel, plain); returns the
    mean ms of each."""
    plain_ms = [time_ms(plain, plain_reps)]
    kernel_ms = [time_ms(kernel, kernel_reps), time_ms(kernel, kernel_reps)]
    plain_ms.append(time_ms(plain, plain_reps))
    k_ms, p_ms = float(np.mean(kernel_ms)), float(np.mean(plain_ms))
    say("time", kernel=label, batch=BATCH, **fields,
        kernel_ms=[round(t, 4) for t in kernel_ms],
        plain_ms=[round(t, 3) for t in plain_ms],
        plain_over_kernel=f"{p_ms / k_ms:.2f}")
    return k_ms, p_ms


def count_syncs(fn) -> int:
    """Synchronizing CUDA calls made by ``fn()``."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def monte_carlo(label: str, graphs: CodeGraphs, weight: int, p_err: float,
                cfg: BPConfig, chunks: int, seed: int, logical_test,
                device, relay_retries: int = 0, steps_per_call=STEPS_PER_CALL,
                error_model: str = "weight"):
    """One main-path run through ``run_monte_carlo`` with every launch
    count set to 0 just before it and read just after.  A 2-group warm-up
    first counts the host syncs.  Returns (counters, lane_iters, seconds,
    launch counts, warm-up syncs)."""
    syncs = count_syncs(lambda: run_monte_carlo(
        graphs, weight, 4 * BATCH, p_err, cfg, seed=0, batch_size=BATCH,
        steps_per_call=2, relay_retries=relay_retries,
        i_minus_p=logical_test, error_model=error_model, device=device))
    reset_counts()
    t0 = time.perf_counter()
    counters, lane_iters = run_monte_carlo(
        graphs, weight, chunks * BATCH, p_err, cfg, seed=seed,
        batch_size=BATCH, steps_per_call=steps_per_call,
        relay_retries=relay_retries, i_minus_p=logical_test,
        error_model=error_model, device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    tested = int(counters[C_TESTED])
    say("main", path=label, samples=tested, seconds=f"{seconds:.4f}",
        samples_per_s=f"{tested / seconds:.1f}",
        lane_iters_per_s=f"{lane_iters / seconds:.1f}",
        corrected_fraction=f"{counters[C_CORRECTED] / tested:.6f}",
        warmup_host_syncs=syncs,
        launches=json.dumps({k: v for k, v in counts.items() if v}))
    check(tested == chunks * BATCH, f"{label}: tested {tested}")
    return counters, lane_iters, seconds, counts, syncs


def check_launches(label: str, counts: dict, kernel: str, chunks: int) -> int:
    """The run launched ``kernel`` twice per chunk (X and Z) and nothing
    else; returns its count."""
    expected = {k: 0 for k in counts}
    expected[kernel] = 2 * chunks
    check(counts == expected, f"{label}: launch counts {counts}, expected "
                              f"{expected}")
    return counts[kernel]


def gate_headline(label: str, counters, two_sided: bool) -> None:
    """bench.py's gates: the sum-product headline within 4 sigma + 1e-4 of
    0.99539; layered (and here min-sum) at least 0.99539 - 4 sigma."""
    tested = int(counters[C_TESTED])
    frac = counters[C_CORRECTED] / tested
    sigma = (REFERENCE_CORRECTED_FRACTION
             * (1 - REFERENCE_CORRECTED_FRACTION) / tested) ** 0.5
    say("gate", path=label, corrected_fraction=f"{frac:.6f}",
        z=f"{(frac - REFERENCE_CORRECTED_FRACTION) / sigma:+.2f}")
    if two_sided:
        check(abs(frac - REFERENCE_CORRECTED_FRACTION) < 4 * sigma + 1e-4,
              f"{label}: corrected fraction {frac} outside the 4-sigma gate")
    else:
        check(frac >= REFERENCE_CORRECTED_FRACTION - 4 * sigma,
              f"{label}: corrected fraction {frac} below 0.99539 - 4 sigma")


def gate_two_proportion(label: str, counters, reference) -> None:
    """The corrected fraction agrees with a JAX-package record
    (corrected, tested) by a two-proportion test, |z| < 4."""
    z = two_proportion_z(int(counters[C_CORRECTED]), int(counters[C_TESTED]),
                         *reference)
    say("gate", path=label,
        corrected_fraction=f"{counters[C_CORRECTED] / counters[C_TESTED]:.6f}",
        reference=f"{reference[0] / reference[1]:.6f}", z=f"{z:+.2f}")
    check(abs(z) < 4, f"{label}: corrected fraction off the JAX package's "
                      f"(z={z})")


def bp_failures(counters) -> int:
    """Samples with a syndrome failure in either sector."""
    return int(counters[C_TESTED] - counters[C_CORRECTED] - counters[C_LOGICAL])


def check_repaired_lanes(graphs: CodeGraphs, sx, sz, p_err: float, seed: int,
                         cfg: BPConfig, retries: int, device) -> int:
    """Every lane the relay repairs in chunk 0 satisfies its syndrome;
    returns the number of repaired lanes."""
    primary = decode_batch(graphs, sx, sz, p_err, cfg)
    res, rx, rz = relay_decode_batch(graphs, sx, sz, p_err,
                                     relay_generator(seed, 0, device), cfg,
                                     retries=retries)
    repaired = 0
    for bit, graph, syn, dec in ((1, graphs.x, sx, res.decisions_x),
                                 (2, graphs.z, sz, res.decisions_z)):
        fixed_lanes = ((primary.error_code & bit) != 0) & ((res.error_code & bit) == 0)
        sat = (graph.syndrome(dec.to(torch.int32)) == syn).all(dim=0)
        repaired += int(fixed_lanes.sum())
        check(bool(sat[fixed_lanes].all()), "a repaired lane violates its syndrome")
    say("relay", chunk=0, repaired_lanes=repaired, retries_x=rx, retries_z=rz)
    return repaired


def main() -> int:
    # 1. device -------------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "the port's GPU path needs a CUDA device")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    say("device", name=json.dumps(kind), nvidia_smi=json.dumps(smi),
        torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0])

    # 2. build: one nvcc per source, all started together --------------------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(LIBRARIES)) as pool:
        logs = list(pool.map(lambda lib: build.build(*lib), LIBRARIES))
    for lib in KERNEL_MODULES:
        lib._library()
    say("build", seconds=f"{time.perf_counter() - t0:.2f}", arch="sm_90a",
        libraries=len(LIBRARIES))
    for (name, sources), (_, log) in zip(LIBRARIES, logs):
        say("build", library=name, source=sources[0], cached=not log)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip(), flush=True)

    # 3. K1 vs plain on the card ----------------------------------------------
    g610 = CodeGraphs.build(construct_code(*HEADLINE_CODE))
    g42 = CodeGraphs.build(construct_code(3, 3, 6, 7, 2, 3))
    prior = np.float32(BPConfig().prior_factor) * np.float32(P_ERR)
    s610 = syndromes(g610, WEIGHT, 7, device)
    s42 = syndromes(g42, 3, 8, device)
    early = BPConfig(max_iters=MAX_ITERS)
    fixed = BPConfig(max_iters=MAX_ITERS, check_every=MAX_ITERS + 1)
    cases = []
    for mode, cfg in (("early_exit", early), ("fixed", fixed)):
        cases += [("[[610,61]]", "X", mode, g610.x, s610[0], prior, cfg),
                  ("[[610,61]]", "Z", mode, g610.z, s610[1], prior, cfg)]
    cfg42 = BPConfig(max_iters=30, check_every=31)
    cases += [("[[42]]", "X", "fixed", g42.x, s42[0], prior, cfg42),
              ("[[42]]", "Z", "fixed", g42.z, s42[1], prior, cfg42)]
    worst = {"bp_sum_product": run_checks("bp_sum_product", cases, compare_bp)}

    # 4. K1 time vs plain (fixed work, [[610,61]] X, batch 2048) --------------
    prior_t = torch.tensor(prior, device=device)
    times = {"bp_sum_product": time_pair(
        "bp_sum_product",
        lambda: bp_cuda.bp_run(g610.x, s610[0], prior, MAX_ITERS, MAX_ITERS + 1),
        lambda: sum_product.bp_run(g610.x, s610[0], prior_t, MAX_ITERS,
                                   MAX_ITERS + 1),
        20, 3, graph="[[610,61]] X", iters=MAX_ITERS)}

    # 5. the sum-product main path ---------------------------------------------
    logical_610 = make_rank_basis_test(g610.code, device)
    cfg = BPConfig(max_iters=MAX_ITERS, check_every=10)
    counters, lane_iters, seconds, counts, syncs = monte_carlo(
        "sum-product", g610, WEIGHT, P_ERR, cfg, CHUNKS, 1, logical_610, device)
    check(syncs <= 2, f"{syncs} host syncs in 2 groups (one fetch per group)")
    launches = {"bp_sum_product": check_launches("sum-product", counts,
                                                 "bp_sum_product", CHUNKS)}
    stats = CodeStatistics.from_counters(
        g610.code, 1, WEIGHT, counters, int(seconds * 1e6),
        total_bp_iterations=lane_iters)
    print(stats.to_reference_text(), end="", flush=True)
    gate_headline("sum-product", counters, two_sided=True)

    # 6. K2, K3, K4 vs plain on the card -----------------------------------------
    llr = min_sum.prior_llr(prior)
    ms_early = BPConfig(max_iters=MAX_ITERS, algorithm="min-sum")
    ms_fixed = BPConfig(max_iters=MAX_ITERS, check_every=MAX_ITERS + 1,
                        algorithm="min-sum")
    ms42 = BPConfig(max_iters=30, check_every=31, algorithm="min-sum")
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    gamma = torch.rand((g610.x.num_vars, BATCH), generator=gen, device=device)
    damping = g610.x.expand_vars(gamma * 0.95 + 0.05).contiguous()
    cases = []
    for mode, c in (("early_exit", ms_early), ("fixed", ms_fixed)):
        cases += [("[[610,61]]", "X", mode, g610.x, s610[0], llr, c),
                  ("[[610,61]]", "Z", mode, g610.z, s610[1], llr, c)]
    cases += [("[[42]]", "X", "fixed", g42.x, s42[0], llr, ms42),
              ("[[42]]", "Z", "fixed", g42.z, s42[1], llr, ms42),
              ("[[610,61]]", "X", "damped_early_exit", g610.x, s610[0], llr,
               ms_early, damping)]
    worst["min_sum"] = run_checks("min_sum", cases, compare_min_sum)

    ly_early = BPConfig(max_iters=MAX_ITERS, algorithm="layered-min-sum")
    ly_fixed = BPConfig(max_iters=MAX_ITERS, layered_check_every=MAX_ITERS + 1,
                        algorithm="layered-min-sum")
    ly42 = BPConfig(max_iters=30, algorithm="layered-min-sum")
    cases = []
    for mode, c in (("early_exit", ly_early), ("fixed", ly_fixed)):
        cases += [("[[610,61]]", "X", mode, g610.x, s610[0], llr, c),
                  ("[[610,61]]", "Z", mode, g610.z, s610[1], llr, c)]
    cases += [("[[42]]", "X", "early_exit", g42.x, s42[0], llr, ly42),
              ("[[42]]", "Z", "early_exit", g42.z, s42[1], llr, ly42)]
    worst["layered_min_sum"] = run_checks("layered_min_sum", cases,
                                          compare_layered)

    sigma, tau = find_code_params(4, 5, 10, PROBE_P)[0]
    probe = CodeGraphs.build(construct_code(4, 5, 10, PROBE_P, sigma, tau))
    probe_weight = round(15 * probe.code.n / 610)
    check(probe.x.P >= min_sum_cuda.WIDE_MIN_P, "probe code below WIDE_MIN_P")
    sp = syndromes(probe, probe_weight, 9, device)
    wide_fixed = BPConfig(max_iters=20, check_every=21, algorithm="min-sum")
    cases = []
    for mode, c in (("fixed", wide_fixed), ("early_exit", ms_early)):
        cases += [(f"P={PROBE_P}", "X", mode, probe.x, sp[0], llr, c),
                  (f"P={PROBE_P}", "Z", mode, probe.z, sp[1], llr, c)]
    before = min_sum_cuda.wide_launches
    worst["min_sum_wide"] = run_checks("min_sum_wide", cases, compare_min_sum)
    check(min_sum_cuda.wide_launches == before + len(cases),
          "the P=1051 checks did not take the wide route")

    # 7. K2, K3, K4 time vs plain (fixed work, batch 2048) ---------------------
    times["min_sum"] = time_pair(
        "min_sum",
        lambda: min_sum_cuda.min_sum_run(g610.x, s610[0], llr, MAX_ITERS,
                                         MAX_ITERS + 1),
        lambda: min_sum.min_sum_run(g610.x, s610[0], llr, MAX_ITERS,
                                    MAX_ITERS + 1),
        20, 3, graph="[[610,61]] X", iters=MAX_ITERS)
    times["layered_min_sum"] = time_pair(
        "layered_min_sum",
        lambda: layered_cuda.layered_run(g610.x, s610[0], llr, MAX_ITERS,
                                         MAX_ITERS + 1),
        lambda: layered.layered_min_sum_run(g610.x, s610[0], llr, MAX_ITERS,
                                            MAX_ITERS + 1),
        20, 2, graph="[[610,61]] X", sweeps=MAX_ITERS)
    times["min_sum_wide"] = time_pair(
        "min_sum_wide",
        lambda: min_sum_cuda.min_sum_run_wide(probe.x, sp[0], llr, 20, 21),
        lambda: min_sum.min_sum_run(probe.x, sp[0], llr, 20, 21),
        5, 2, graph=f"P={PROBE_P} X", iters=20)

    # 8. the layered, min-sum and large-P main paths -----------------------------
    for label, c, kernel in (
            ("layered-min-sum", BPConfig(max_iters=MAX_ITERS,
                                         algorithm="layered-min-sum"),
             "layered_min_sum"),
            ("min-sum", BPConfig(max_iters=MAX_ITERS, check_every=10,
                                 algorithm="min-sum"), "min_sum")):
        counters, _, _, counts, syncs = monte_carlo(
            label, g610, WEIGHT, P_ERR, c, CHUNKS, 2, logical_610, device)
        check(syncs <= 2, f"{label}: {syncs} host syncs in 2 groups")
        launches[kernel] = check_launches(label, counts, kernel, CHUNKS)
        gate_headline(label, counters, two_sided=False)

    probe_cfg = BPConfig(max_iters=PROBE_ITERS, check_every=10,
                         algorithm="min-sum")
    counters, _, _, counts, syncs = monte_carlo(
        f"min-sum P={PROBE_P}", probe, probe_weight, P_ERR, probe_cfg,
        PROBE_CHUNKS, 3, make_rank_basis_test(probe.code, device), device,
        steps_per_call=2)
    check(syncs <= 2, f"probe: {syncs} host syncs in 2 groups")
    launches["min_sum_wide"] = check_launches("probe", counts, "min_sum_wide",
                                              PROBE_CHUNKS)
    gate_two_proportion(f"min-sum P={PROBE_P}", counters, PROBE_CORRECTED)

    # 9. relay ------------------------------------------------------------------
    relay_cfg = BPConfig(max_iters=MAX_ITERS, algorithm="min-sum")
    base, *_ = monte_carlo("min-sum W=40", g610, RELAY_WEIGHT, RELAY_P,
                           relay_cfg, RELAY_CHUNKS, 4, logical_610, device)
    counters, _, seconds, counts, syncs = monte_carlo(
        f"relay W=40 retries={RELAY_RETRIES}", g610, RELAY_WEIGHT, RELAY_P,
        relay_cfg, RELAY_CHUNKS, 4, logical_610, device,
        relay_retries=RELAY_RETRIES)
    tested = int(counters[C_TESTED])
    fail0, fail1 = bp_failures(base), bp_failures(counters)
    z_fail = two_proportion_z(fail0, tested, *RELAY_BP_FAILURES)
    z_repair = two_proportion_z(fail0 - fail1, fail0, *RELAY_REPAIRED)
    say("relay", samples=tested, bp_failures=fail0, unrepaired=fail1,
        repair_rate=f"{1 - fail1 / fail0:.4f}",
        corrected_fraction=f"{counters[C_CORRECTED] / tested:.6f}",
        z_failures=f"{z_fail:+.2f}", z_repair=f"{z_repair:+.2f}",
        warmup_host_syncs=syncs, min_sum_launches=counts["min_sum"])
    check(abs(z_fail) < 4, f"relay: BP failure rate off (z={z_fail})")
    check(abs(z_repair) < 4, f"relay: repair rate off (z={z_repair})")
    check(counts["min_sum"] >= 2 * RELAY_CHUNKS, "relay launched no retries")
    # every repaired lane of one chunk satisfies its syndrome
    sx, sz = syndromes(g610, RELAY_WEIGHT, 4, device)
    check_repaired_lanes(g610, sx, sz, RELAY_P, 4, relay_cfg, RELAY_RETRIES,
                         device)

    # 10. K5 and K6 vs plain on lifted graphs -----------------------------------
    gross = known_bicycle_code(GROSS).build_graphs()
    s_gross = syndromes(gross, 0, 12, device, p_err=0.03)
    gamma = torch.rand((gross.x.num_vars, BATCH), generator=gen, device=device)
    damping_gross = gross.x.expand_vars(gamma * 0.95 + 0.05).contiguous()
    toric = toric_code(32).build_graphs()
    check(toric.x.P >= min_sum_cuda.WIDE_MIN_P, "toric d=32 below WIDE_MIN_P")
    s_toric = syndromes(toric, 0, 13, device, p_err=0.05)
    bb756 = known_bicycle_code("[[756,16,34]]").build_graphs()
    s_756 = syndromes(bb756, 0, 14, device, p_err=0.03)
    fixed20 = BPConfig(max_iters=20, check_every=21)
    ms_fixed20 = BPConfig(max_iters=20, check_every=21, algorithm="min-sum")
    lifted_cases = {"lifted_min_sum": [], "lifted_bp": []}
    for name, (c_early, c_fixed, c20), arg in (
            ("lifted_min_sum", (ms_early, ms_fixed, ms_fixed20), llr),
            ("lifted_bp", (early, fixed, fixed20), prior)):
        for mode, c in (("early_exit", c_early), ("fixed", c_fixed)):
            lifted_cases[name] += [
                (GROSS, "X", mode, gross.x, s_gross[0], arg, c),
                (GROSS, "Z", mode, gross.z, s_gross[1], arg, c)]
        lifted_cases[name] += [
            ("toric d=32", "X", "fixed", toric.x, s_toric[0], arg, c20),
            ("toric d=32", "Z", "fixed", toric.z, s_toric[1], arg, c20),
            ("[[756,16,34]]", "X", "fixed", bb756.x, s_756[0], arg, c20)]
    lifted_cases["lifted_min_sum"].append(
        (GROSS, "X", "damped_early_exit", gross.x, s_gross[0], llr, ms_early,
         damping_gross))
    before = read_counts()
    worst["lifted_min_sum"] = run_checks(
        "lifted_min_sum", lifted_cases["lifted_min_sum"], compare_min_sum)
    worst["lifted_bp"] = run_checks("lifted_bp", lifted_cases["lifted_bp"],
                                    compare_bp)
    after = read_counts()
    check({k: after[k] - before[k] for k in after} == {
        **{k: 0 for k in after},
        "lifted_min_sum": len(lifted_cases["lifted_min_sum"]),
        "lifted_bp": len(lifted_cases["lifted_bp"])},
        f"lifted checks launched {after} after {before}: a lifted graph "
        f"took another route (the wide one included)")

    # 11. K5 and K6 time vs plain (fixed work, gross X, batch 2048) ---------------
    times["lifted_min_sum"] = time_pair(
        "lifted_min_sum",
        lambda: min_sum_cuda.min_sum_run(gross.x, s_gross[0], llr, MAX_ITERS,
                                         MAX_ITERS + 1),
        lambda: min_sum.min_sum_run(gross.x, s_gross[0], llr, MAX_ITERS,
                                    MAX_ITERS + 1),
        50, 3, graph=f"{GROSS} X", iters=MAX_ITERS)
    times["lifted_bp"] = time_pair(
        "lifted_bp",
        lambda: bp_cuda.bp_run(gross.x, s_gross[0], prior, MAX_ITERS,
                               MAX_ITERS + 1),
        lambda: sum_product.bp_run(gross.x, s_gross[0], prior_t, MAX_ITERS,
                                   MAX_ITERS + 1),
        50, 3, graph=f"{GROSS} X", iters=MAX_ITERS)

    # 12. the lifted main paths: bench.py's bicycle_gross workload ---------------
    logical_gross = make_rank_basis_test(gross.code, device)
    for label, c, kernel, reference in (
            ("min-sum gross", BPConfig(max_iters=MAX_ITERS, check_every=10,
                                       algorithm="min-sum"),
             "lifted_min_sum", GROSS_MIN_SUM_CORRECTED),
            ("sum-product gross", BPConfig(max_iters=MAX_ITERS, check_every=10),
             "lifted_bp", GROSS_SUM_PRODUCT_CORRECTED)):
        counters, _, _, counts, syncs = monte_carlo(
            label, gross, 0, GROSS_P, c, CHUNKS, 5, logical_gross, device,
            error_model="depolarizing")
        check(syncs <= 2, f"{label}: {syncs} host syncs in 2 groups")
        launches[kernel] = check_launches(label, counts, kernel, CHUNKS)
        gate_two_proportion(label, counters, reference)

    # 13. relay on the gross code --------------------------------------------------
    relay_gross = f"relay gross p={GROSS_RELAY_P} retries={GROSS_RELAY_RETRIES}"
    base, *_ = monte_carlo(f"min-sum gross p={GROSS_RELAY_P}", gross, 0,
                           GROSS_RELAY_P, relay_cfg, GROSS_RELAY_CHUNKS, 6,
                           logical_gross, device, steps_per_call=2,
                           error_model="depolarizing")
    counters, _, _, counts, syncs = monte_carlo(
        relay_gross, gross, 0, GROSS_RELAY_P, relay_cfg, GROSS_RELAY_CHUNKS, 6,
        logical_gross, device, relay_retries=GROSS_RELAY_RETRIES,
        steps_per_call=2, error_model="depolarizing")
    fail0, fail1 = bp_failures(base), bp_failures(counters)
    say("relay", code=GROSS, samples=int(counters[C_TESTED]),
        bp_failures=fail0, unrepaired=fail1,
        repair_rate=f"{1 - fail1 / max(fail0, 1):.4f}",
        corrected_fraction=f"{counters[C_CORRECTED] / counters[C_TESTED]:.6f}",
        warmup_host_syncs=syncs, lifted_min_sum_launches=counts["lifted_min_sum"])
    check(counts["lifted_min_sum"] > 2 * GROSS_RELAY_CHUNKS,
          "gross relay launched no damped K5 retries")
    check(counts["min_sum"] == counts["min_sum_wide"] == 0,
          "gross relay took a circulant route")
    sx, sz = syndromes(gross, 0, 6, device, p_err=GROSS_RELAY_P)
    check_repaired_lanes(gross, sx, sz, GROSS_RELAY_P, 6, relay_cfg,
                         GROSS_RELAY_RETRIES, device)
    check("jax" not in sys.modules, "the port imported jax")

    print(smi, flush=True)
    # name -> (source, TPU kernel, timed graph, iterations, algorithm, output
    # rows): the shapes of phases 4, 7 and 11
    kernels = {
        "bp_sum_product": ("bp_sum_product.cu", "bp_pallas.py:386", g610.x,
                           MAX_ITERS, "sum-product", None),
        "min_sum": ("min_sum.cu", "min_sum_pallas.py:310", g610.x, MAX_ITERS,
                    "min-sum", None),
        "min_sum_wide": ("min_sum.cu", "min_sum_wide_pallas.py:291", probe.x,
                         20, "min-sum", None),
        "layered_min_sum": ("layered_min_sum.cu", "layered_pallas.py:232",
                            g610.x, MAX_ITERS, "layered", g610.x.num_vars),
        "lifted_min_sum": ("lifted_min_sum.cu", "lifted_min_sum_pallas.py:272",
                           gross.x, MAX_ITERS, "min-sum", None),
        "lifted_bp": ("lifted_bp.cu", "lifted_bp_pallas.py:232", gross.x,
                      MAX_ITERS, "sum-product", None),
    }
    rows = []
    for name, (src, tpu, graph, iters, algorithm, out_rows) in kernels.items():
        bound_ms, bound_by = bound(graph, BATCH, iters, algorithm, out_rows)
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"qec_ldpc_tpu_torch/csrc/{src}",
            "replaces": f"qec_ldpc_tpu/kernels/{tpu}",
            "launches": launches[name],
            "max_abs_err": worst[name],
            "ms": times[name][0],
            "plain_ms": times[name][1],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            # no single PyTorch call computes BP decoding
            "library_ms": None,
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
