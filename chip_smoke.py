#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — the reference's headline workload: the
[[610,61]] code, weight-15 Pauli errors, p = 0.01, up to 100 sum-product
iterations with a convergence check every 10 and early exit — phase by
phase, and fails (non-zero exit) if any phase fails:

  1. device  needs CUDA; prints the card's name and power limit
  2. build   compiles the BP kernel (csrc/bp_sum_product.cu) with nvcc
  3. check   kernel vs the plain PyTorch BP on the card: [[610,61]] X and Z
             at batch 2048, early exit and fixed 100 iterations, and the
             [[42]] code at 30 fixed iterations.  Finite messages must match
             bit for bit, NaN masks, decisions, failure flags and the max
             iteration count exactly (mismatch count 0)
  4. time    fixed-work X decode at batch 2048, kernel vs plain (CUDA events)
  5. main    run_monte_carlo on the headline workload, 64 chunks of 2048,
             after a warm-up that may synchronise with the host only once
             per group of chunks; every chunk must launch the kernel twice
             (X and Z), and the corrected fraction must lie within
             4 sigma + 1e-4 of the reference's 0.99539 (the gate of bench.py)

The last three lines are the card's ``nvidia-smi`` name and power limit, a
JSON object describing each kernel of the path, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.decoder import sum_product
from qec_ldpc_tpu_torch.decoder.decode import BPConfig, CodeGraphs, decide
from qec_ldpc_tpu_torch.harness.stats import CodeStatistics
from qec_ldpc_tpu_torch.kernels import bp_cuda, build
from qec_ldpc_tpu_torch.parallel.montecarlo import (
    chunk_generator,
    run_monte_carlo,
)
from qec_ldpc_tpu_torch.sampling import (
    C_CORRECTED,
    C_TESTED,
    make_rank_basis_test,
)
from qec_ldpc_tpu_torch.sampling.errors import sample_weight_w_errors

REFERENCE_CORRECTED_FRACTION = 0.99539  # bench.py: the reference's 100k run
BATCH = 2048
WEIGHT = 15
P_ERR = 0.01
MAX_ITERS = 100
CHUNKS = 64
STEPS_PER_CALL = 8


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def syndromes(graphs: CodeGraphs, weight: int, seed: int, device):
    xe, ze = sample_weight_w_errors(chunk_generator(seed, 0, device),
                                    graphs.code.n, weight, BATCH)
    return (graphs.x.syndrome(xe.to(torch.int32)),
            graphs.z.syndrome(ze.to(torch.int32)))


def compare(graph, syndrome, prior: np.float32, cfg: BPConfig):
    """Kernel vs plain BP on one graph: (mismatches, max |diff| on finite)."""
    v_k, it_k = bp_cuda.bp_run(graph, syndrome, prior, cfg.max_iters,
                               cfg.check_every, cfg.conv_low, cfg.conv_high)
    v_p, n_p = sum_product.bp_run(
        graph, syndrome, torch.tensor(prior, device=syndrome.device),
        cfg.max_iters, cfg.check_every, cfg.conv_low, cfg.conv_high)
    torch.cuda.synchronize()
    nan_k, nan_p = torch.isnan(v_k), torch.isnan(v_p)
    finite = ~nan_k & ~nan_p
    bits_differ = (v_k.view(torch.int32) != v_p.view(torch.int32)) & finite
    mismatches = int((nan_k != nan_p).sum()) + int(bits_differ.sum())
    max_err = float((v_k - v_p).abs()[finite].max()) if finite.any() else 0.0
    for a, b in zip(decide(graph, v_k, syndrome, cfg),
                    decide(graph, v_p, syndrome, cfg)):
        mismatches += int((a != b).sum())
    mismatches += int(int(it_k.max()) != int(n_p))
    return mismatches, max_err, int(n_p), int(nan_p.sum())


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

    # 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    _, log = build.build("qec_bp", bp_cuda.SOURCES)
    bp_cuda._library()
    say("build", seconds=f"{time.perf_counter() - t0:.2f}",
        arch="sm_90a", cached=not log)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)

    # 3. kernel vs plain on the card -----------------------------------------
    g610 = CodeGraphs.build(construct_code(4, 5, 10, 61, 9, 49))
    g42 = CodeGraphs.build(construct_code(3, 3, 6, 7, 2, 3))
    prior = np.float32(BPConfig().prior_factor) * np.float32(P_ERR)
    s610 = syndromes(g610, WEIGHT, 7, device)
    s42 = syndromes(g42, 3, 8, device)
    cases = []
    for mode, cfg in (("early_exit", BPConfig(max_iters=MAX_ITERS)),
                      ("fixed", BPConfig(max_iters=MAX_ITERS,
                                         check_every=MAX_ITERS + 1))):
        cases += [("[[610,61]]", "X", mode, g610.x, s610[0], cfg),
                  ("[[610,61]]", "Z", mode, g610.z, s610[1], cfg)]
    cfg42 = BPConfig(max_iters=30, check_every=31)
    cases += [("[[42]]", "X", "fixed", g42.x, s42[0], cfg42),
              ("[[42]]", "Z", "fixed", g42.z, s42[1], cfg42)]
    worst = 0.0
    for code, side, mode, graph, syn, cfg in cases:
        mism, err, iters, nans = compare(graph, syn, prior, cfg)
        say("check", code=code, graph=side, mode=mode, batch=BATCH,
            iters=iters, nan_entries=nans, mismatches=mism, max_abs_err=err)
        check(mism == 0, f"kernel disagrees with plain BP ({code} {side} {mode})")
        worst = max(worst, err)

    # 4. kernel time vs plain time (fixed work, [[610,61]] X, batch 2048) ----
    fixed = BPConfig(max_iters=MAX_ITERS, check_every=MAX_ITERS + 1)
    prior_t = torch.tensor(prior, device=device)

    def kernel():
        bp_cuda.bp_run(g610.x, s610[0], prior, fixed.max_iters,
                       fixed.check_every)

    def plain():
        sum_product.bp_run(g610.x, s610[0], prior_t, fixed.max_iters,
                           fixed.check_every)

    plain_ms = [time_ms(plain, 3)]
    kernel_ms = [time_ms(kernel, 20), time_ms(kernel, 20)]
    plain_ms.append(time_ms(plain, 3))
    k_ms, p_ms = float(np.mean(kernel_ms)), float(np.mean(plain_ms))
    say("time", graph="[[610,61]] X", batch=BATCH, iters=MAX_ITERS,
        kernel_ms=[round(t, 4) for t in kernel_ms],
        plain_ms=[round(t, 3) for t in plain_ms],
        plain_over_kernel=f"{p_ms / k_ms:.2f}")

    # 5. the main path --------------------------------------------------------
    cfg = BPConfig(max_iters=MAX_ITERS, check_every=10)
    # warm-up, not counted: 2 groups of 2 chunks with synchronizing CUDA
    # calls reported; run_monte_carlo may read the device once per group
    logical_test = make_rank_basis_test(g610.code, device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run_monte_carlo(g610, WEIGHT, 4 * BATCH, P_ERR, cfg, seed=0,
                        batch_size=BATCH, steps_per_call=2,
                        i_minus_p=logical_test, device=device)
    torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    say("syncs", groups=2, host_syncs=syncs)
    check(syncs <= 2, f"{syncs} host syncs in 2 groups (one fetch per group)")
    bp_cuda.launches = 0
    t0 = time.perf_counter()
    counters, lane_iters = run_monte_carlo(
        g610, WEIGHT, CHUNKS * BATCH, P_ERR, cfg, seed=1, batch_size=BATCH,
        steps_per_call=STEPS_PER_CALL, device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = bp_cuda.launches
    tested = int(counters[C_TESTED])
    frac = counters[C_CORRECTED] / tested
    sigma = (REFERENCE_CORRECTED_FRACTION
             * (1 - REFERENCE_CORRECTED_FRACTION) / tested) ** 0.5
    say("main", samples=tested, seconds=f"{seconds:.4f}",
        samples_per_s=f"{tested / seconds:.1f}",
        lane_iters_per_s=f"{lane_iters / seconds:.1f}",
        corrected_fraction=f"{frac:.6f}",
        z=f"{(frac - REFERENCE_CORRECTED_FRACTION) / sigma:+.2f}",
        kernel_launches=launches)
    stats = CodeStatistics.from_counters(
        g610.code, 1, WEIGHT, counters, int(seconds * 1e6),
        total_bp_iterations=lane_iters)
    print(stats.to_reference_text(), end="", flush=True)
    check(tested == CHUNKS * BATCH, f"tested {tested} != {CHUNKS * BATCH}")
    check(launches == 2 * CHUNKS,
          f"kernel launched {launches} times, expected {2 * CHUNKS}")
    check(abs(frac - REFERENCE_CORRECTED_FRACTION) < 4 * sigma + 1e-4,
          f"corrected fraction {frac} outside the 4-sigma gate")
    check("jax" not in sys.modules, "the port imported jax")

    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "bp_sum_product",
        "route": "cuda",
        "source": "qec_ldpc_tpu_torch/csrc/bp_sum_product.cu",
        "replaces": "qec_ldpc_tpu/kernels/bp_pallas.py:297",
        "launches": launches,
        "max_abs_err": worst,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
