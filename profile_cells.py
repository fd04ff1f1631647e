#!/usr/bin/env python3
"""Where the time goes in each measured cell of the port, on one NVIDIA GPU.

    python3 profile_cells.py [--cells headline,gross-min-sum,...]

Each cell is one ``run_monte_carlo`` workload of ``chip_smoke.py`` (the
``osd`` cell: ``run_monte_carlo_osd``), defined in ``workloads.py``, except
the kernels alone: ``k1``, ``k2`` and ``k3``, ``KERNEL_DECODES`` fixed-work
decodes (K1 sum-product, K2 min-sum, K3 layered; 100 iterations or sweeps of
the [[610,61]] X graph at batch 2048), ``k4`` 20 iterations of the P=1051
probe's X graph through K4, ``k5`` and ``k6`` 100 through K5 and K6 on the
gross code's X graph, ``k7`` as many OSD-0 launches (K7) on 1,024 failed
[[610,61]] Z lanes (``workloads.k7_inputs``), and ``k8``, a loop
of ``K8_STEPS`` graph-sharded min-sum steps (K8) of shard 0 of 2 of the
[[5210,521]] X graph at batch 1024 (the graph-sharded cell's lanes per rank;
``k8-256`` and ``k8-2048`` at those batches) in one process, with no mesh,
each step's partials fed back as the other shard's.  For
each: a warm-up run, ``RUNS`` (3) unprofiled runs timed on the host clock
(wall per chunk, samples/s), then one run under ``torch.profiler`` with CPU
and CUDA activities.  From the profiled run it reports the device busy time
per chunk (the sum of the self device time of every device operation), the
idle share (1 - busy / unprofiled wall, since the profiler slows the host),
the decode kernel's share of device time and its ms per launch, the same
for every kernel of the cell (``kernels``: the OSD-0 kernel too), and the
device operations per chunk.  Prints one JSON line per cell, then the
card's ``nvidia-smi`` name and power limit.  Needs CUDA; never falls back to
the CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType

from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.decoder.decode import BPConfig, CodeGraphs
from qec_ldpc_tpu_torch.parallel.montecarlo import run_monte_carlo
from qec_ldpc_tpu_torch.sampling import C_TESTED, make_rank_basis_test
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
    OSD_BATCH,
    OSD_CHUNKS,
    OSD_FAILED_SEED,
    OSD_LAM,
    OSD_P,
    OSD_TIMED_LANES,
    OSD_WEIGHT,
    P_ERR,
    RELAY_CHUNKS,
    RELAY_P,
    RELAY_RETRIES,
    RELAY_WEIGHT,
    STEPS_PER_CALL,
    WEIGHT,
    k7_inputs,
    osd_failed_lanes,
)

RUNS = 3  # unprofiled timed runs per cell
KERNEL_DECODES = 20  # fixed-work decodes per run of a kernel-alone cell

# cell -> (code, error model, weight, p, config, chunks, relay retries,
#          kernel names as the profiler shows them, the decode kernel first
#          [, batch, OSD lam])
MIN_SUM = BPConfig(max_iters=MAX_ITERS, algorithm="min-sum")
CELLS = {
    "headline": ("610", "weight", WEIGHT, P_ERR, BPConfig(max_iters=MAX_ITERS),
                 CHUNKS, 0, ("bp_sum_product_kernel",)),
    "layered": ("610", "weight", WEIGHT, P_ERR,
                BPConfig(max_iters=MAX_ITERS, algorithm="layered-min-sum"),
                CHUNKS, 0, ("layered_min_sum_kernel",)),
    "min-sum": ("610", "weight", WEIGHT, P_ERR, MIN_SUM, CHUNKS, 0,
                ("min_sum_kernel",)),
    "relay": ("610", "weight", RELAY_WEIGHT, RELAY_P, MIN_SUM, RELAY_CHUNKS,
              RELAY_RETRIES, ("min_sum_kernel",)),
    "gross-min-sum": ("gross", "depolarizing", 0, GROSS_P, MIN_SUM, CHUNKS, 0,
                      ("lifted_min_sum_kernel",)),
    "gross-sum-product": ("gross", "depolarizing", 0, GROSS_P,
                          BPConfig(max_iters=MAX_ITERS), CHUNKS, 0,
                          ("lifted_bp_kernel",)),
    "gross-relay": ("gross", "depolarizing", 0, GROSS_RELAY_P, MIN_SUM,
                    GROSS_RELAY_CHUNKS, GROSS_RELAY_RETRIES,
                    ("lifted_min_sum_kernel",)),
    "osd": ("610", "weight", OSD_WEIGHT, OSD_P, MIN_SUM, OSD_CHUNKS, 0,
            ("min_sum_kernel", "osd0_kernel"), OSD_BATCH, OSD_LAM),
    "k1": ("610",),
    "k2": ("610",),
    "k3": ("610",),
    "k4": ("1051",),
    "k5": ("gross",),
    "k6": ("gross",),
    "k7": ("610",),
    "k8": ("5210", 1024),
    "k8-256": ("5210", 256),
    "k8-2048": ("5210", 2048),
}


def build_graphs(code: str) -> CodeGraphs:
    """The [[610,61]] code, the P=1051 probe code of chip_smoke.py or the
    gross code [[144,12,12]].  The gross code is imported only when a gross
    cell runs, so the circulant cells also run against a tree of the port
    that predates the lifted codes."""
    if code == "610":
        return CodeGraphs.build(construct_code(*HEADLINE_CODE))
    if code == "1051":
        from qec_ldpc_tpu_torch.codes import find_code_params

        return CodeGraphs.build(construct_code(
            4, 5, 10, 1051, *find_code_params(4, 5, 10, 1051)[0]))
    from qec_ldpc_tpu_torch.codes import known_bicycle_code

    return known_bicycle_code(GROSS).build_graphs()


def device_profile(run, kernels: tuple):
    """A warm-up, ``RUNS`` timed runs of ``run()``, then one under
    ``torch.profiler``.  Returns (wall seconds of the timed runs, device busy
    us and device operations of the profiled run, per-kernel share, ms per
    launch and launches, what the profiled run returned)."""
    run()  # warm-up
    walls = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        result = run()
    # device operations only: a CPU op's self device time repeats its kernels'
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    shares = {}
    for kernel in kernels:
        mine = [e for e in events if kernel in e.key]
        us = sum(e.self_device_time_total for e in mine)
        launches = sum(e.count for e in mine)
        shares[kernel] = {
            "share_of_device": us / busy_us if busy_us else None,
            "ms_per_launch": 1e-3 * us / launches if launches else None,
            "launches": launches}
    return walls, busy_us, sum(e.count for e in events), shares, result


def profile_kernel(name: str, graphs: CodeGraphs, device) -> dict:
    """The kernel-alone cells: KERNEL_DECODES fixed-work decodes (MAX_ITERS
    iterations or sweeps, no convergence test after the first) at BATCH of
    the [[610,61]] X graph through K1 (``k1``), K2 (``k2``) or K3 (``k3``)
    on weight-15 syndromes, of the P=1051 probe's X graph through K4
    (``k4``, 20 iterations, weight-258 syndromes: chip_smoke.py's phase 7
    shape), or of the gross X graph through K5 (``k5``) or K6 (``k6``) on
    depolarizing p = 0.03 syndromes (chip_smoke.py's phase 11 input); or
    KERNEL_DECODES K7 launches on OSD_TIMED_LANES failed [[610,61]] Z lanes
    (``k7``: chip_smoke.py's phase 15 input).  The wrappers are imported
    here: earlier trees of the port lack some."""
    from qec_ldpc_tpu_torch.decoder.min_sum import prior_llr
    from qec_ldpc_tpu_torch.kernels import (
        bp_cuda,
        layered_cuda,
        min_sum_cuda,
        osd0_cuda,
    )
    from qec_ldpc_tpu_torch.parallel.montecarlo import chunk_generator
    from qec_ldpc_tpu_torch.sampling import errors

    gen = chunk_generator(7, 0, device)
    if name == "k7":
        k7 = k7_inputs(osd_failed_lanes(graphs, OSD_FAILED_SEED, device,
                                        OSD_BATCH, weight=OSD_WEIGHT)[1])
    if name in ("k5", "k6"):
        xe, _ = errors.sample_depolarizing_errors(gen, graphs.code.n, 0.03, BATCH)
    else:
        xe, _ = errors.sample_weight_w_errors(
            gen, graphs.code.n, round(WEIGHT * graphs.code.n / 610), BATCH)
    syn = graphs.x.syndrome(xe.to(torch.int32))
    prior = float(torch.tensor(2.0 / 3.0, dtype=torch.float32)
                  * torch.tensor(P_ERR, dtype=torch.float32))
    llr = prior_llr(prior)
    kernel, decode = {
        "k1": ("bp_sum_product_kernel", lambda: bp_cuda.bp_run(
            graphs.x, syn, prior, MAX_ITERS, MAX_ITERS + 1)),
        "k2": ("min_sum_kernel", lambda: min_sum_cuda.min_sum_run(
            graphs.x, syn, llr, MAX_ITERS, MAX_ITERS + 1)),
        "k3": ("layered_min_sum_kernel", lambda: layered_cuda.layered_run(
            graphs.x, syn, llr, MAX_ITERS, MAX_ITERS + 1)),
        "k4": ("min_sum_kernel", lambda: min_sum_cuda.min_sum_run(
            graphs.x, syn, llr, 20, 21)),
        "k5": ("lifted_min_sum_kernel", lambda: min_sum_cuda.min_sum_run(
            graphs.x, syn, llr, MAX_ITERS, MAX_ITERS + 1)),
        "k6": ("lifted_bp_kernel", lambda: bp_cuda.bp_run(
            graphs.x, syn, prior, MAX_ITERS, MAX_ITERS + 1)),
        "k7": ("osd0_kernel", lambda: osd0_cuda.osd0_solve(*k7)),
    }[name]

    def run():
        for _ in range(KERNEL_DECODES):
            decode()
        torch.cuda.synchronize()

    walls, busy_us, ops, shares, _ = device_profile(run, (kernel,))
    k = shares[kernel]
    return {
        "cell": name,
        "decodes": KERNEL_DECODES,
        "batch": OSD_TIMED_LANES if name == "k7" else BATCH,
        "iterations": {"k4": 20, "k7": None}.get(name, MAX_ITERS),
        "wall_ms_per_decode": 1e3 * min(walls) / KERNEL_DECODES,
        "device_busy_ms_per_decode": 1e-3 * busy_us / KERNEL_DECODES,
        "decode_kernel": kernel,
        "decode_share_of_device": k["share_of_device"],
        "decode_ms_per_launch": k["ms_per_launch"],
        "decode_launches": k["launches"],
        "device_ops_per_decode": ops / KERNEL_DECODES,
    }


def profile_k8(device, batch: int, name: str) -> dict:
    """The ``k8`` cells: K8_STEPS steps of shard 0 of 2 of the [[5210,521]]
    X graph at ``batch`` (imported here: earlier trees of the port lack
    K8)."""
    from qec_ldpc_tpu_torch.decoder.min_sum import prior_llr
    from qec_ldpc_tpu_torch.kernels import sharded_step_cuda
    from qec_ldpc_tpu_torch.parallel.graph_sharded import ShardRouter
    from workloads import K8_STEPS, SHARDED_CODE, SHARDED_GRAPH, SHARDED_P

    graph = CodeGraphs.build(construct_code(*SHARDED_CODE)).x
    router = ShardRouter(graph, SHARDED_GRAPH, 0)
    gen = torch.Generator(device=device)
    gen.manual_seed(19)
    checks = router.B * router.P
    v0 = torch.randn((router.Lc * checks, batch), generator=gen,
                     device=device) * 4
    syn = torch.where(torch.rand((checks, batch), generator=gen,
                                 device=device) < 0.3, -1.0, 1.0)
    done = torch.zeros(batch, dtype=torch.bool, device=device)
    llr = prior_llr(2.0 / 3.0 * SHARDED_P)
    part0 = sharded_step_cuda.local_partials(v0, router.Lc)

    def run():
        v, part = v0, part0
        for _ in range(K8_STEPS):
            v, part = sharded_step_cuda.sharded_min_sum_step(
                router, llr, False, syn, part, done, v, 0.75)
        torch.cuda.synchronize()

    walls, busy_us, ops, shares, _ = device_profile(
        run, ("sharded_step_kernel",))
    wall_ms = 1e3 * min(walls) / K8_STEPS
    busy_ms = 1e-3 * busy_us / K8_STEPS
    k8 = shares["sharded_step_kernel"]
    return {
        "cell": name,
        "steps": K8_STEPS,
        "batch": batch,
        "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "decode_kernel": "sharded_step_kernel",
        "decode_share_of_device": k8["share_of_device"],
        "decode_ms_per_launch": k8["ms_per_launch"],
        "decode_launches": k8["launches"],
        "device_ops_per_step": ops / K8_STEPS,
    }


def profile_cell(name: str, graphs, logical, device) -> dict:
    _, model, weight, p_err, cfg, chunks, retries, kernels, *osd = CELLS[name]
    batch, lam = osd if osd else (BATCH, None)

    def run():
        if lam is None:
            counters, _ = run_monte_carlo(
                graphs, weight, chunks * batch, p_err, cfg, seed=1,
                batch_size=batch, steps_per_call=STEPS_PER_CALL,
                relay_retries=retries, i_minus_p=logical, error_model=model,
                device=device)
        else:  # imported here: earlier trees of the port lack it
            from qec_ldpc_tpu_torch.parallel.montecarlo import run_monte_carlo_osd

            counters, _ = run_monte_carlo_osd(
                graphs, weight, chunks * batch, p_err, cfg, seed=1,
                batch_size=batch, lam=lam, relay_retries=retries,
                i_minus_p=logical, error_model=model, device=device)
        torch.cuda.synchronize()
        return counters

    walls, busy_us, ops, shares, counters = device_profile(run, kernels)
    decode = shares[kernels[0]]
    wall_ms = 1e3 * min(walls) / chunks
    busy_ms = 1e-3 * busy_us / chunks
    return {
        "cell": name,
        "samples": int(counters[C_TESTED]),
        "wall_ms_per_chunk": wall_ms,
        "samples_per_s": [int(counters[C_TESTED]) / w for w in walls],
        "device_busy_ms_per_chunk": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "decode_kernel": kernels[0],
        "decode_share_of_device": decode["share_of_device"],
        "decode_ms_per_launch": decode["ms_per_launch"],
        "decode_launches": decode["launches"],
        "kernels": shares,
        "device_ops_per_chunk": ops / chunks,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cells", default=",".join(CELLS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_cells: torch.cuda.is_available() is false; "
                         "the measurements need a CUDA device")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    graphs, logical = {}, {}
    for name in args.cells.split(","):
        if name.startswith("k8"):
            print(json.dumps(profile_k8(device, CELLS[name][1], name)),
                  flush=True)
            continue
        code = CELLS[name][0]
        if code not in graphs:
            graphs[code] = build_graphs(code)
        if name in ("k1", "k2", "k3", "k4", "k5", "k6", "k7"):
            print(json.dumps(profile_kernel(name, graphs[code], device)),
                  flush=True)
            continue
        if code not in logical:
            logical[code] = make_rank_basis_test(graphs[code].code, device)
        print(json.dumps(profile_cell(name, graphs[code], logical[code], device)),
              flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
