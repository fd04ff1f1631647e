#!/usr/bin/env python3
"""Where the time goes in each measured cell of the port, on one NVIDIA GPU.

    python3 profile_cells.py [--cells headline,gross-min-sum,...]

Each cell is one ``run_monte_carlo`` workload of ``chip_smoke.py`` (the
``osd`` cell: ``run_monte_carlo_osd``), defined in ``workloads.py``.  For
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
    OSD_LAM,
    OSD_P,
    OSD_WEIGHT,
    P_ERR,
    RELAY_CHUNKS,
    RELAY_P,
    RELAY_RETRIES,
    RELAY_WEIGHT,
    STEPS_PER_CALL,
    WEIGHT,
)

RUNS = 3  # unprofiled timed runs per cell

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
}


def build_graphs(code: str) -> CodeGraphs:
    """The [[610,61]] code or the gross code [[144,12,12]].  The gross code
    is imported only when a gross cell runs, so the circulant cells also run
    against a tree of the port that predates the lifted codes."""
    if code == "610":
        return CodeGraphs.build(construct_code(*HEADLINE_CODE))
    from qec_ldpc_tpu_torch.codes import known_bicycle_code

    return known_bicycle_code(GROSS).build_graphs()


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

    run()  # warm-up
    walls = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        counters = run()
        walls.append(time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
    # device operations only: a CPU op's self device time repeats its kernels'
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    ops = sum(e.count for e in events)
    shares = {}
    for kernel in kernels:
        mine = [e for e in events if kernel in e.key]
        us = sum(e.self_device_time_total for e in mine)
        launches = sum(e.count for e in mine)
        shares[kernel] = {
            "share_of_device": us / busy_us if busy_us else None,
            "ms_per_launch": 1e-3 * us / launches if launches else None,
            "launches": launches}
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
        code = CELLS[name][0]
        if code not in graphs:
            graphs[code] = build_graphs(code)
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
