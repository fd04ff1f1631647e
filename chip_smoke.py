#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives each decode path of the port through ``run_monte_carlo``, the
quality mode through ``run_monte_carlo_osd`` and the headline benchmark
through ``bench_torch.main``, the entry points a user calls,
and holds every CUDA kernel of those paths against its plain PyTorch version
on the card.  The headline workload is the
reference's: the [[610,61]] code, weight-15 Pauli errors, p = 0.01, up to
100 iterations; the lifted-graph workload is bench.py's ``bicycle_gross``
line: the gross code [[144,12,12]], depolarizing p = 0.01.  Fails (non-zero
exit) if any phase fails:

  1. device  needs CUDA; prints the card's name and power limit
  2. build   compiles the nine CUDA sources (csrc/bp_sum_product.cu,
             min_sum.cu, layered_min_sum.cu, lifted_min_sum.cu,
             lifted_bp.cu, osd0.cu, sharded_min_sum_step.cu,
             decide_classify.cu and the roofline benchmark's FP32 probe
             peak_chain.cu) with nvcc, all
             at once, and prints ptxas's registers and spills per kernel
  3. check   K1 (sum-product) vs the plain PyTorch BP on the card:
             [[610,61]] X and Z at batch 2048, early exit and fixed 100
             iterations, the [[42]] code at 30 fixed iterations, the
             [[5210,521]] X and Z graphs at batch 1024 (30 iterations, early
             exit: phase 20's shape) and the P=1051 probe code's X and Z at
             10 fixed iterations (E in the lane's global slab), the J=2
             [[42,7]] code's X and Z (column weight 2) at batch 2048, W=4,
             p = 0.02 and MAX=1000 under early exit, and [[42,0]] X at W=21
             (BP fails on nearly every lane) at the cap LONG_CAP on 128
             lanes; then one launch at MAX=10^5 on 2048 lanes of it, timed.
             K1 counts each lane's own iterations: every lane's count must
             equal the plain count of that lane alone
  4. time    K1: fixed-work X decode at batch 2048, kernel vs plain; under
             early exit on the headline's W=15 X and Z batches, beside a
             bound from the executed lane-iterations.  Every early-exit
             reading here and in phases 7 and 11 also gives the kernel's
             device time from torch.profiler: a launch of tens of
             microseconds is shorter than the wrapper's host work, so CUDA
             events around back-to-back calls read the host's launch rate
  5. main    sum-product run_monte_carlo on the headline workload, 64
             chunks of 2048, after a warm-up that may synchronise with the
             host only once per group of chunks; every chunk must launch K1
             twice (X and Z) and the fused decide/classify kernel once, and
             nothing else, as the profiler sees the card run it (a chunk
             replays a CUDA graph, which no wrapper counts), and the same run
             again must count the same; the corrected fraction must lie within
             4 sigma + 1e-4 of the reference's 0.99539 (the gate of bench.py)
  6. check   K2 (min-sum): [[610,61]] X and Z at batch 2048 with early exit
             and fixed 100 iterations, [[42]] at 30 fixed iterations, a
             damped run with random gammas, and relay-shaped batches (one
             W=40 lane in 24, the others solved), damped and undamped; K3
             (layered min-sum): [[610,61]] X and Z with a parity test every
             sweep and 100 fixed sweeps, [[42]], the [[5210,521]] X and Z
             graphs at batch 1024 (30 sweeps, a test every sweep: phase
             20's shape), the P=1051 probe's X and Z at 10 fixed sweeps,
             and every other placement (the state, then q and the state, in
             the lane's slab on [[5210,521]] Z); K4 (min-sum, P >= 768
             route): the P=1051 probe code X and Z at batch 2048, fixed 20
             iterations and early exit, relay-shaped X, and relay-shaped Z
             damped; K2 on the [[5210,521]] X and Z graphs (30 iterations,
             Z damped).  K2, K3 and K4 count each lane's own iterations
             (sweeps): every lane's count must equal the plain count of that
             lane alone
  7. time    K2 100 iterations and K3 100 sweeps on [[610,61]] X, K4 20
             iterations on the P=1051 X graph, batch 2048, kernel vs plain;
             K3's placements at P = 521 in turns, and K3 under early exit on the headline's W=15 X and Z batches
             (a test every sweep) beside a bound from the executed
             lane-iterations;
             K2 under early exit on W=40 [[610,61]] X batches, damped at
             2048 and undamped at 16,384, beside a bound from the executed
             lane-iterations; the osd cell's decode_batch with and without
             kernel_sort_lanes (outputs must be equal)
  8. main    run_monte_carlo with layered min-sum and with min-sum (check
             every 10) on the headline workload, each gated by bench.py's
             gate for layered (corrected >= 0.99539 - 4 sigma), and min-sum
             on the P=1051 probe code (W=258, 10 iterations), held to the
             JAX package's 1861 of 2048 corrected by a two-proportion test
             (|z| < 4); each run must launch its kernel twice per chunk,
             the fused decide/classify kernel once per chunk (min-sum) or
             never (layered), and synchronise at most once per group in a
             2-group warm-up
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
             iterations; both also on the P=1051 and P=2081 probe codes' Z
             graphs as lifted graphs, K5 damped and undamped (its check
             state, then its V, in the lane's slab; K6's E, then V and E).
             K5 and K6 count each lane's own iterations: every lane's count
             must equal the plain count of that lane alone
 11. time    K5 and K6: 100 iterations on the gross X graph, batch 2048,
             kernel vs plain; K5 under early exit on the gross min-sum
             cell's X and Z batches (p = 0.01) and damped at the gross relay
             cell's p = 0.03, K6 on the gross sum-product cell's X and Z
             batches (p = 0.01), beside bounds from the executed
             lane-iterations
 12. main    run_monte_carlo on the gross code, depolarizing p = 0.01, 64
             chunks of 2048: min-sum held to the JAX package's record
             (benchmarks/results/bicycle_gross_r3.jsonl line 2) and
             sum-product to a JAX-package CPU run (GROSS_SUM_PRODUCT) by
             two-proportion tests (|z| < 4); min-sum launches K5 once per
             chunk (both sectors in one launch, phase 30), sum-product K6
             twice, each the fused decide/classify kernel once, and each
             syncs at most once per group
 13. relay   the gross code at p = 0.03, min-sum with 8 relay retries, 4
             chunks: K5 must launch damped retries and every repaired lane
             must satisfy its syndrome; the repair rate is printed
 14. check   K7 (OSD-0) vs its plain version: s_final, used, pivcol,
             corrections and solved flags on the [[610,61]] X and Z lanes
             that a W=40 min-sum decode at batch 16,384 leaves failed (their
             real soft rankings), the same plus 64 random syndromes, and the
             failed lanes of the gross code and [[756,16,34]] at p = 0.05;
             OSDecoder on CUDA tensors vs the host library on the same
             lanes; the ranking (stable argsort) on the card vs the CPU's,
             and on 24 [[610,61]] Z lanes with planted ±0.0, NaN, ±inf and
             ties vs the CPU's and NumPy's, with K7 vs plain on them
 15. time    K7 vs plain on 1,024 failed-lane inputs of [[610,61]] Z and X,
             beside its bound (the work the plain walk counts on the same
             inputs), with its profiler device time; its build and read-off
             alone (rank 0); and its device time on the osd cell's own
             lanes (the failed lanes of phase 14's decode)
 16. main    run_monte_carlo_osd, min-sum + device OSD-0, [[610,61]], W=40,
             p = 0.02, 8 chunks of 16,384, after a warm-up: corrected and
             convergence-fail counts held to the JAX package's record
             (benchmarks/results/quality_sweep_r5.jsonl line 10) by
             two-proportion tests (|z| < 4), 0 syndrome failures, K7 twice
             per chunk and no host-library call, two host reads per chunk
             and no blocking sync per chunk; one chunk through the host
             route gives the same counters
 17. quality host OSD (lam > 0): layered min-sum + relay 12 + OSD-60 on
             [[610,61]] at W=40, 16 chunks of 2048 (quality_sweep_r5.jsonl
             line 5), and the gross code, min-sum + relay 8 + OSD-20 at
             p = 0.05, 8 chunks (bicycle_gross_r2.jsonl line 10): |z| < 4 on
             the corrected fraction and 0 syndrome failures
 18. check   K8 (one graph-sharded min-sum step) vs its plain version on
             every shard position of the [[5210,521]] X (B=4) and Z (B=5)
             graphs at G=2 and G=5 and of the [[610,61]] X graph at G=2,
             random V with planted +-0.0, NaN and +-inf, half the lanes
             done, last 0 and 1,
             at batch 256, 1024 (phase 20's lanes per rank) and 2048 with
             the plan's launch shape, and at 1024 with every launch shape of
             K8_SHAPES on the [[5210,521]] G=2 shards
 19. time    K8: one step of shard 0 of 2 of the [[5210,521]] X graph at
             batch 256, 1024 and 2048, kernel vs plain, beside its bound,
             and every launch shape of K8_SHAPES in turns; the kernels line
             reports batch 1024
 20. mesh    ranks spawned on the one card over gloo (workloads.py): at
             (data=2) the headline sum-product through K1 (bench.py's gate),
             then min-sum, layered and sum-product on [[5210,521]] (W=220,
             p=0.01, 30 iterations, 4 chunks of 1024 lanes per data shard),
             min-sum held to a JAX CPU run (SHARDED_MIN_SUM_CORRECTED) by a
             two-proportion test; at (data=2 x graph=2) the same runs
             graph-sharded: min-sum and layered counters and per-chunk
             lane-iterations (each lane its own count, as the kernels
             count) equal the data-only ones exactly, sum-product within
             |z| < 4, every rank launches K8 once per X and Z loop
             iteration and K2 never (at data=2 the fused decide/classify
             kernel once a chunk a rank, but for layered); the
             backend, collectives per iteration and host syncs per chunk
             are printed; in every graph-sharded chunk, every lane that
             reports no syndrome failure must satisfy its syndrome
 21. relay   (data=1 x graph=2): min-sum + 16 relay retries at W=40 (the
             relay cell), 4 chunks of 2048, the repair rate held to a
             data-parallel relay run of phase 20 (16 chunks) by a
             two-proportion test (|z| < 4), with the smallest gap that test
             detects printed, and every lane that reports no syndrome
             failure (every repaired lane among them) satisfies its
             syndrome
 22. CLI     the experiment CLI (``harness.cli.main``) in this process on
             the card, with a temporary results directory, each call with
             every launch count set to 0 just before it and read just
             after: (a) the headline sweep W = 14..16 (131,072 samples a
             weight, the dynamic sampler: every run_id ends
             ``|wcap=16|torch=cuda``) through K1, W=15 held to bench.py's
             gate, each result file named by ``format_result_filename`` and
             parsed by ``parse_reference_text``, and the same call again
             resuming every point with no new journal line and the same
             records; (b) the quality mode (min-sum + OSD-0, W=40,
             p = 0.02, 8 chunks of 16,384) through K2 and K7, 0 syndrome
             failures, corrected held to quality_sweep_r5.jsonl line 10
             (|z| < 4); (c) the gross code, depolarizing p = 0.01, 262,144
             samples through K6, held to GROSS_SUM_PRODUCT (|z| < 4); (d) a
             4,096-sample headline run with ``--profile_dir``, whose trace
             must name ``bp_sum_product_kernel``; each point's samples/s is
             printed beside the card's name and power limit
 23. quality the osd cell (8 chunks of 16,384, min-sum + OSD-0) at
             (data=2) over gloo, without and with 8 relay retries: the
             counters equal the mesh=None run's exactly, K2 and K7
             launching on every rank; samples/s of both, with and without
             relay
 24. quality the osd cell at (data=2 x graph=2) over gloo, min-sum and
             layered, cut to 1 chunk (GRAPH_QUALITY_CHUNKS; the code, W, p
             and iteration limit kept): counters equal the mesh=None run's
             exactly, K8 (min-sum) and K7 launching on every rank; chunk 0
             of the graph-sharded arrays chunk (min-sum) through K8 and
             through K8's plain version: samples, decisions, error codes
             and soft outputs bit for bit the single-device decode's (K2)
 25. bench   ``bench_torch.main`` at 1/8 of bench.py's counts
             (BENCH_COUNTS), each workload's gate at that count; K1, K2, K3
             and K5 must launch
 26. lifted  the lane-sharded lifted engine at (data=1 x graph=3) over
             gloo: the BB cell of benchmarks/large_code_scaling.py:154-177,
             [[756,16,34]], W=24, p = 0.01, at most 30 iterations, 4 chunks
             of 2048; min-sum and sum-product counters and lane-iterations
             equal the single-device decode of the same samples through K5
             (one launch a chunk, both sectors) and K6 (two), no rank
             launches a kernel, and every rank issues two
             all_gathers per loop iteration and six a chunk; relay with 8
             retries, cut to 1 chunk, twice: deterministic, the tested
             count kept, no more syndrome failures; then the CLI with
             ``bb:[[144,12,12]]``, depolarizing p = 0.01, sum-product and
             ``--num_graph 2`` on two ranks: its record equals the
             single-device run of the data shard's samples through K6
 27. examples each example of examples_torch/ on the card through its
             ``main``: quickstart (K1), bicycle_demo (K5), quality_pipeline
             (K3, relay on K2) at their defaults, and graph_parallel_demo
             at (data=2 x graph=2) (cut from 4 x 2: four ranks on the one
             card), whose own assertion holds, its data ranks launching K2
             and its graph ranks K8 alone
 28. suite   each script of benchmarks_torch/ through its ``main`` on the
             card at reduced counts (BENCHMARK_CUTS), its records in a
             temporary directory, with every launch count set to 0 just
             before it and read just after: throughput (K1, K2, K3),
             dynamic_weight_real W=1..4 (K1; the weight-cap counters equal
             the static run's), relay_tuning [[610,61]] W=40 on one range
             and seed (K2 damped; |z| < 4 against relay_tuning_r4.jsonl),
             bicycle_ler at one p with relay 8 and OSD-0 (K5, K7),
             sharded_step_bench at batch 1024 (K8, bit for bit its plain
             version), large_code_real on [[610,61]] and the P=1051 probe
             (K2, K4 bit for bit the plain loop; |z| < 4 against
             large_code_real_r5.jsonl), scaling at 1 and 2 ranks (K1),
             large_code_scaling on [[5210,521]] at (1,1) and (1,2) and
             [[756,16,34]] at (1,1) and (1,3) (K2, K8 alone on the (1,2)
             ranks, K5; counters equal across shapes) and
             roofline_breakdown's peak, achieved-rate and HBM experiments
             (the FP32 probe's timed calls bit for bit its plain version
             at the full grid and chain; K1, K2, K3); and the
             reference-corpus scripts, each through K1 with its codes,
             priors and caps, gated against the reference's counts (from
             the JAX records) and the JAX records: golden_sweep W=15, 30,
             45 at both labels, golden_sweep42 W=10 MAX=100 and W=3
             MAX=10^5 at 8,192 samples, golden_deep W=15 and 58 at 65,536,
             golden_dated one point of each section at 65,536 and
             ler_sweep W=15 and 30 at 10,240;
             each script's gates raise.  K6 is launched by none of them (no
             script decodes sum-product on a lifted code): phases 10-12
             and 26 hold it
 29. fused   the decide/classify kernel (csrc/decide_classify.cu) vs its
             plain composition at the counting cells' shapes, [[610,61]] X
             and Z sum-product at W=15 and the gross code's min-sum at
             p = 0.01, 2048 lanes: the counters and lane-iteration sums bit
             for bit, the kernel's time (CUDA events and profiler device
             time) beside its byte bound, and the plain composition's time
 30. pair    K5 with both sectors in one launch against one launch a
             sector, on each lifted cell's own syndromes (the gross code at
             p = 0.01 and 2048 lanes, [[756,16,34]] at p = 0.10 and 16,384):
             messages and per-lane iterations bit for bit those of one
             launch a sector and of plain min-sum, each sector's histogram
             of per-lane iterations (1, 11, ... 91, 100), and the
             profiler's device time of X alone, Z alone and the pair, in
             turns, beside CUDA events for two launches one after the
             other, two launches on two streams, and the pair, each eager
             and replayed from a CUDA graph

Phases 20, 21, 23, 24, 26, 27's graph demo and 28's worlds share one card
between their ranks, and gloo stages every collective through host memory: their
times are not multi-card numbers.

Every process a phase starts (nvcc, g++, nvidia-smi, the ranks of a world
and multiprocessing's resource tracker) has exited by the end of the run:
the run fails if one of its descendants is still alive.

A check passes with 0 mismatches: finite messages bit for bit, NaN masks,
decisions, failure flags and each lane's iteration count.  The last four lines
are the wall time of ``main``, the card's ``nvidia-smi`` name and power
limit, a JSON object describing each kernel (with its bound: the larger of its float operations
over 67 TFLOP/s and its bytes over 3.35 TB/s; K7's integer operations over
the derived INT32 rate), and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.codes import find_code_params, known_bicycle_code, toric_code
from qec_ldpc_tpu_torch.decoder import layered, min_sum, sum_product
from qec_ldpc_tpu_torch.decoder.decode import (
    SYNDROME_FAIL_X,
    SYNDROME_FAIL_Z,
    BPConfig,
    CodeGraphs,
    decide,
    decode_batch,
    run_decoder,
    syndrome_fail,
)
from qec_ldpc_tpu_torch.decoder.lifted import LiftedGraph
from qec_ldpc_tpu_torch.decoder.osd import OSDecoder
from qec_ldpc_tpu_torch.decoder.osd_device import ranking
from qec_ldpc_tpu_torch.decoder.relay import relay_decode_batch
from qec_ldpc_tpu_torch.harness import cli, format_result_filename
from qec_ldpc_tpu_torch.harness.stats import CodeStatistics, parse_reference_text
from qec_ldpc_tpu_torch.kernels import (
    bp_cuda,
    build,
    classify_cuda,
    layered_cuda,
    lifted_bp_cuda,
    lifted_min_sum_cuda,
    min_sum_cuda,
    osd0_cuda,
    peak_chain_cuda,
    placement,
    sharded_step_cuda,
)
from qec_ldpc_tpu_torch import native
from qec_ldpc_tpu_torch.parallel import mc_graph, montecarlo
from qec_ldpc_tpu_torch.parallel.chunk import (
    chunk_generator,
    relay_draws,
    sample_syndromes,
)
from qec_ldpc_tpu_torch.parallel.graph_sharded import ShardRouter
from qec_ldpc_tpu_torch.parallel.mesh import DATA_AXIS, GRAPH_AXIS, spawn
from qec_ldpc_tpu_torch.parallel.montecarlo import (
    mc_chunk_arrays,
    run_monte_carlo,
    run_monte_carlo_osd,
)
from qec_ldpc_tpu_torch.sampling import (
    C_CONV_X,
    C_CONV_Z,
    C_CORRECTED,
    C_LOGICAL,
    C_SYN_X,
    C_SYN_Z,
    C_TESTED,
    NUM_COUNTERS,
    classify_batch,
    make_rank_basis_test,
)
from qec_ldpc_tpu_torch.sampling.errors import (
    sample_depolarizing_errors,
    sample_weight_w_errors,
)

import bench_torch
from benchmarks_torch.common import two_proportion_z
from benchmarks_torch import (
    bicycle_ler,
    dynamic_weight_real,
    golden_dated,
    golden_deep,
    golden_sweep,
    golden_sweep42,
    large_code_real,
    large_code_scaling,
    ler_sweep,
    relay_tuning,
    roofline_breakdown,
    scaling,
    sharded_step_bench,
    throughput,
)
from examples_torch import (
    bicycle_demo,
    graph_parallel_demo,
    quality_pipeline,
    quickstart,
)
from workloads import (
    BATCH,
    CHUNKS,
    GROSS,
    GROSS_P,
    GROSS_RELAY_CHUNKS,
    GROSS_RELAY_P,
    GROSS_QUALITY_CHUNKS,
    GROSS_QUALITY_LAM,
    GROSS_QUALITY_P,
    GROSS_QUALITY_RELAY,
    GROSS_RELAY_RETRIES,
    HEADLINE_CODE,
    K8_BATCHES,
    LIFTED_CLI_CHUNKS,
    LIFTED_CLI_GRAPH,
    LIFTED_MESH_CHUNKS,
    LIFTED_MESH_CODE,
    LIFTED_MESH_GRAPH,
    LIFTED_MESH_ITERS,
    LIFTED_MESH_P,
    LIFTED_MESH_RELAY_CHUNKS,
    LIFTED_MESH_RELAY_RETRIES,
    LIFTED_MESH_WEIGHT,
    MAX_ITERS,
    OSD_BATCH,
    OSD_CHUNKS,
    OSD_FAILED_SEED,
    OSD_LAM,
    OSD_P,
    OSD_TIMED_LANES,
    OSD_WEIGHT,
    P_ERR,
    QUALITY_CHUNKS,
    QUALITY_LAM,
    QUALITY_RELAY,
    RELAY_CHUNKS,
    RELAY_P,
    RELAY_RETRIES,
    RELAY_WEIGHT,
    SHARDED_BATCH,
    SHARDED_CHUNKS,
    SHARDED_CODE,
    SHARDED_DATA,
    SHARDED_GRAPH,
    SHARDED_ITERS,
    SHARDED_P,
    SHARDED_RELAY_CHUNKS,
    SHARDED_RELAY_REFERENCE_CHUNKS,
    SHARDED_WEIGHT,
    STEPS_PER_CALL,
    WEIGHT,
    k7_inputs,
    osd0_args,
    osd_failed_lanes,
)

REFERENCE_CORRECTED_FRACTION = 0.99539  # bench.py: the reference's 100k run
# the P=1051 probe of benchmarks/large_code_real.py (min-sum, 10 iterations,
# W = round(15 n / 610)); the JAX package's XLA and Pallas rows agree:
# 1861 of 2048 corrected (benchmarks/data/large_code_real_r5.jsonl:18-22)
PROBE_P = 1051
PROBE_ITERS = 10
PROBE_CHUNKS = 4
PROBE_CORRECTED = (1861, 2048)
# K1 is held to plain on the probe code at this batch (its E in the slab)
PROBE_BP_BATCH = 512
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
# the JAX package's quality-mode records, (count, tested) from the rounded
# fractions: min-sum + device OSD-0 at W=40, corrected 0.95665 and
# convergence-fail (X + Z) 0.03729 of 524,288 (quality_sweep_r5.jsonl line
# 10); layered + relay 12 + OSD-60 at W=40, corrected 0.97535 (line 5); the
# gross code, min-sum + relay 8 + OSD-20 at p = 0.05, corrected 0.994812 of
# 16,384 (bicycle_gross_r2.jsonl line 10)
OSD_CORRECTED = (round(0.95665 * 524288), 524288)
OSD_CONV_FAIL = (round(0.03729 * 524288), 524288)
QUALITY_CORRECTED = (round(0.97535 * 524288), 524288)
GROSS_QUALITY_CORRECTED = (round(0.994812 * 16384), 16384)
# the JAX package's min-sum (XLA path) on the CPU at the graph-sharded
# setting, counters [65536, 65536, 65536, 62880, 1235, 1104, 345, 1192, 486]
# from
#   run_monte_carlo(CodeGraphs.build(construct_code(4, 5, 10, 521, 25, 1)),
#       220, 65536, 0.01, BPConfig(max_iters=30, algorithm="min-sum",
#       kernel="xla"), seed=1, batch_size=1024)
SHARDED_MIN_SUM_CORRECTED = (62880, 65536)

LIBRARIES = (("qec_bp", bp_cuda.SOURCES), ("qec_min_sum", min_sum_cuda.SOURCES),
             ("qec_layered", layered_cuda.SOURCES),
             ("qec_lifted_min_sum", lifted_min_sum_cuda.SOURCES),
             ("qec_lifted_bp", lifted_bp_cuda.SOURCES),
             ("qec_osd0", osd0_cuda.SOURCES),
             ("qec_sharded_min_sum_step", sharded_step_cuda.SOURCES),
             ("qec_peak_chain", peak_chain_cuda.SOURCES),
             ("qec_decide_classify", classify_cuda.SOURCES))
KERNEL_MODULES = (bp_cuda, min_sum_cuda, layered_cuda, lifted_min_sum_cuda,
                  lifted_bp_cuda, osd0_cuda, sharded_step_cuda,
                  peak_chain_cuda, classify_cuda)

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
# K7 is integer work.  The H100 SXM has 64 INT32 lanes per SM per clock, so
# 132 SMs at the 1.98 GHz boost clock give ~16.7 T ops/s: derived from those
# figures, not a data-sheet rate.  Per lane, each walked column costs every
# row the XOR of the W = ceil(n/32) + 1 words plus the pick (bit test and
# candidate mask: 2).
PEAK_INT32_OPS = 132 * 64 * 1.98e9
# K8's launch shapes held to plain in phase 18 and timed in phase 19:
# (lanes per CTA, partials folded into the variable phase); at 16 lanes the
# [[5210,521]] state is in the CTA's global slab
K8_SHAPES = ((2, False), (4, False), (4, True), (8, False), (16, False),
             (16, True))
# phases 23 and 24: the osd cell on a mesh over gloo on the one card.  F3's
# run keeps the cell's 8 chunks and adds relay retries; the graph-sharded
# runs are cut to one chunk, since gloo stages every halo through the host
QUALITY_MESH_RELAY = 8
GRAPH_QUALITY_CHUNKS = 1
# phase 25: bench_torch.main at 1/8 of bench.py's counts
BENCH_COUNTS = dict(headline_chunks=64, fixed_chunks=8, small_chunks=32,
                    gross_chunks=8)
# phase 28: each benchmark script's main at these cuts of its defaults (the
# code, weights, p and iteration limits kept), and the kernels it must
# launch in this process (the worlds' ranks report their own)
BENCHMARK_CUTS = (
    ("throughput", throughput, dict(chunks=2),
     ("bp_sum_product", "min_sum", "layered_min_sum")),
    ("dynamic_weight_real", dynamic_weight_real, dict(w_max=4, probes=(1, 4)),
     ("bp_sum_product",)),
    ("relay_tuning", relay_tuning,
     dict(workloads=("qc610_W40",), ranges=((0.2, 0.95),), seeds=(3,)),
     ("min_sum",)),
    ("bicycle_ler", bicycle_ler, dict(ps=(0.01,), relay=8, osd=0),
     ("lifted_min_sum", "osd0")),
    ("sharded_step_bench", sharded_step_bench, dict(batches=(1024,), iters=10),
     ("sharded_min_sum_step",)),
    ("large_code_real", large_code_real,
     dict(qc=(61,), bb=False, probes=(1051,)), ("min_sum", "min_sum_wide")),
    ("scaling", scaling, dict(devices=[1, 2]), ("bp_sum_product",)),
    ("large_code_scaling", large_code_scaling,
     dict(shapes={"qc_P521": ((1, 1), (1, 2)), "bb_756": ((1, 1), (1, 3))}),
     ("min_sum", "lifted_min_sum")),
    ("roofline_breakdown", roofline_breakdown,
     dict(experiments=("peak", "achieved", "hbm"), chunks=8),
     ("peak_chain", "bp_sum_product", "min_sum", "layered_min_sum")),
    # the reference-corpus scripts: codes, weights, priors and caps kept,
    # points and samples cut
    ("golden_sweep", golden_sweep, dict(weights=(15, 30, 45)),
     ("bp_sum_product",)),
    ("golden_sweep42", golden_sweep42,
     dict(points=((10, 100), (3, 100_000)), samples_per_point=8192),
     ("bp_sum_product",)),
    ("golden_deep", golden_deep, dict(weights=(15, 58),
                                      samples_per_point=65536),
     ("bp_sum_product",)),
    ("golden_dated", golden_dated,
     dict(points=(("archive", 45), ("max_sweep", 3), ("pre_detection", 2)),
          samples_per_point=65536), ("bp_sum_product",)),
    ("ler_sweep", ler_sweep, dict(weights=(15, 30), count=10240,
                                  steps_per_call=5), ("bp_sum_product",)),
)
# phase 3: K1 on the J=2 [[42,7]] code at a full batch, W=J2_WEIGHT, the
# corpus's prior and MAX=J2_MAX under early exit; and at a long cap on
# [[42,0]] at W=LONG_WEIGHT (BP fails on nearly every lane), on LONG_LANES
# lanes against the plain loop, which takes ~1.0 ms an iteration there on
# the H100: LONG_CAP keeps it to ~30 s
J2_CODE = (2, 3, 6, 7, 2, 3)
J2_WEIGHT = 4
J2_MAX = 1000
GOLDEN_P = 0.02
LONG_WEIGHT = 21
LONG_LANES = 128
LONG_CAP = 30_000
# K5's slab placements are held to plain at this batch in phase 10
LIFTED_SLAB_BATCH = 128
# the relay-shaped batches of phase 6 keep one lane in this many (the W=40
# min-sum decode leaves ~4% of lanes to the retries)
RELAY_SHAPED_EVERY = 24


def ptxas_report(log: str) -> list:
    """(kernel, registers, spill) of each kernel in nvcc's -Xptxas=-v log,
    the kernel by its mangled name (its template arguments included)."""
    out, kernel, spill = [], "?", "no spill"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1] if "'" in line else line.strip()
            spill = "no spill"
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            out.append((kernel, line.split("Used")[1].split()[0], spill))
    return out


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def descendants() -> dict:
    """pid -> command line of every living (or unreaped) descendant of this
    process, from the parent pids in /proc/<pid>/stat."""
    parent, cmd = {}, {}
    for stat in Path("/proc").glob("[0-9]*/stat"):
        pid = int(stat.parent.name)
        try:
            # the fields after the parenthesised name: state, ppid, ...
            parent[pid] = int(stat.read_text().rpartition(")")[2].split()[1])
            cmd[pid] = (stat.parent / "cmdline").read_bytes().replace(
                b"\0", b" ").decode(errors="replace").strip()
        except (OSError, IndexError, ValueError):  # exited meanwhile
            continue
    found, frontier = {}, [os.getpid()]
    while frontier:
        ppid = frontier.pop()
        for pid, pp in parent.items():
            if pp == ppid and pid not in found:
                found[pid] = cmd[pid]
                frontier.append(pid)
    return found


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


_PHASE: list = []  # [name, start] of the phase under way


def phase(name: str | None) -> None:
    """Start phase ``name`` (None: only end the one under way), printing
    the wall time of the phase it ends."""
    now = time.perf_counter()
    if _PHASE:
        say("phase", name=json.dumps(_PHASE[0]),
            seconds=f"{now - _PHASE[1]:.2f}")
    _PHASE[:] = [] if name is None else [name, now]


def reset_counts() -> None:
    bp_cuda.launches = 0
    min_sum_cuda.launches = 0
    min_sum_cuda.wide_launches = 0
    layered_cuda.launches = 0
    lifted_min_sum_cuda.launches = 0
    lifted_bp_cuda.launches = 0
    osd0_cuda.launches = 0
    sharded_step_cuda.launches = 0
    peak_chain_cuda.launches = 0
    classify_cuda.launches = 0


def read_counts() -> dict[str, int]:
    return {"bp_sum_product": bp_cuda.launches,
            "min_sum": min_sum_cuda.launches,
            "min_sum_wide": min_sum_cuda.wide_launches,
            "layered_min_sum": layered_cuda.launches,
            "lifted_min_sum": lifted_min_sum_cuda.launches,
            "lifted_bp": lifted_bp_cuda.launches,
            "osd0": osd0_cuda.launches,
            "sharded_min_sum_step": sharded_step_cuda.launches,
            "peak_chain": peak_chain_cuda.launches,
            "decide_classify": classify_cuda.launches}


#: the device kernel behind each count of :func:`read_counts` (the wide
#: route of min_sum.cu launches ``min_sum_kernel`` too)
DEVICE_KERNELS = {"bp_sum_product": "bp_sum_product_kernel",
                  "min_sum": "min_sum_kernel",
                  "layered_min_sum": "layered_min_sum_kernel",
                  "lifted_min_sum": "lifted_min_sum_kernel",
                  "lifted_bp": "lifted_bp_kernel",
                  "osd0": "osd0_kernel",
                  "sharded_min_sum_step": "sharded_step_kernel",
                  "peak_chain": "peak_chain_kernel",
                  "decide_classify": "decide_classify_kernel"}


def device_launches(fn) -> dict[str, int]:
    """Launches of each kernel of DEVICE_KERNELS that the card ran in
    ``fn()``, from torch.profiler's device events: the kernels of a
    replayed CUDA graph count too, which the wrappers' counts cannot see.
    A session that recorded none of them is taken again, up to three
    sessions (see :func:`device_ms`)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        # a kernel's key is its signature, e.g. "void (anonymous
        # namespace)::min_sum_kernel<3, true>(...)"
        on_device = [e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA]
        counts = {k: sum(e.count for e in on_device
                         if re.search(rf"(?<!\w){name}(?!\w)", e.key))
                  for k, name in DEVICE_KERNELS.items()}
        if any(counts.values()):
            break
    return counts


def bound(graph, batch: int, iters: int, algorithm: str,
          out_rows: int | None = None,
          lane_iters: int | None = None) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take
    for ``iters`` fixed iterations of ``algorithm`` on ``graph`` at
    ``batch``, or, under early exit, for the ``lane_iters`` lane-iterations
    the run executed.  Bytes: the int32 syndrome and (damped) the float32
    damping read once, the float32 output (``out_rows`` rows, default one
    per edge) and the int32 iteration counts written once."""
    out_rows = graph.num_edges if out_rows is None else out_rows
    nbytes = 4 * batch * (graph.num_checks + out_rows + 1)
    if algorithm == "min-sum-damped":
        nbytes += 4 * batch * graph.num_edges
    lane_iters = batch * iters if lane_iters is None else lane_iters
    flops = OPS_PER_EDGE_ITERATION[algorithm] * graph.num_edges * lane_iters
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def time_early_exit(device, g610: CodeGraphs, gen: torch.Generator) -> float:
    """Phase 7's early-exit timings: K2 with a check every 10 on W=40
    batches of [[610,61]] X at relay's p = 0.02, damped at batch 2048 and
    undamped at the osd cell's 16,384, each first held to its plain version
    (messages bit for bit, each lane's iterations), then timed beside a
    bound from the lane-iterations the run executed; then the osd cell's
    decode_batch with and without kernel_sort_lanes, in turns, outputs
    compared.  Returns the largest finite |kernel - plain| seen."""
    cfg = BPConfig(max_iters=MAX_ITERS, algorithm="min-sum")
    llr = min_sum.prior_llr(np.float32(cfg.prior_factor) * np.float32(RELAY_P))
    worst = 0.0
    for batch, damped, reps in ((BATCH, True, 20), (OSD_BATCH, False, 5)):
        syn = syndromes(g610, RELAY_WEIGHT, 12, device, batch=batch)[0]
        damping = random_damping(g610.x, gen, batch) if damped else None
        mode = "timed_damped" if damped else "timed"
        worst = max(worst, run_checks("min_sum", [
            ("[[610,61]]", "X", mode, g610.x, syn, llr, cfg, damping)],
            compare_min_sum))
        _, iters = min_sum_cuda.min_sum_run(g610.x, syn, llr, MAX_ITERS, 10,
                                            damping=damping)
        lane_iters = int(iters.sum())
        bound_ms, bound_by = bound(
            g610.x, batch, MAX_ITERS,
            "min-sum-damped" if damped else "min-sum", lane_iters=lane_iters)
        time_pair(
            "min_sum early exit",
            lambda: min_sum_cuda.min_sum_run(g610.x, syn, llr, MAX_ITERS, 10,
                                             damping=damping),
            lambda: min_sum.min_sum_run(g610.x, syn, llr, MAX_ITERS, 10,
                                        damping=damping),
            reps, 1, batch=batch, graph="[[610,61]] X W=40", damped=damped,
            device_kernel="min_sum_kernel",
            lane_iters=lane_iters, max_lane_iters=int(iters.max()),
            mean_lane_iters=f"{lane_iters / batch:.3f}",
            bound_ms=f"{bound_ms:.4f}", bound_by=bound_by)
    sx, sz = syndromes(g610, OSD_WEIGHT, 13, device, batch=OSD_BATCH)
    results, ms = {}, {False: [], True: []}
    for sort in (False, True, True, False):
        c = BPConfig(max_iters=MAX_ITERS, algorithm="min-sum",
                     kernel_sort_lanes=sort)
        ms[sort].append(time_ms(lambda: results.__setitem__(
            sort, decode_batch(g610, sx, sz, OSD_P, c)), 5))
    same = all(torch.equal(getattr(results[True], f), getattr(results[False], f))
               for f in ("decisions_x", "decisions_z", "error_code"))
    say("time", what="decode_batch, osd cell shape", batch=OSD_BATCH,
        unsorted_ms=[round(t, 4) for t in ms[False]],
        sorted_ms=[round(t, 4) for t in ms[True]],
        outputs_equal=same)
    check(same, "kernel_sort_lanes changed the decode's outputs")
    return worst


def k3_placements(g5210: CodeGraphs) -> list:
    """K3's placements besides its plans, checked in phase 6 and timed in
    phase 7: (name, plan).  On the P=521 Z graph the state in the lane's
    slab, then q and the state (plans for smaller limits)."""
    syn, q, state = layered_cuda.lane_arrays(g5210.z)
    return [
        ("[[5210,521]] state slab",
         layered_cuda.plan(g5210.z, syn + q)),
        ("[[5210,521]] q+state slab", layered_cuda.plan(g5210.z, syn)),
    ]


def time_shapes(label: str, runs: list, reps: int, **fields) -> dict:
    """Each (name, fn) of ``runs`` timed twice, in turns a, b, ..., b, a;
    prints and returns name -> [ms, ms]."""
    ms = {name: [] for name, _ in runs}
    for name, fn in [*runs, *runs[::-1]]:
        ms[name].append(round(time_ms(fn, reps), 4))
    say("time", kernel=label, **fields, ms=json.dumps(ms))
    return ms


def time_k3(g610: CodeGraphs, g5210: CodeGraphs, s610, s5210, llr: float,
            limit: int) -> None:
    """Phase 7's K3 readings beside its fixed-work time: the placements at
    P = 521 (on chip, the plan's, against the state and q in the slab), and
    early exit on the headline's W=15 batches (a test every sweep) beside a
    bound from the executed lane-iterations."""
    graph, syn = g5210.z, s5210[1]
    runs = [("plan", layered_cuda.plan(graph, limit)), *k3_placements(g5210)]
    time_shapes(
        "layered_min_sum shapes",
        [(name, lambda shape=shape: layered_cuda.layered_run(
            graph, syn, llr, SHARDED_ITERS, SHARDED_ITERS + 1, shape=shape))
         for name, shape in runs], 10,
        graph=f"P={graph.P} Z", batch=SHARDED_BATCH, sweeps=SHARDED_ITERS)
    for side, graph, syn in (("X", g610.x, s610[0]), ("Z", g610.z, s610[1])):
        _, iters = layered_cuda.layered_run(graph, syn, llr, MAX_ITERS, 1)
        lane_iters = int(iters.sum())
        bound_ms, bound_by = bound(graph, BATCH, MAX_ITERS, "layered",
                                   graph.num_vars, lane_iters=lane_iters)
        time_pair(
            "layered_min_sum early exit",
            lambda: layered_cuda.layered_run(graph, syn, llr, MAX_ITERS, 1),
            lambda: layered.layered_min_sum_run(graph, syn, llr, MAX_ITERS, 1),
            50, 1, graph=f"[[610,61]] {side} W={WEIGHT}",
            device_kernel="layered_min_sum_kernel",
            lane_iters=lane_iters, max_lane_iters=int(iters.max()),
            mean_lane_iters=f"{lane_iters / BATCH:.3f}",
            bound_ms=f"{bound_ms:.4f}", bound_by=bound_by)


def time_k5_early_exit(gross: CodeGraphs, device, gen: torch.Generator,
                       llr: float) -> None:
    """Phase 11's K5 readings under early exit, beside bounds from the
    executed lane-iterations: the gross min-sum cell's decode (depolarizing
    p = 0.01, a test every 10) on X and Z, and a damped decode at the gross
    relay cell's p = 0.03 with random gammas."""
    s01 = syndromes(gross, 0, 15, device, p_err=GROSS_P)
    s03 = syndromes(gross, 0, 16, device, p_err=GROSS_RELAY_P)
    cases = [("X", gross.x, s01[0], GROSS_P, None),
             ("Z", gross.z, s01[1], GROSS_P, None),
             ("X", gross.x, s03[0], GROSS_RELAY_P, random_damping(gross.x, gen))]
    for side, graph, syn, p_err, damping in cases:
        llr_p = min_sum.prior_llr(np.float32(BPConfig().prior_factor)
                                  * np.float32(p_err))
        _, iters = min_sum_cuda.min_sum_run(graph, syn, llr_p, MAX_ITERS, 10,
                                            damping=damping)
        lane_iters = int(iters.sum())
        damped = damping is not None
        bound_ms, bound_by = bound(
            graph, BATCH, MAX_ITERS, "min-sum-damped" if damped else "min-sum",
            lane_iters=lane_iters)
        time_pair(
            "lifted_min_sum early exit",
            lambda: min_sum_cuda.min_sum_run(graph, syn, llr_p, MAX_ITERS, 10,
                                             damping=damping),
            lambda: min_sum.min_sum_run(graph, syn, llr_p, MAX_ITERS, 10,
                                        damping=damping),
            50, 1, graph=f"{GROSS} {side} p={p_err}", damped=damped,
            device_kernel="lifted_min_sum_kernel",
            lane_iters=lane_iters, max_lane_iters=int(iters.max()),
            mean_lane_iters=f"{lane_iters / BATCH:.3f}",
            bound_ms=f"{bound_ms:.4f}", bound_by=bound_by)


def time_k6_early_exit(gross: CodeGraphs, device) -> None:
    """Phase 11's K6 readings under early exit: the gross sum-product
    cell's decode (depolarizing p = 0.01, a test every 10) on X and Z,
    beside bounds from the executed lane-iterations."""
    s01 = syndromes(gross, 0, 15, device, p_err=GROSS_P)
    prior = np.float32(BPConfig().prior_factor) * np.float32(GROSS_P)
    prior_t = torch.tensor(prior, device=device)
    for side, graph, syn in (("X", gross.x, s01[0]), ("Z", gross.z, s01[1])):
        _, iters = bp_cuda.bp_run(graph, syn, prior, MAX_ITERS, 10)
        lane_iters = int(iters.sum())
        bound_ms, bound_by = bound(graph, BATCH, MAX_ITERS, "sum-product",
                                   lane_iters=lane_iters)
        time_pair(
            "lifted_bp early exit",
            lambda: bp_cuda.bp_run(graph, syn, prior, MAX_ITERS, 10),
            lambda: sum_product.bp_run(graph, syn, prior_t, MAX_ITERS, 10),
            50, 1, graph=f"{GROSS} {side} p={GROSS_P}",
            device_kernel="lifted_bp_kernel",
            lane_iters=lane_iters, max_lane_iters=int(iters.max()),
            mean_lane_iters=f"{lane_iters / BATCH:.3f}",
            bound_ms=f"{bound_ms:.4f}", bound_by=bound_by)


def syndromes(graphs: CodeGraphs, weight: int, seed: int, device,
              p_err: float | None = None, batch: int = BATCH):
    """One batch of syndromes: weight-``weight`` Pauli errors, or
    depolarizing ones at ``p_err``."""
    gen = chunk_generator(seed, 0, device)
    if p_err is None:
        xe, ze = sample_weight_w_errors(gen, graphs.code.n, weight, batch)
    else:
        xe, ze = sample_depolarizing_errors(gen, graphs.code.n, p_err, batch)
    return (graphs.x.syndrome(xe.to(torch.int32)),
            graphs.z.syndrome(ze.to(torch.int32)))


def relay_shaped(syndrome: torch.Tensor) -> torch.Tensor:
    """A relay retry's batch: every RELAY_SHAPED_EVERY-th lane keeps its
    syndrome, the others are solved (a zero syndrome)."""
    keep = torch.arange(syndrome.shape[1], device=syndrome.device)
    keep = keep % RELAY_SHAPED_EVERY == 0
    return torch.where(keep[None, :], syndrome, 0).contiguous()


def random_damping(graph, gen: torch.Generator, batch: int = BATCH):
    """Relay's per-variable damping, gamma ~ U[0.05, 1.0), on every edge."""
    gamma = torch.rand((graph.num_vars, batch), generator=gen,
                       device=gen.device)
    return graph.expand_vars(gamma * 0.95 + 0.05).contiguous()


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
    """K1 (K6 on a lifted graph) vs plain BP on one graph.  Both count each
    lane's own iterations: every lane's count must equal the plain count of
    that lane alone."""
    v_k, it_k = bp_cuda.bp_run(graph, syndrome, prior, cfg.max_iters,
                               cfg.check_every, cfg.conv_low, cfg.conv_high)
    v_p, lanes_p = sum_product.bp_run_lanes(
        graph, syndrome, torch.tensor(prior, device=syndrome.device),
        cfg.max_iters, cfg.check_every, cfg.conv_low, cfg.conv_high)
    torch.cuda.synchronize()
    mism, err, nans = bit_mismatches(v_k, v_p)
    mism += flag_mismatches(decide(graph, v_k, syndrome, cfg),
                            decide(graph, v_p, syndrome, cfg))
    mism += int((it_k != lanes_p).sum())
    return mism, err, int(lanes_p.max()), nans


def compare_min_sum(graph, syndrome, llr: float, cfg: BPConfig, damping=None):
    """K2 (or K4, by the graph's P; K5 on a lifted graph) vs plain min-sum
    on one graph.  All three count each lane's own iterations: every lane's
    count must equal the plain count of that lane alone."""
    v_k, it_k = min_sum_cuda.min_sum_run(graph, syndrome, llr, cfg.max_iters,
                                         cfg.check_every, cfg.conv_low,
                                         cfg.min_sum_alpha, damping=damping)
    return min_sum_against_plain(graph, syndrome, llr, cfg, v_k, it_k,
                                 damping)


def min_sum_against_plain(graph, syndrome, llr: float, cfg: BPConfig,
                          v_k: torch.Tensor, it_k: torch.Tensor,
                          damping=None):
    """A min-sum kernel's messages ``v_k`` and per-lane iterations ``it_k``
    on one graph against plain min-sum on the same syndromes, as
    :func:`compare_min_sum` counts them."""
    v_p, lanes_p = min_sum.min_sum_run_lanes(
        graph, syndrome, llr, cfg.max_iters, cfg.check_every, cfg.conv_low,
        cfg.min_sum_alpha, damping=damping)
    torch.cuda.synchronize()
    mism, err, nans = bit_mismatches(v_k, v_p)
    mism += flag_mismatches(decide(graph, v_k, syndrome, cfg),
                            decide(graph, v_p, syndrome, cfg))
    mism += int((it_k != lanes_p).sum())
    return mism, err, int(lanes_p.max()), nans


def compare_layered(graph, syndrome, llr: float, cfg: BPConfig, shape=None):
    """K3 (with the launch shape ``shape``, by default its plan's) vs plain
    layered min-sum on one graph.  K3 counts each lane's own sweeps: every
    lane's count must equal the plain count of that lane alone."""
    q_k, it_k = layered_cuda.layered_run(graph, syndrome, llr, cfg.max_iters,
                                         cfg.layered_check_every,
                                         cfg.min_sum_alpha, shape=shape)
    q_p, lanes_p = layered.layered_min_sum_run_lanes(
        graph, syndrome, llr, cfg.max_iters, cfg.layered_check_every,
        cfg.min_sum_alpha)
    torch.cuda.synchronize()
    mism, err, nans = bit_mismatches(q_k, q_p)
    d_k, d_p = (q_k <= 0).to(torch.int8), (q_p <= 0).to(torch.int8)
    mism += int((d_k != d_p).sum())
    mism += int((syndrome_fail(graph, d_k, syndrome)
                 != syndrome_fail(graph, d_p, syndrome)).sum())
    mism += int((it_k != lanes_p).sum())
    return mism, err, int(lanes_p.max()), nans


def long_cap_k1(device, g42: CodeGraphs, prior: np.float32) -> float:
    """K1 at the corpus's long caps on [[42,0]] at W=LONG_WEIGHT, where BP
    fails on nearly every lane and each runs to its cap: held to the plain
    loop at LONG_CAP on LONG_LANES lanes (the largest cap whose plain loop
    takes about 30 s there), then one launch at MAX=10^5 on a full batch,
    timed (golden_sweep42's longest points run it).  Returns the largest
    finite |kernel - plain|."""
    s_long = syndromes(g42, LONG_WEIGHT, 24, device, batch=LONG_LANES)
    t0 = time.perf_counter()
    worst = run_checks("bp_sum_product", [
        ("[[42,0]]", "X", f"early_exit cap {LONG_CAP}", g42.x, s_long[0],
         prior, BPConfig(max_iters=LONG_CAP))], compare_bp)
    say("check", kernel="bp_sum_product", long_cap=LONG_CAP,
        lanes=LONG_LANES, seconds=f"{time.perf_counter() - t0:.2f}")
    s_full = syndromes(g42, LONG_WEIGHT, 25, device)
    cap = 100_000
    _, iters = bp_cuda.bp_run(g42.x, s_full[0], prior, cap, 10)
    ms = time_ms(lambda: bp_cuda.bp_run(g42.x, s_full[0], prior, cap, 10), 2)
    lane_iters = int(iters.sum())
    bound_ms, bound_by = bound(g42.x, BATCH, cap, "sum-product",
                               lane_iters=lane_iters)
    say("time", kernel="bp_sum_product", graph=f"[[42,0]] X W={LONG_WEIGHT}",
        max_iters=cap, batch=BATCH, ms_per_launch=f"{ms:.3f}",
        lane_iters=lane_iters, lanes_at_cap=int((iters == cap).sum()),
        us_per_iteration=f"{1e3 * ms / int(iters.max()):.3f}",
        bound_ms=f"{bound_ms:.4f}", bound_by=bound_by)
    return worst


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


def device_ms(fn, reps: int, kernel: str) -> float:
    """ms per launch of the CUDA kernel whose name holds ``kernel`` over
    ``reps`` calls of ``fn()`` (one launch each), from torch.profiler's
    device time: no host work between the launches is counted.  The mean
    is over the launches the profiler recorded, which may miss some; a
    session that recorded none of them (seen once in four runs of this
    script) is taken again, up to three sessions."""
    fn()  # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        on_device = [e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA]
        mine = [e for e in on_device if kernel in e.key]
        launches = sum(e.count for e in mine)
        if launches:
            break
    check(0 < launches <= reps,
          f"the profiler saw {launches} launches of {kernel} in {reps} calls "
          f"(device events: {[(e.key[:80], e.count) for e in on_device]})")
    return 1e-3 * sum(e.self_device_time_total for e in mine) / launches


def time_pair(label: str, kernel, plain, kernel_reps: int, plain_reps: int,
              batch: int = BATCH, device_kernel: str | None = None,
              **fields) -> tuple[float, float]:
    """Kernel vs plain in turns (plain, kernel, kernel, plain); returns the
    mean ms of each (CUDA events).  ``device_kernel``: the kernel's name,
    whose profiler device time (:func:`device_ms`, twice) is printed
    beside them."""
    plain_ms = [time_ms(plain, plain_reps)]
    kernel_ms = [time_ms(kernel, kernel_reps), time_ms(kernel, kernel_reps)]
    plain_ms.append(time_ms(plain, plain_reps))
    k_ms, p_ms = float(np.mean(kernel_ms)), float(np.mean(plain_ms))
    if device_kernel is not None:
        fields["kernel_device_ms"] = [
            round(device_ms(kernel, kernel_reps, device_kernel), 4)
            for _ in range(2)]
    say("time", kernel=label, batch=batch, **fields,
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
    """One main-path run through ``run_monte_carlo``, timed, with every
    launch count set to 0 just before it, then the same run again under
    the profiler, which must count the same and gives the launches the
    card ran (:func:`device_launches`); the wrappers' counts of both runs
    are printed as ``host_calls``.  A 2-group warm-up first counts the host
    syncs.  Returns (counters, lane_iters, seconds, device launches,
    warm-up syncs)."""
    syncs = count_syncs(lambda: run_monte_carlo(
        graphs, weight, 4 * BATCH, p_err, cfg, seed=0, batch_size=BATCH,
        steps_per_call=2, relay_retries=relay_retries,
        i_minus_p=logical_test, error_model=error_model, device=device))

    def run():
        return run_monte_carlo(
            graphs, weight, chunks * BATCH, p_err, cfg, seed=seed,
            batch_size=BATCH, steps_per_call=steps_per_call,
            relay_retries=relay_retries, i_minus_p=logical_test,
            error_model=error_model, device=device)

    reset_counts()
    t0 = time.perf_counter()
    counters, lane_iters = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    again = []
    counts = device_launches(lambda: again.append(run()))
    check(np.array_equal(again[0][0], counters) and again[0][1] == lane_iters,
          f"{label}: the same run counted otherwise")
    calls = read_counts()
    tested = int(counters[C_TESTED])
    say("main", path=label, samples=tested, seconds=f"{seconds:.4f}",
        samples_per_s=f"{tested / seconds:.1f}",
        lane_iters_per_s=f"{lane_iters / seconds:.1f}",
        corrected_fraction=f"{counters[C_CORRECTED] / tested:.6f}",
        warmup_host_syncs=syncs,
        launches=json.dumps({k: v for k, v in counts.items() if v}),
        host_calls=json.dumps({k: v for k, v in calls.items() if v}))
    check(tested == chunks * BATCH, f"{label}: tested {tested}")
    return counters, lane_iters, seconds, counts, syncs


def check_launches(label: str, counts: dict, kernel: str, chunks: int,
                   fused: bool, per_chunk: int = 2) -> int:
    """The run launched ``kernel`` ``per_chunk`` times per chunk (X and Z;
    once where both sectors share a launch), the fused decide/classify
    kernel once per chunk where ``fused`` (sum-product and min-sum) and
    never otherwise, and nothing else (``counts`` from
    :func:`device_launches`); returns ``kernel``'s count."""
    expected = {k: 0 for k in counts}
    expected[kernel] = per_chunk * chunks
    expected["decide_classify"] = chunks if fused else 0
    check(counts == expected, f"{label}: launch counts {counts}, expected "
                              f"{expected}")
    return counts[kernel]


#: decode launches a chunk on the lifted main paths, stated here and not
#: asked of the program: K5 decodes both sectors in one launch (phase 30),
#: K6 one sector a launch
LIFTED_LAUNCHES_PER_CHUNK = {"lifted_min_sum": 1, "lifted_bp": 2}


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
                                     relay_draws(seed, 0, device), cfg,
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


@contextlib.contextmanager
def counting(owner, name: str):
    """Count the calls of ``owner.name`` inside the block; yields a
    one-item list holding the count."""
    calls = [0]
    original = getattr(owner, name)

    def counted(*args, **kwargs):
        calls[0] += 1
        return original(*args, **kwargs)

    setattr(owner, name, counted)
    try:
        yield calls
    finally:
        setattr(owner, name, original)


def compare_osd0(h, syn: torch.Tensor, soft: torch.Tensor):
    """K7 vs its plain version on these lanes: (mismatches, max |diff|,
    solved lanes); the outputs are corrections, solved flags, s_final, used
    and pivcol."""
    args = osd0_args(h, syn, soft)
    got = osd0_cuda.osd0_solve(*args)
    want = osd0_cuda.osd0_solve_plain(*args)
    torch.cuda.synchronize()
    mism = sum(int((g != w).sum()) for g, w in zip(got, want))
    err = max((float((g.int() - w.int()).abs().max()) if g.numel() else 0.0)
              for g, w in zip(got, want))
    return mism, err, int(got[1].sum())


def osd0_bound(hcols: torch.Tensor, syn: torch.Tensor, order: torch.Tensor,
               m: int, n: int, rank: int) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take for
    K7 on these lanes.  Operations: the work the plain walk counts on the
    same inputs (per column before a lane's rank-th pivot, 2 per row for the
    bit test and pick, plus the XORs of words c // 32 .. w in each row that
    takes the pivot row); bytes: the order and syndromes read once per lane
    and H's packed columns once, the corrections, flags, s_final, used and
    pivcol written once."""
    lanes = order.shape[0]
    work = torch.zeros(lanes, dtype=torch.int64, device=order.device)
    osd0_cuda.osd0_eliminate(osd0_cuda.ordered_system(hcols, syn, order, m, n),
                             m, n, rank, work=work)
    ops = int(work.sum())
    nbytes = lanes * (4 * n + 4 * m) + 4 * n * -(-m // 32) + lanes * (n + 1 + 6 * m)
    t_ops, t_bytes = ops / PEAK_INT32_OPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "bytes" if t_bytes > t_ops else "operations"


def quality_run(label: str, graphs: CodeGraphs, weight: int, p_err: float,
                cfg: BPConfig, chunks: int, batch: int, seed: int, lam: int,
                logical_test, device, relay_retries: int = 0,
                error_model: str = "weight", progress=None):
    """One run_monte_carlo_osd with every launch count set to 0 just before
    it and read just after, and the host-library calls and host reads
    (event waits) counted.  Returns (counters, seconds, launch counts,
    host-library calls, event waits)."""
    reset_counts()
    with counting(native, "osd_batch") as host_calls, \
            counting(torch.cuda.Event, "synchronize") as waits:
        t0 = time.perf_counter()
        counters, lane_iters = run_monte_carlo_osd(
            graphs, weight, chunks * batch, p_err, cfg, seed=seed,
            batch_size=batch, lam=lam, error_model=error_model,
            relay_retries=relay_retries, i_minus_p=logical_test,
            progress=progress, device=device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    counts = read_counts()
    tested = int(counters[C_TESTED])
    say("main", path=label, samples=tested, seconds=f"{seconds:.4f}",
        samples_per_s=f"{tested / seconds:.1f}",
        lane_iters_per_s=f"{lane_iters / seconds:.1f}",
        corrected_fraction=f"{counters[C_CORRECTED] / tested:.6f}",
        counters=json.dumps([int(c) for c in counters]),
        host_osd_calls=host_calls[0], host_reads=waits[0],
        launches=json.dumps({k: v for k, v in counts.items() if v}))
    check(tested == chunks * batch, f"{label}: tested {tested}")
    check(counters[C_SYN_X] == 0 and counters[C_SYN_Z] == 0,
          f"{label}: OSD left syndrome failures")
    return counters, seconds, counts, host_calls[0], waits[0]


def gate_counts(label: str, what: str, k: int, n: int, reference) -> None:
    """A count agrees with a JAX-package record by a two-proportion test."""
    z = two_proportion_z(k, n, *reference)
    say("gate", path=label, what=what, fraction=f"{k / n:.6f}",
        reference=f"{reference[0] / reference[1]:.6f}", z=f"{z:+.2f}")
    check(abs(z) < 4, f"{label}: {what} off the JAX package's record (z={z})")


def osd_phases(device, g610: CodeGraphs, gross: CodeGraphs, bb756: CodeGraphs,
               logical_610, logical_gross, worst: dict, times: dict,
               launches: dict) -> dict:
    """Phases 14-17: K7 checked and timed, the quality mode's main path
    (device OSD-0) and the host-OSD quality stacks.  Fills ``worst``,
    ``times`` and ``launches`` for K7; returns K7's (ms, plain ms, bound ms,
    bound_by) per [[610,61]] sector."""
    # 14. K7 vs plain on the card ---------------------------------------------
    phase("14 K7 vs plain")
    osd_lanes = osd_failed_lanes(g610, OSD_FAILED_SEED, device, OSD_BATCH,
                                 weight=OSD_WEIGHT)
    gross_lanes = osd_failed_lanes(gross, 16, device, BATCH,
                                   p_err=GROSS_QUALITY_P)
    lanes_756 = osd_failed_lanes(bb756, 17, device, BATCH,
                                 p_err=GROSS_QUALITY_P)
    gen_osd = torch.Generator(device=device)
    gen_osd.manual_seed(18)
    cases = []
    for side, (h, syn, soft) in zip("XZ", osd_lanes):
        m, n = h.shape
        rnd_syn = torch.randint(0, 2, (m, 64), generator=gen_osd, device=device,
                                dtype=syn.dtype)
        rnd_soft = torch.randn((n, 64), generator=gen_osd, device=device)
        cases += [("[[610,61]]", side, "failed", h, syn, soft),
                  ("[[610,61]]", side, "failed+random",
                   h, torch.cat([syn, rnd_syn], dim=1),
                   torch.cat([soft, rnd_soft], dim=1))]
    for code, sectors in ((GROSS, gross_lanes), ("[[756,16,34]]", lanes_756)):
        for side, (h, syn, soft) in zip("XZ", sectors):
            cases.append((code, side, "failed", h, syn, soft))
    worst["osd0"] = 0.0
    for code, side, mode, h, syn, soft in cases:
        mism, err, solved = compare_osd0(h, syn, soft)
        say("check", kernel="osd0", code=code, graph=side, mode=mode,
            lanes=syn.shape[1], solved=solved, mismatches=mism,
            max_abs_err=err)
        check(syn.shape[1] > 0, f"osd0: no failed lanes ({code} {side})")
        check(mism == 0, f"osd0 disagrees with its plain version ({code} "
                         f"{side} {mode})")
        if mode == "failed":
            check(solved == syn.shape[1], f"osd0: a decodable lane unsolved "
                                          f"({code} {side})")
        worst["osd0"] = max(worst["osd0"], err)
    for side, (h, syn, soft) in zip("XZ", osd_lanes):
        e_d, ok_d = OSDecoder(h, lam=0).decode(syn, soft)
        with counting(native, "osd_batch") as host_calls:
            e_h, ok_h = OSDecoder(h, lam=0, device="host").decode(syn, soft)
        mism = int((e_d != e_h).sum()) + int((ok_d != ok_h).sum())
        raw = torch.argsort(soft, dim=0, stable=True)
        raw_cpu = torch.argsort(soft.cpu(), dim=0, stable=True)
        rank_mism = int((ranking(soft).cpu() != ranking(soft.cpu())).sum())
        say("check", what="osd0 vs host library", graph=side,
            lanes=syn.shape[1], mismatches=mism, host_calls=host_calls[0],
            ranking_cuda_vs_cpu_mismatches=rank_mism,
            raw_argsort_cuda_vs_cpu_mismatches=int((raw.cpu() != raw_cpu).sum()),
            zero_or_nan_soft=int(((soft == 0) | soft.isnan()).sum()))
        check(mism == 0 and host_calls[0] == 1,
              f"OSDecoder on CUDA vs the host library ({side})")
        check(rank_mism == 0, f"the ranking differs on the card ({side})")
    # planted lanes: ±0.0, NaN, ±inf and ties, which the real lanes lack
    h, syn, soft = osd_lanes[1]
    special = torch.tensor([0.0, -0.0, math.nan, math.inf, -math.inf, 1.5,
                            -1.5], device=device)
    pick = torch.randint(0, len(special), (soft.shape[0], 16),
                         generator=gen_osd, device=device)
    planted = torch.cat([soft[:, :8], special[pick]], dim=1)
    planted[::7, :8] = special[pick[::7, :8]]
    got_rank = ranking(planted).cpu()
    want_rank = np.argsort(planted.cpu().numpy(), axis=0, kind="stable").T
    rank_mism = int((got_rank != ranking(planted.cpu())).sum())
    numpy_mism = int((got_rank.numpy() != want_rank).sum())
    planted_syn = torch.cat([syn[:, :8], torch.randint(
        0, 2, (syn.shape[0], 16), generator=gen_osd, device=device,
        dtype=syn.dtype)], dim=1)
    mism, err, solved = compare_osd0(h, planted_syn, planted)
    say("check", what="ranking and osd0 on planted soft outputs",
        lanes=planted.shape[1], special_values=int(
            ((planted == 0) | ~planted.isfinite()).sum()),
        ranking_cuda_vs_cpu_mismatches=rank_mism,
        ranking_cuda_vs_numpy_mismatches=numpy_mism, mismatches=mism,
        solved=solved)
    check(rank_mism == 0 and numpy_mism == 0,
          "the ranking of planted soft outputs differs on the card")
    check(mism == 0, "osd0 disagrees with its plain version (planted)")
    worst["osd0"] = max(worst["osd0"], err)

    # 15. K7 time vs plain (OSD_TIMED_LANES failed-lane inputs) ----------------
    phase("15 K7 time")
    osd_times = {}
    for side, sector in zip("XZ", osd_lanes):
        args = k7_inputs(sector)
        bound_ms, bound_by = osd0_bound(*args)
        k_ms, p_ms = time_pair(
            "osd0", lambda: osd0_cuda.osd0_solve(*args),
            lambda: osd0_cuda.osd0_solve_plain(*args), 20, 2,
            batch=OSD_TIMED_LANES, device_kernel="osd0_kernel",
            graph=f"[[610,61]] {side}",
            distinct_lanes=sector[1].shape[1], bound_ms=f"{bound_ms:.4f}",
            bound_by=bound_by)
        osd_times[side] = (k_ms, p_ms, bound_ms, bound_by)
        # the build and read-off alone: at rank 0 the walk stops at once
        build_only = (*args[:-1], 0)
        say("time", kernel="osd0 build and read-off alone (rank 0)",
            batch=OSD_TIMED_LANES, graph=f"[[610,61]] {side}",
            kernel_ms=[round(time_ms(lambda: osd0_cuda.osd0_solve(
                *build_only), 20), 4) for _ in range(2)],
            kernel_device_ms=[round(device_ms(lambda: osd0_cuda.osd0_solve(
                *build_only), 20, "osd0_kernel"), 4) for _ in range(2)])
        # on the osd cell's own lanes: the failed lanes of one decode
        args = osd0_args(*sector)
        say("time", kernel="osd0 osd cell lanes", graph=f"[[610,61]] {side}",
            batch=sector[1].shape[1], kernel_device_ms=[
                round(device_ms(lambda: osd0_cuda.osd0_solve(*args), 20,
                                "osd0_kernel"), 4) for _ in range(2)])
    times["osd0"] = osd_times["Z"][:2]

    # 16. the quality mode's main path: min-sum + device OSD-0 ------------------
    phase("16 quality mode")
    osd_cfg = BPConfig(max_iters=MAX_ITERS, algorithm="min-sum")
    label = f"min-sum + OSD-{OSD_LAM} W={OSD_WEIGHT}"
    syncs = {}
    for chunks in (1, 3):  # the warm-up; the difference is per chunk
        syncs[chunks] = count_syncs(lambda: run_monte_carlo_osd(
            g610, OSD_WEIGHT, chunks * OSD_BATCH, OSD_P, osd_cfg, seed=0,
            batch_size=OSD_BATCH, lam=OSD_LAM, i_minus_p=logical_610,
            device=device))
    per_chunk = []
    counters, seconds, counts, host_calls, waits = quality_run(
        label, g610, OSD_WEIGHT, OSD_P, osd_cfg, OSD_CHUNKS, OSD_BATCH, 8,
        OSD_LAM, logical_610, device,
        progress=lambda c, nc, cnt, it: per_chunk.append(cnt.copy()))
    blocking = (syncs[3] - syncs[1]) / 2
    say("main", path=label, warmup_host_syncs=json.dumps(syncs),
        blocking_syncs_per_chunk=blocking,
        host_reads_per_chunk=waits / OSD_CHUNKS)
    check(counts["osd0"] == 2 * OSD_CHUNKS and counts["min_sum"] == 2 * OSD_CHUNKS
          and host_calls == 0,
          f"{label}: launches {counts}, host-library calls {host_calls}")
    check(blocking == 0 and waits == 2 * OSD_CHUNKS,
          f"{label}: {blocking} blocking syncs and {waits / OSD_CHUNKS} host "
          f"reads per chunk")
    launches["osd0"] = counts["osd0"]
    tested = int(counters[C_TESTED])
    gate_counts(label, "corrected", int(counters[C_CORRECTED]), tested,
                OSD_CORRECTED)
    gate_counts(label, "convergence-fail (X + Z)",
                int(counters[C_CONV_X] + counters[C_CONV_Z]), tested,
                OSD_CONV_FAIL)
    # chunk 0 again, through the host route
    original = montecarlo.CSSPostprocessor
    montecarlo.CSSPostprocessor = (
        lambda graphs, lam=0: original(graphs, lam=lam, device="host"))
    try:
        with counting(native, "osd_batch") as host_calls:
            host_counters, _ = run_monte_carlo_osd(
                g610, OSD_WEIGHT, OSD_BATCH, OSD_P, osd_cfg, seed=8,
                batch_size=OSD_BATCH, lam=OSD_LAM, i_minus_p=logical_610,
                device=device)
    finally:
        montecarlo.CSSPostprocessor = original
    say("main", path=label, chunk=0, device_route=json.dumps(
        [int(c) for c in per_chunk[0]]), host_route=json.dumps(
        [int(c) for c in host_counters]), host_calls=host_calls[0])
    check(host_calls[0] == 2 and np.array_equal(per_chunk[0], host_counters),
          f"{label}: the host route's chunk 0 differs")

    # 17. the host-OSD quality stacks -----------------------------------------
    phase("17 host-OSD stacks")
    for label, graphs, weight, p_err, cfg, chunks, relay, lam, model, \
            logical, reference in (
            (f"layered + relay{QUALITY_RELAY} + OSD-{QUALITY_LAM} W={OSD_WEIGHT}",
             g610, OSD_WEIGHT, OSD_P,
             BPConfig(max_iters=MAX_ITERS, algorithm="layered-min-sum"),
             QUALITY_CHUNKS, QUALITY_RELAY, QUALITY_LAM, "weight",
             logical_610, QUALITY_CORRECTED),
            (f"gross min-sum + relay{GROSS_QUALITY_RELAY} + "
             f"OSD-{GROSS_QUALITY_LAM} p={GROSS_QUALITY_P}", gross, 0,
             GROSS_QUALITY_P, osd_cfg, GROSS_QUALITY_CHUNKS,
             GROSS_QUALITY_RELAY, GROSS_QUALITY_LAM, "depolarizing",
             logical_gross, GROSS_QUALITY_CORRECTED)):
        counters, _, counts, host_calls, _ = quality_run(
            label, graphs, weight, p_err, cfg, chunks, BATCH, 9, lam, logical,
            device, relay_retries=relay, error_model=model)
        check(host_calls > 0 and counts["osd0"] == 0,
              f"{label}: host-library calls {host_calls}, K7 launches "
              f"{counts['osd0']}")
        gate_counts(label, "corrected", int(counters[C_CORRECTED]),
                    int(counters[C_TESTED]), reference)
    return osd_times


# -- phases 18-21: K8 and the multi-device engines ----------------------------

def k8_inputs(router: ShardRouter, batch: int, device, seed: int,
              planted: bool):
    """K8's (syn_sign, other, done, v) in the row layout: V ~ 4 N(0, 1), the
    other shards' minima |N(0, 1)| + 0.5 and random signs, syndrome signs
    -1 on 30% of checks.  ``planted``: about 3% each of +0.0, -0.0, NaN,
    +inf and -inf in V and the minima, and half the lanes done; else no lane
    done."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    checks = router.B * router.P

    def draw(shape, nonneg=False):
        a = torch.randn(shape, generator=gen, device=device) * 4
        if nonneg:
            a = a.abs() / 4 + 0.5
        if planted:
            pick = torch.rand(shape, generator=gen, device=device)
            for i, value in enumerate((0.0, -0.0, math.nan, math.inf,
                                       -math.inf)):
                a[(pick >= 0.03 * i) & (pick < 0.03 * (i + 1))] = value
        return a

    def signs(shape, share):
        return torch.where(torch.rand(shape, generator=gen, device=device)
                           < share, -1.0, 1.0)

    v = draw((router.Lc * checks, batch))
    other = torch.cat([draw((checks, batch), nonneg=True),
                       signs((checks, batch), 0.5)])
    done = (torch.rand(batch, generator=gen, device=device) < 0.5
            if planted else torch.zeros(batch, dtype=torch.bool, device=device))
    return signs((checks, batch), 0.3), other, done, v


def k8_bound(router: ShardRouter, batch: int) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take
    for one K8 step.  Operations: min-sum's 15 per edge; bytes: V, the other
    shards' (min; sign), the syndrome signs and the done mask read once, V_new
    and the partials written once."""
    rows, checks = router.Lc * router.B * router.P, router.B * router.P
    nbytes = 4 * batch * (rows + 2 * checks + checks + rows + 2 * checks) + batch
    flops = OPS_PER_EDGE_ITERATION["min-sum"] * rows * batch
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def check_k8(device, g610: CodeGraphs, g5210: CodeGraphs, llr: float) -> float:
    """Phase 18: K8 vs plain on every shard position at every batch of
    K8_BATCHES with the plan's launch shape, and at the main path's batch
    with every shape of K8_SHAPES on the [[5210,521]] G=2 shards; returns
    the largest finite |kernel - plain| (0 when bit for bit)."""
    alpha = BPConfig().min_sum_alpha
    limit = placement.smem_optin(device.index)
    worst = 0.0
    for code, side, graph, G in (("[[5210,521]]", "X", g5210.x, 2),
                                 ("[[5210,521]]", "X", g5210.x, 5),
                                 ("[[5210,521]]", "Z", g5210.z, 2),
                                 ("[[5210,521]]", "Z", g5210.z, 5),
                                 ("[[610,61]]", "X", g610.x, 2)):
        mism = nans = 0
        shapes = set()
        for g in range(G):
            router = ShardRouter(graph, G, g)
            runs = [(batch, None) for batch in K8_BATCHES]
            if code == "[[5210,521]]" and G == 2:
                runs += [(SHARDED_BATCH, sharded_step_cuda.plan(router, limit, *s))
                         for s in K8_SHAPES]
            for batch, shape in runs:
                args = k8_inputs(router, batch, device, 180 + 10 * G + g, True)
                shapes.add(sharded_step_cuda.plan(router, limit) if shape is None
                           else shape)
                for last in (0, 1):
                    got = sharded_step_cuda.sharded_min_sum_step(
                        router, llr, last, *args, alpha, shape)
                    want = sharded_step_cuda.sharded_min_sum_step_plain(
                        router, llr, last, *args, alpha)
                    torch.cuda.synchronize()
                    for a, b in zip(got, want):
                        m, err, n = bit_mismatches(a, b)
                        mism, nans, worst = mism + m, nans + n, max(worst, err)
        say("check", kernel="sharded_min_sum_step", code=code, graph=side,
            G=G, Lc=graph.L // G, shards=G, last="0,1",
            batch=",".join(map(str, K8_BATCHES)), nan_entries=nans,
            shapes=json.dumps(sorted(shape_label(s) for s in shapes)),
            mismatches=mism)
        check(mism == 0, f"K8 disagrees with its plain version ({code} "
                         f"{side} G={G})")
    return worst


def shape_label(shape) -> str:
    """A K8 launch shape as lanes/route/placement, e.g. 8/read/smem."""
    return (f"{shape.lanes}/{'fold' if shape.fold else 'read'}/"
            f"{'slab' if shape.slab_bytes else 'smem'}")


def time_k8(device, g5210: CodeGraphs, llr: float) -> dict:
    """Phase 19: one step of shard 0 of 2 of the [[5210,521]] X graph,
    kernel (the plan's shape) vs plain in turns, then every shape of
    K8_SHAPES in turns (forwards, then backwards); batch -> (ms, plain ms,
    bound ms, bound_by)."""
    alpha = BPConfig().min_sum_alpha
    router = ShardRouter(g5210.x, SHARDED_GRAPH, 0)
    limit = placement.smem_optin(device.index)
    out = {}
    for batch in K8_BATCHES:
        args = k8_inputs(router, batch, device, 190, False)
        bound_ms, bound_by = k8_bound(router, batch)
        k_ms, p_ms = time_pair(
            "sharded_min_sum_step",
            lambda: sharded_step_cuda.sharded_min_sum_step(router, llr, 0,
                                                           *args, alpha),
            lambda: sharded_step_cuda.sharded_min_sum_step_plain(
                router, llr, 0, *args, alpha),
            200, 10, batch=batch, graph="[[5210,521]] X shard 0 of 2",
            shape=shape_label(sharded_step_cuda.plan(router, limit)),
            bound_ms=f"{bound_ms:.4f}", bound_by=bound_by)
        out[batch] = (k_ms, p_ms, bound_ms, bound_by)
        shapes = [sharded_step_cuda.plan(router, limit, *s) for s in K8_SHAPES]
        time_shapes(
            "sharded_min_sum_step shapes",
            [(shape_label(shape), lambda shape=shape:
              sharded_step_cuda.sharded_min_sum_step(router, llr, 0, *args,
                                                     alpha, shape))
             for shape in shapes], 200, batch=batch,
            graph="[[5210,521]] X shard 0 of 2", bound_ms=f"{bound_ms:.4f}")
    return out


@contextlib.contextmanager
def auditing_syndromes(graphs: CodeGraphs, device):
    """Inside the block, audit on the card every chunk that the
    graph-sharded Monte-Carlo (``mc_graph``) classifies: in each sector, a
    lane whose error code reports no syndrome failure must have gathered
    decisions that reproduce its syndrome.  Yields an int64 tensor (lanes
    audited, X and Z counted apart; lanes violating their syndrome), kept
    on the card so that the audit adds no host sync."""
    tally = torch.zeros(2, dtype=torch.int64, device=device)
    classify = mc_graph.classify_batch

    def audited(i_minus_p, xe, ze, dx, dz, code, *rest, **kw):
        for bit, graph, e, d in ((SYNDROME_FAIL_X, graphs.x, xe, dx),
                                 (SYNDROME_FAIL_Z, graphs.z, ze, dz)):
            ok = (code & bit) == 0
            bad = (graph.syndrome(d) != graph.syndrome(e)).any(dim=0)
            tally[0] += ok.sum()
            tally[1] += (ok & bad).sum()
        return classify(i_minus_p, xe, ze, dx, dz, code, *rest, **kw)

    mc_graph.classify_batch = audited
    try:
        yield tally
    finally:
        mc_graph.classify_batch = classify


def graphs_of(params) -> CodeGraphs:
    """A published bivariate bicycle label, or construct_code's
    parameters -> the code's graphs."""
    if isinstance(params, str):
        return known_bicycle_code(params).build_graphs()
    return CodeGraphs.build(construct_code(*params))


def mesh_runs(mesh, runs: list) -> dict:
    """Rank function of phases 20, 21 and 26 (run in each spawned rank):
    every run (label, code, weight, p, BPConfig kwargs, chunks, batch size,
    seed, relay retries[, error model]) through ``run_monte_carlo(mesh=)``,
    with every launch count set to 0 just before it and read just after,
    the collectives and host syncs it made, and the syndrome audit of its
    graph-sharded chunks (``auditing_syndromes``; [0, 0] on a data-only
    mesh).  One chunk per group, so each chunk's K8 launches and
    lane-iterations are recorded."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"rank": (mesh.rank(DATA_AXIS), mesh.rank(GRAPH_AXIS)),
           "backend": mesh.backend, "device": str(mesh.device)}
    graphs = {}
    for (label, params, weight, p_err, cfg, chunks, batch, seed, relay,
         *model) in runs:
        if params not in graphs:
            g = graphs_of(params)
            graphs[params] = (g, make_rank_basis_test(g.code, mesh.device))
        g, logical = graphs[params]
        reset_counts()
        before = dict(mesh.collectives)
        result, per_chunk = [], []
        t0 = time.perf_counter()
        with auditing_syndromes(g, mesh.device) as audit:
            syncs = count_syncs(lambda: result.append(run_monte_carlo(
                g, weight, chunks * batch, p_err, BPConfig(**cfg), seed=seed,
                batch_size=batch, mesh=mesh, relay_retries=relay,
                i_minus_p=logical, device=mesh.device,
                error_model=model[0] if model else "weight",
                progress=lambda c, nc, cnt, it: per_chunk.append(
                    (it, sharded_step_cuda.launches)))))
        torch.cuda.synchronize()
        counters, lane_iters = result[0]
        out[label] = dict(counters=counters, lane_iters=lane_iters,
                          seconds=time.perf_counter() - t0,
                          launches=read_counts(), syncs=syncs,
                          per_chunk=per_chunk, audit=audit.tolist(),
                          collectives={k: mesh.collectives[k] - before[k]
                                       for k in before})
    return out


def spawn_on_card(fn, num_data: int, num_graph: int, *args) -> list:
    """``fn(mesh, *args)`` on every rank of a (num_data x num_graph) world
    spawned on the one card; prints the world's line.  Returns the ranks'
    results."""
    torch.cuda.empty_cache()
    # counting syncs in a rank also makes gloo's staging thread log each of
    # its own: keep the ranks' C++ log to errors
    os.environ["TORCH_CPP_LOG_LEVEL"] = "ERROR"
    t0 = time.perf_counter()
    ranks = spawn(fn, num_data, num_graph, device_type="cuda", args=args,
                  timeout=900)
    say("mesh", world=f"{num_data}x{num_graph}", ranks=len(ranks),
        backend=ranks[0]["backend"], device=ranks[0]["device"],
        seconds=f"{time.perf_counter() - t0:.2f}",
        note="ranks share one card; gloo stages collectives through the host")
    return ranks


def run_world(label: str, num_data: int, num_graph: int, runs: list) -> list:
    """Spawn a (num_data x num_graph) world on the card, run ``runs`` in
    every rank, print each run's line, and check that all ranks agree on
    the counters and, graph-sharded, that every rank audited its lanes'
    syndromes and found no violation.  Returns the ranks' results."""
    ranks = spawn_on_card(mesh_runs, num_data, num_graph, runs)
    for run in runs:
        name = run[0]
        first = ranks[0][name]
        tested = int(first["counters"][C_TESTED])
        check(all(np.array_equal(r[name]["counters"], first["counters"])
                  for r in ranks), f"{label} {name}: ranks disagree")
        check(tested == run[5] * run[6], f"{label} {name}: tested {tested}")
        audits = [r[name]["audit"] for r in ranks]
        check(all((a[0] > 0) == (num_graph > 1) and a[1] == 0 for a in audits),
              f"{label} {name}: syndrome audit {audits}")
        say("main", path=f"{label} {name}", samples=tested,
            seconds=f"{max(r[name]['seconds'] for r in ranks):.4f}",
            corrected_fraction=f"{first['counters'][C_CORRECTED] / tested:.6f}",
            counters=json.dumps([int(c) for c in first["counters"]]),
            lane_iters=first["lane_iters"],
            launches=json.dumps([{k: v for k, v in r[name]["launches"].items()
                                  if v} for r in ranks]),
            collectives=json.dumps([r[name]["collectives"] for r in ranks]),
            host_syncs_per_chunk=json.dumps([r[name]["syncs"] / run[5]
                                             for r in ranks]),
            syndrome_audit=json.dumps(audits))
    return ranks


def mesh_phases() -> int:
    """Phases 20 and 21; returns K8's launches in the graph-sharded
    min-sum run (all ranks)."""
    batch = SHARDED_BATCH * SHARDED_DATA
    sharded = [(name, SHARDED_CODE, SHARDED_WEIGHT, SHARDED_P,
                dict(max_iters=SHARDED_ITERS, algorithm=algorithm),
                SHARDED_CHUNKS, batch, 1, 0)
               for name, algorithm in (("min-sum [[5210,521]]", "min-sum"),
                                       ("layered [[5210,521]]",
                                        "layered-min-sum"),
                                       ("sum-product [[5210,521]]",
                                        "sum-product"))]
    relay_cfg = dict(max_iters=MAX_ITERS, algorithm="min-sum")
    relay = [[("min-sum W=40", HEADLINE_CODE, RELAY_WEIGHT, RELAY_P, relay_cfg,
               chunks, BATCH, 4, 0),
              (f"relay W=40 retries={RELAY_RETRIES}", HEADLINE_CODE,
               RELAY_WEIGHT, RELAY_P, relay_cfg, chunks, BATCH, 4,
               RELAY_RETRIES)]
             for chunks in (SHARDED_RELAY_REFERENCE_CHUNKS,
                            SHARDED_RELAY_CHUNKS)]
    headline = ("sum-product headline", HEADLINE_CODE, WEIGHT, P_ERR,
                dict(max_iters=MAX_ITERS, check_every=10), CHUNKS, BATCH, 1, 0)

    # 20. (data=2): the data-parallel runs, the reference counters ----------
    phase("20 data=2")
    data = run_world("data=2", SHARDED_DATA, 1, [headline, *sharded, *relay[0]])
    for r in data:
        for name, kernel, per_chunk in (
                (headline[0], "bp_sum_product", 2 * CHUNKS),
                (sharded[0][0], "min_sum", 2 * SHARDED_CHUNKS),
                (sharded[1][0], "layered_min_sum", 2 * SHARDED_CHUNKS),
                (sharded[2][0], "bp_sum_product", 2 * SHARDED_CHUNKS)):
            want = {k: 0 for k in r[name]["launches"]}
            want[kernel] = per_chunk
            # the fused decide/classify kernel: once a chunk, but layered
            if kernel != "layered_min_sum":
                want["decide_classify"] = per_chunk // 2
            check(r[name]["launches"] == want,
                  f"data=2 {name}: launches {r[name]['launches']}")
            check(r[name]["collectives"] == {"all_gather": 0,
                                             "all_reduce": per_chunk // 2},
                  f"data=2 {name}: collectives {r[name]['collectives']}")
    gate_headline("data=2 sum-product headline",
                  data[0][headline[0]]["counters"], two_sided=True)
    gate_two_proportion("data=2 min-sum [[5210,521]]",
                        data[0][sharded[0][0]]["counters"],
                        SHARDED_MIN_SUM_CORRECTED)

    # 20. (data=2 x graph=2): the same runs graph-sharded ------------------
    phase("20 data=2 x graph=2")
    graph = run_world("data=2 x graph=2", SHARDED_DATA, SHARDED_GRAPH, sharded)
    for name in (sharded[0][0], sharded[1][0]):
        check(np.array_equal(graph[0][name]["counters"],
                             data[0][name]["counters"]),
              f"{name}: graph-sharded counters differ from the data-only ones")
    say("gate", path="graph-sharded min-sum and layered",
        counters_equal_data_only=True)
    sp = sharded[2][0]
    z = two_proportion_z(int(graph[0][sp]["counters"][C_CORRECTED]),
                         int(graph[0][sp]["counters"][C_TESTED]),
                         int(data[0][sp]["counters"][C_CORRECTED]),
                         int(data[0][sp]["counters"][C_TESTED]))
    say("gate", path="graph-sharded sum-product vs data-only", z=f"{z:+.2f}")
    check(abs(z) < 4, f"graph-sharded sum-product off the data-only run (z={z})")
    ms = sharded[0][0]
    k8 = {r["rank"]: r[ms]["launches"]["sharded_min_sum_step"] for r in graph}
    chunk_k8 = {r["rank"]: np.diff([0] + [k for _, k in r[ms]["per_chunk"]])
                for r in graph}
    for r in graph:
        counts = r[ms]["launches"]
        check(counts["min_sum"] == counts["min_sum_wide"] == 0
              and counts["sharded_min_sum_step"] > 0,
              f"graph-sharded min-sum launches {counts}")
        check(np.array_equal(chunk_k8[r["rank"]], chunk_k8[(r["rank"][0], 0)]),
              f"graph ranks of data shard {r['rank'][0]} out of lockstep: "
              f"{chunk_k8}")
        for name in (sharded[1][0], sp):
            check(not any(r[name]["launches"].values()),
                  f"graph-sharded {name} launched {r[name]['launches']}")
    # per chunk: a lane counts its own iterations, as the data-only run's
    # kernels do, so the exact decoders' lane-iterations equal the data-only
    # run's; and no lane runs more than its data shard's X and Z loop
    # iterations, each one K8 launch
    for name in (ms, sharded[1][0]):
        got = [it for it, _ in graph[0][name]["per_chunk"]]
        want = [it for it, _ in data[0][name]["per_chunk"]]
        check(got == want, f"graph-sharded {name}: lane-iterations per chunk "
                           f"{got}, data-only {want}")
    for c, (lane_iters, _) in enumerate(graph[0][ms]["per_chunk"]):
        launched = [int(chunk_k8[(d, 0)][c]) for d in range(SHARDED_DATA)]
        check(lane_iters <= sum(launched) * SHARDED_BATCH,
              f"chunk {c}: {lane_iters} lane-iterations exceed K8 launches "
              f"{launched} x {SHARDED_BATCH} lanes")
    say("mesh", path=f"graph-sharded {ms}", k8_launches_per_chunk=json.dumps(
        {str(k): v.tolist() for k, v in chunk_k8.items()}))
    for r in graph:
        c = r[ms]["collectives"]
        iters = k8[r["rank"]]
        say("mesh", path=f"graph-sharded {ms}", rank=json.dumps(r["rank"]),
            k8_launches=iters,
            all_gathers_per_iteration=f"{(c['all_gather'] - 2 * SHARDED_CHUNKS) / iters:.4f}",
            all_reduces_per_iteration=f"{c['all_reduce'] / iters:.4f}",
            host_syncs_per_chunk=r[ms]["syncs"] / SHARDED_CHUNKS)
        check(c["all_gather"] == iters + 2 * SHARDED_CHUNKS,
              f"graph-sharded min-sum: {c['all_gather']} all_gathers for "
              f"{iters} iterations")
        check(c["all_reduce"] <= 2 * iters, f"all_reduces {c}")

    # 21. relay, (data=1 x graph=2) --------------------------------------------
    phase("21 sharded relay")
    relayed = run_world("data=1 x graph=2", 1, SHARDED_GRAPH, relay[1])
    rates = []
    for world, runs in ((data, relay[0]), (relayed, relay[1])):
        fail0 = bp_failures(world[0][runs[0][0]]["counters"])
        fail1 = bp_failures(world[0][runs[1][0]]["counters"])
        rates.append((fail0 - fail1, fail0))
    z = two_proportion_z(*rates[1], *rates[0])
    # the smallest repair-rate gap that |z| < 4 rejects at these counts
    pool = (rates[0][0] + rates[1][0]) / (rates[0][1] + rates[1][1])
    gap = 4 * math.sqrt(pool * (1 - pool) * (1 / rates[0][1] + 1 / rates[1][1]))
    say("relay", world="data=1 x graph=2", bp_failures=rates[1][1],
        repaired=rates[1][0], repair_rate=f"{rates[1][0] / rates[1][1]:.4f}",
        data_parallel_repair_rate=f"{rates[0][0] / rates[0][1]:.4f}",
        data_parallel_bp_failures=rates[0][1], z_repair=f"{z:+.2f}",
        detectable_gap=f"{gap:.4f}",
        k8_launches=json.dumps([r[relay[1][1][0]]["launches"][
            "sharded_min_sum_step"] for r in relayed]))
    check(abs(z) < 4, f"graph-sharded relay repair rate off (z={z})")
    check(rates[1][0] > 0, "graph-sharded relay repaired no lane")
    return sum(k8.values())


# -- phase 22: the experiment CLI ---------------------------------------------

# a result record's fields, by counter index
RECORD_FIELDS = {C_TESTED: "Errors Tested", C_CORRECTED: "Corrected",
                 C_SYN_X: "Syndrome Errors X", C_SYN_Z: "Syndrome Errors Z",
                 C_LOGICAL: "Logical Errors", C_CONV_X: "Convergence Fail X",
                 C_CONV_Z: "Convergence Fail Z"}
HEADLINE_SPEC = "qc:" + ",".join(map(str, HEADLINE_CODE))
CLI_HEADLINE_WEIGHTS = (14, 16)
GROSS_CLI_SAMPLES = 262144
CLI_TRACE_SAMPLES = 4096


def cli_call(label: str, argv: list) -> dict:
    """``harness.cli.main(argv)`` on the card with every launch count set to
    0 just before it and read just after; returns the counts."""
    reset_counts()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    say("cli", case=label, seconds=f"{seconds:.3f}",
        launches=json.dumps({k: v for k, v in counts.items() if v}))
    check(rc == 0, f"CLI {label}: exit code {rc}")
    return counts


def cli_records(results: str, code, weight: int, p_err: float) -> list:
    """The records of one sweep point's result file, which must carry the
    name ``format_result_filename`` gives."""
    path = os.path.join(results, format_result_filename(str(code), weight,
                                                        MAX_ITERS, p_err))
    check(os.path.exists(path), f"CLI: no result file {path}")
    with open(path) as f:
        records = parse_reference_text(f.read())
    check(len(records) > 0, f"CLI: {path} holds no record")
    return records


def record_counters(record: dict) -> np.ndarray:
    counters = np.zeros(NUM_COUNTERS, dtype=np.int64)
    for i, name in RECORD_FIELDS.items():
        counters[i] = int(record[name])
    return counters


def say_point(label: str, weight: int, p_err: float, record: dict,
              smi: str) -> np.ndarray:
    tested = int(record["Errors Tested"])
    seconds = int(record["Duration(micro-s)"]) * 1e-6
    say("cli", case=label, W=weight, p=p_err, samples=tested,
        samples_per_s=f"{tested / seconds:.1f}",
        corrected_fraction=f"{int(record['Corrected']) / tested:.6f}",
        card=json.dumps(smi))
    return record_counters(record)


def journal_of(results: str) -> list:
    with open(os.path.join(results, "journal.jsonl")) as f:
        return f.read().splitlines()


def cli_phase(smi: str) -> dict:
    """Phase 22: the experiment CLI on the card.  Returns each case's
    launch counts."""
    phase("22 CLI")
    code610 = construct_code(*HEADLINE_CODE)
    gross_code = known_bicycle_code(GROSS)
    out = {}
    with tempfile.TemporaryDirectory(prefix="qec-cli-") as tmp:
        # (a) the headline sweep, W = 14..16, through K1; then the same call
        res = f"{tmp}/headline"
        w_lo, w_hi = CLI_HEADLINE_WEIGHTS
        argv = ["--code", HEADLINE_SPEC, "--w", str(w_lo), "--W", str(w_hi),
                "--count", str(CHUNKS * BATCH), "--max", str(MAX_ITERS),
                "--p", str(P_ERR), "--seed", "1", "--batch_size", str(BATCH),
                f"--results_dir={res}", f"--log_file={tmp}/headline.txt"]
        label = f"headline sweep W={w_lo}..{w_hi}"
        out[label] = counts = cli_call(label, argv)
        check(counts["bp_sum_product"] > 0, f"CLI {label}: K1 not launched")
        lines = journal_of(res)
        run_ids = {json.loads(line)["run_id"] for line in lines}
        say("cli", case=label, journal_lines=len(lines),
            run_ids=json.dumps(sorted(run_ids)))
        check(all(r.endswith(f"|wcap={w_hi}|torch=cuda") for r in run_ids),
              f"CLI {label}: run_ids {run_ids}")
        first = {}
        for w in range(w_lo, w_hi + 1):
            (rec,) = cli_records(res, code610, w, P_ERR)
            first[w] = rec
            counters = say_point(label, w, P_ERR, rec, smi)
            if w == WEIGHT:
                gate_headline(f"CLI W={w}", counters, two_sided=True)
        again = cli_call(label + " again", argv)
        check(journal_of(res) == lines,
              f"CLI {label}: the second call appended to the journal")
        check(not any(again.values()),
              f"CLI {label}: the second call launched {again}")
        for w in range(w_lo, w_hi + 1):
            recs = cli_records(res, code610, w, P_ERR)
            same = {k: v for k, v in recs[-1].items() if k != "Duration(micro-s)"}
            want = {k: v for k, v in first[w].items() if k != "Duration(micro-s)"}
            check(len(recs) == 2 and same == want,
                  f"CLI {label}: the resumed W={w} record differs")

        # (b) the quality mode through K2 and K7
        res = f"{tmp}/osd"
        label = f"min-sum + OSD-{OSD_LAM} W={OSD_WEIGHT}"
        out[label] = counts = cli_call(label, [
            "--code", HEADLINE_SPEC, "--algorithm", "min-sum",
            "--osd", str(OSD_LAM), "--w", str(OSD_WEIGHT), "--p", str(OSD_P),
            "--batch_size", str(OSD_BATCH),
            "--count", str(OSD_CHUNKS * OSD_BATCH), "--max", str(MAX_ITERS),
            "--seed", "8", f"--results_dir={res}", f"--log_file={tmp}/osd.txt"])
        check(counts["min_sum"] > 0 and counts["osd0"] > 0,
              f"CLI {label}: launches {counts}")
        (rec,) = cli_records(res, code610, OSD_WEIGHT, OSD_P)
        counters = say_point(label, OSD_WEIGHT, OSD_P, rec, smi)
        check(counters[C_SYN_X] == counters[C_SYN_Z] == 0,
              f"CLI {label}: OSD left syndrome failures")
        gate_counts(f"CLI {label}", "corrected", int(counters[C_CORRECTED]),
                    int(counters[C_TESTED]), OSD_CORRECTED)

        # (c) the gross code through K6
        res = f"{tmp}/gross"
        label = f"sum-product gross p={GROSS_P}"
        out[label] = counts = cli_call(label, [
            "--code", f"bb:{GROSS}", "--error_model", "depolarizing",
            "--p_values", str(GROSS_P), "--count", str(GROSS_CLI_SAMPLES),
            "--batch_size", str(BATCH), "--max", str(MAX_ITERS), "--seed", "5",
            f"--results_dir={res}", f"--log_file={tmp}/gross.txt"])
        check(counts["lifted_bp"] > 0, f"CLI {label}: K6 not launched")
        (rec,) = cli_records(res, gross_code, 1, GROSS_P)
        gate_two_proportion(f"CLI {label}",
                            say_point(label, 1, GROSS_P, rec, smi),
                            GROSS_SUM_PRODUCT_CORRECTED)

        # (d) a traced run; the profiler may miss a session's kernels (see
        # device_ms), so up to three runs, each in a fresh directory
        label = f"traced headline W={WEIGHT}"
        found = False
        for attempt in range(3):
            prof = f"{tmp}/trace{attempt}"
            out[label] = cli_call(label, [
                "--code", HEADLINE_SPEC, "--w", str(WEIGHT),
                "--count", str(CLI_TRACE_SAMPLES), "--max", str(MAX_ITERS),
                "--p", str(P_ERR), "--seed", "2", "--batch_size", str(BATCH),
                "--profile_dir", prof, f"--results_dir={tmp}/traced{attempt}",
                f"--log_file={tmp}/traced.txt"])
            traces = [f for f in os.listdir(prof)
                      if f.endswith(".pt.trace.json")] if os.path.isdir(prof) else []
            for name in traces:
                with open(os.path.join(prof, name)) as f:
                    found |= "bp_sum_product_kernel" in f.read()
            say("cli", case=label, attempt=attempt, trace_files=len(traces),
                names_k1=found)
            if found:
                break
        check(found, f"CLI {label}: no trace names bp_sum_product_kernel")
    return out


# -- phases 23-25: the quality mode on a mesh, and the bench ----------------

def quality_mesh_runs(mesh, runs: list, arrays_seed) -> dict:
    """Rank function of phases 23 and 24 (run in each spawned rank): every
    run (label, algorithm, chunks, relay retries, seed) of the osd cell
    through ``run_monte_carlo_osd(mesh=)``, after a one-chunk warm-up, with
    every launch count set to 0 just before it and read just after.  With
    ``arrays_seed`` (a graph mesh), chunk 0 of
    ``make_graph_sharded_arrays_chunk`` (min-sum) through K8 and then
    through K8's plain version, each held bit for bit on the card to the
    single-device decode of the same samples (K2): samples, decisions,
    error codes and soft outputs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    device = mesh.device
    g610 = CodeGraphs.build(construct_code(*HEADLINE_CODE))
    logical = make_rank_basis_test(g610.code, device)
    out = {"rank": (mesh.rank(DATA_AXIS), mesh.rank(GRAPH_AXIS)),
           "backend": mesh.backend, "device": str(device)}
    # one chunk first: the timed runs do not pay the rank's first calls
    run_monte_carlo_osd(g610, OSD_WEIGHT, OSD_BATCH, OSD_P,
                        BPConfig(max_iters=MAX_ITERS, algorithm=runs[0][1]),
                        seed=0, batch_size=OSD_BATCH, lam=OSD_LAM,
                        i_minus_p=logical, device=device, mesh=mesh)
    for label, algorithm, chunks, relay, seed in runs:
        reset_counts()
        t0 = time.perf_counter()
        counters, lane_iters = run_monte_carlo_osd(
            g610, OSD_WEIGHT, chunks * OSD_BATCH, OSD_P,
            BPConfig(max_iters=MAX_ITERS, algorithm=algorithm), seed=seed,
            batch_size=OSD_BATCH, lam=OSD_LAM, relay_retries=relay,
            i_minus_p=logical, device=device, mesh=mesh)
        torch.cuda.synchronize()
        out[label] = dict(counters=counters, lane_iters=lane_iters,
                          seconds=time.perf_counter() - t0,
                          launches=read_counts())
    if arrays_seed is not None:
        cfg = BPConfig(max_iters=MAX_ITERS, algorithm="min-sum")
        chunk = mc_graph.make_graph_sharded_arrays_chunk(
            mesh, g610, OSD_WEIGHT, cfg, OSD_BATCH)
        want = mc_chunk_arrays(g610, arrays_seed, 0, OSD_WEIGHT, OSD_P,
                               dataclasses.replace(cfg, return_soft=True),
                               OSD_BATCH, device=device)
        step = sharded_step_cuda.sharded_min_sum_step
        for route in ("K8", "plain"):
            if route == "plain":
                sharded_step_cuda.sharded_min_sum_step = (
                    sharded_step_cuda.sharded_min_sum_step_plain)
            try:
                reset_counts()
                got = chunk(arrays_seed, 0, OSD_P, device=device)
                torch.cuda.synchronize()
                k8 = sharded_step_cuda.launches
            finally:
                sharded_step_cuda.sharded_min_sum_step = step
            mism = flag_mismatches(got[:4], want[:4]) + flag_mismatches(
                (got[4].decisions_x, got[4].decisions_z, got[4].error_code),
                (want[4].decisions_x, want[4].decisions_z, want[4].error_code))
            nans = 0
            for g, w in ((got[4].soft_x, want[4].soft_x),
                         (got[4].soft_z, want[4].soft_z)):
                m, _, n = bit_mismatches(g, w)
                mism, nans = mism + m, nans + n
            out[f"arrays {route}"] = dict(mismatches=mism, soft_nans=nans,
                                          k8_launches=k8)
    return out


def quality_mesh_phases(device, g610: CodeGraphs, logical_610, smi: str) -> dict:
    """Phases 23 and 24; returns each graph-sharded run's launch counts
    (rank (0, 0))."""
    # 23. F3 on the card: relay + OSD-0 at (data=2) equals mesh=None --------
    phase("23 quality relay data=2")
    seed = 8
    runs = [(f"{name} W={OSD_WEIGHT}", "min-sum", OSD_CHUNKS, relay, seed)
            for name, relay in (
                (f"min-sum + OSD-{OSD_LAM}", 0),
                (f"min-sum + relay{QUALITY_MESH_RELAY} + OSD-{OSD_LAM}",
                 QUALITY_MESH_RELAY))]
    osd_cfg = BPConfig(max_iters=MAX_ITERS, algorithm="min-sum")
    single = {label: quality_run(label + " mesh=None", g610, OSD_WEIGHT,
                                 OSD_P, osd_cfg, chunks, OSD_BATCH, seed,
                                 OSD_LAM, logical_610, device,
                                 relay_retries=relay)
              for label, _, chunks, relay, _ in runs}
    ranks = spawn_on_card(quality_mesh_runs, 2, 1, runs, None)
    for label, _, chunks, relay, _ in runs:
        want, seconds, counts, _, _ = single[label]
        tested = chunks * OSD_BATCH
        for r in ranks:
            check(np.array_equal(r[label]["counters"], want),
                  f"data=2 {label}: counters {r[label]['counters']} differ "
                  f"from mesh=None's {want}")
            got = r[label]["launches"]
            check(got["osd0"] > 0 and got["min_sum"] >= 2 * chunks,
                  f"data=2 {label}: launches {got}")
        say("mesh", path=f"data=2 {label}", counters_equal_mesh_none=True,
            samples=tested, nvidia_smi=json.dumps(smi),
            samples_per_s=f"{tested / max(r[label]['seconds'] for r in ranks):.1f}",
            mesh_none_samples_per_s=f"{tested / seconds:.1f}",
            mesh_none_launches=json.dumps({k: v for k, v in counts.items() if v}),
            launches=json.dumps([{k: v for k, v in r[label]["launches"].items()
                                  if v} for r in ranks]))
    relayed = runs[1][0]
    check(single[relayed][2]["min_sum"] > 2 * OSD_CHUNKS,
          f"{relayed}: no relay retry launched")

    # 24. the graph-sharded quality mode: (data=2 x graph=2) ----------------
    phase("24 quality data=2 x graph=2")
    runs = [(f"{algorithm} + OSD-{OSD_LAM} W={OSD_WEIGHT}", algorithm,
             GRAPH_QUALITY_CHUNKS, 0, seed)
            for algorithm in ("min-sum", "layered-min-sum")]
    single = {label: quality_run(label + " mesh=None", g610, OSD_WEIGHT,
                                 OSD_P, BPConfig(max_iters=MAX_ITERS,
                                                 algorithm=algorithm),
                                 chunks, OSD_BATCH, seed, OSD_LAM,
                                 logical_610, device)
              for label, algorithm, chunks, _, _ in runs}
    ranks = spawn_on_card(quality_mesh_runs, SHARDED_DATA, SHARDED_GRAPH, runs,
                          seed)
    for r in ranks:
        for route, want_k8 in (("K8", True), ("plain", False)):
            a = r[f"arrays {route}"]
            say("check", kernel="sharded_min_sum_step", rank=json.dumps(r["rank"]),
                path=f"graph-sharded arrays chunk via {route} vs single device",
                mismatches=a["mismatches"], soft_nans=a["soft_nans"],
                k8_launches=a["k8_launches"])
            check(a["mismatches"] == 0 and (a["k8_launches"] > 0) == want_k8,
                  f"rank {r['rank']} arrays via {route}: {a}")
    out = {}
    for label, algorithm, chunks, _, _ in runs:
        want = single[label][0]
        tested = chunks * OSD_BATCH
        for r in ranks:
            got = r[label]["launches"]
            check(np.array_equal(r[label]["counters"], want),
                  f"data=2 x graph=2 {label}: counters {r[label]['counters']} "
                  f"differ from mesh=None's {want}")
            check(got["osd0"] > 0 and got["min_sum"] == 0
                  and (got["sharded_min_sum_step"] > 0) == (algorithm == "min-sum"),
                  f"data=2 x graph=2 {label}: launches {got}")
        out[label] = ranks[0][label]["launches"]
        say("mesh", path=f"data=2 x graph=2 {label}", counters_equal_mesh_none=True,
            samples=tested, chunks=f"{chunks} (cut from {OSD_CHUNKS})",
            nvidia_smi=json.dumps(smi),
            seconds=f"{max(r[label]['seconds'] for r in ranks):.2f}",
            samples_per_s=f"{tested / max(r[label]['seconds'] for r in ranks):.1f}",
            launches=json.dumps([{k: v for k, v in r[label]["launches"].items()
                                  if v} for r in ranks]))
    return out


def bench_phase(device, smi: str) -> dict:
    """Phase 25: ``bench_torch.main`` on the card at 1/8 of bench.py's
    counts, each workload's gate at that count, with every launch count set
    to 0 just before it and read just after."""
    phase("25 bench")
    reset_counts()
    t0 = time.perf_counter()
    result = bench_torch.main(device=str(device), **BENCH_COUNTS)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    say("bench", counts=json.dumps(BENCH_COUNTS), seconds=f"{seconds:.2f}",
        nvidia_smi=json.dumps(smi),
        launches=json.dumps({k: v for k, v in counts.items() if v}))
    for kernel in ("bp_sum_product", "min_sum", "layered_min_sum",
                   "lifted_min_sum"):
        check(counts[kernel] > 0, f"bench: {kernel} not launched ({counts})")
    check(result["device_kind"] == torch.cuda.get_device_name(device),
          f"bench device_kind {result['device_kind']}")
    return counts


# -- phases 26 and 27: the lane-sharded lifted engine, and the examples -------

def cli_ranks(mesh, argv: list) -> dict:
    """Rank function of phase 26's CLI run: ``harness.cli.main(argv)`` in
    every rank of the world (the CLI builds its own mesh over the ranks),
    with every launch count set to 0 just before it and read just after."""
    reset_counts()
    rc = cli.main(argv)
    return {"rc": rc, "launches": read_counts(), "backend": mesh.backend,
            "device": str(mesh.device)}


def single_device(label: str, graphs: CodeGraphs, logical, chunks: int,
                  seed: int, weight: int, p_err: float, cfg: BPConfig,
                  error_model: str, kernel: str, device):
    """The data-only mesh of one data shard on the same samples (the
    generators of (seed, chunk, data index 0), as ``make_sharded_chunk``
    draws them), decoded on this card by ``kernel``, which must launch
    ``LIFTED_LAUNCHES_PER_CHUNK[kernel]`` times a chunk.  Returns (counters,
    executed lane-iterations, X + Z loop
    iterations: each chunk's largest lane count, which is the count of a
    loop that runs until its last lane is done)."""
    reset_counts()
    counters = np.zeros(NUM_COUNTERS, dtype=np.int64)
    lane_iters = loops = 0
    for c in range(chunks):
        xe, ze, sx, sz = sample_syndromes(
            graphs, chunk_generator(seed, c, device, 0), weight, p_err, BATCH,
            error_model)
        res = decode_batch(graphs, sx, sz, p_err, cfg)
        counters += classify_batch(
            logical, xe, ze, res.decisions_x.to(torch.int32),
            res.decisions_z.to(torch.int32), res.error_code).cpu().numpy()
        lane_iters += int(res.iter_samples_x + res.iter_samples_z)
        loops += int(res.iters_x + res.iters_z)
    counts = read_counts()
    check(counts[kernel] == LIFTED_LAUNCHES_PER_CHUNK[kernel] * chunks,
          f"{label} single-device reference: launches {counts}")
    return counters, lane_iters, loops


def lifted_mesh_phase(device, smi: str) -> dict:
    """Phase 26: the lane-sharded lifted engine over gloo on the card, and
    the CLI on a lifted graph mesh.  Returns the launches of the
    single-device references."""
    phase("26 lifted graph-sharded")
    t0 = time.perf_counter()
    code, G = LIFTED_MESH_CODE, LIFTED_MESH_GRAPH
    graphs = graphs_of(code)
    logical = make_rank_basis_test(graphs.code, device)
    cfgs = {alg: dict(max_iters=LIFTED_MESH_ITERS, algorithm=alg)
            for alg in ("min-sum", "sum-product")}
    decodes = [(f"{alg} {code}", code, LIFTED_MESH_WEIGHT, LIFTED_MESH_P,
                cfg, LIFTED_MESH_CHUNKS, BATCH, 1, 0)
               for alg, cfg in cfgs.items()]
    R = LIFTED_MESH_RELAY_RETRIES
    relay = [(f"{name} {code}", code, LIFTED_MESH_WEIGHT, LIFTED_MESH_P,
              cfgs["min-sum"], LIFTED_MESH_RELAY_CHUNKS, BATCH, 2, retries)
             for name, retries in (("relay base", 0), (f"relay {R}", R),
                                   (f"relay {R} again", R))]
    ranks = run_world(f"data=1 x graph={G}", 1, G, decodes + relay)
    launches = {}
    for name, _, weight, p_err, cfg, chunks, batch, seed, _ in decodes:
        kernel = ("lifted_min_sum" if cfg["algorithm"] == "min-sum"
                  else "lifted_bp")
        want, want_iters, loop = single_device(
            name, graphs, logical, chunks, seed, weight, p_err,
            BPConfig(**cfg), "weight", kernel, device)
        launches[kernel] = LIFTED_LAUNCHES_PER_CHUNK[kernel] * chunks
        got = ranks[0][name]["counters"]
        got_iters = ranks[0][name]["lane_iters"]
        equal = bool(np.array_equal(got, want)) and got_iters == want_iters
        say("gate", path=f"lifted graph-sharded {name}",
            counters=json.dumps([int(c) for c in got]), lane_iters=got_iters,
            single_device=json.dumps([int(c) for c in want]),
            single_device_lane_iters=want_iters, single_device_kernel=kernel,
            equal=equal)
        check(equal, f"{name}: lane-sharded counters or lane-iterations "
                     f"differ from the single-device decode's ({kernel})")
        for r in ranks:
            counts = r[name]["launches"]
            check(not any(counts.values()),
                  f"lane-sharded {name} launched {counts}")
            c = r[name]["collectives"]
            say("mesh", path=f"lifted graph-sharded {name}",
                rank=json.dumps(r["rank"]), loop_iterations=loop,
                all_gathers=c["all_gather"], all_reduces=c["all_reduce"],
                all_gathers_per_iteration=f"{c['all_gather'] / loop:.4f}",
                seconds=f"{r[name]['seconds']:.3f}")
            # two per iteration, three a graph a chunk (the decisions'
            # to_var, the re-encode, the decisions' gather)
            check(c["all_gather"] == 2 * loop + 6 * chunks,
                  f"{name}: {c['all_gather']} all_gathers for {loop} "
                  f"iterations")
    base, relayed, again = (ranks[0][run[0]]["counters"] for run in relay)
    say("relay", path=f"lifted graph-sharded {code}", retries=R,
        samples=int(base[C_TESTED]), bp_failures=bp_failures(base),
        unrepaired=bp_failures(relayed),
        cut=f"{LIFTED_MESH_RELAY_CHUNKS} chunk(s) of {BATCH}, not "
            f"{LIFTED_MESH_CHUNKS}")
    check(np.array_equal(relayed, again), "lifted relay is not deterministic")
    check(relayed[C_TESTED] == base[C_TESTED], "lifted relay tested counts")
    check(bp_failures(base) > 0, "lifted relay: no failure to repair")
    check(bp_failures(relayed) <= bp_failures(base),
          "lifted relay added syndrome failures")

    # the CLI on a lifted graph mesh, against the data-only run of one shard
    gross = graphs_of(GROSS)
    with tempfile.TemporaryDirectory(prefix="qec-lifted-cli-") as tmp:
        res = f"{tmp}/gross"
        argv = ["--code", f"bb:{GROSS}", "--error_model", "depolarizing",
                "--p_values", str(GROSS_P),
                "--count", str(LIFTED_CLI_CHUNKS * BATCH),
                "--batch_size", str(BATCH), "--max", str(MAX_ITERS),
                "--seed", "9", "--num_graph", str(LIFTED_CLI_GRAPH),
                f"--results_dir={res}", f"--log_file={tmp}/gross.txt"]
        cli_out = spawn_on_card(cli_ranks, 1, LIFTED_CLI_GRAPH, argv)
        check(all(r["rc"] == 0 for r in cli_out), "lifted CLI exit codes")
        (rec,) = cli_records(res, gross.code, 1, GROSS_P)
        got = say_point(f"CLI sum-product gross num_graph={LIFTED_CLI_GRAPH}",
                        1, GROSS_P, rec, smi)
    want, _, _ = single_device("CLI gross", gross,
                               make_rank_basis_test(gross.code, device),
                               LIFTED_CLI_CHUNKS, 9, 1, GROSS_P,
                               BPConfig(max_iters=MAX_ITERS), "depolarizing",
                               "lifted_bp", device)
    # the counters a result record carries
    fields = sorted(RECORD_FIELDS)
    equal = bool(np.array_equal(got[fields], want[fields]))
    say("gate", path=f"CLI bb:{GROSS} num_graph={LIFTED_CLI_GRAPH}",
        record=json.dumps([int(c) for c in got[fields]]),
        data_only=json.dumps([int(c) for c in want[fields]]), equal=equal,
        launches=json.dumps([{k: v for k, v in r["launches"].items() if v}
                             for r in cli_out]))
    check(equal, "lifted CLI counters differ from the data-only run's")
    say("phase26", seconds=f"{time.perf_counter() - t0:.2f}",
        card=json.dumps(smi))
    return launches


def examples_phase(smi: str) -> dict:
    """Phase 27: each example's ``main`` on the card, with every launch
    count set to 0 just before it and read just after; the graph demo at
    (data=2 x graph=2), cut from its default (data=4 x graph=2) to four
    ranks on the one card, its ranks reporting their own launches."""
    phase("27 examples")
    out = {}
    for name, module, kernels in (
            ("quickstart", quickstart, ("bp_sum_product",)),
            ("bicycle_demo", bicycle_demo, ("lifted_min_sum",)),
            ("quality_pipeline", quality_pipeline,
             ("layered_min_sum", "min_sum"))):
        reset_counts()
        t0 = time.perf_counter()
        module.main(["--device", "cuda"])
        seconds = time.perf_counter() - t0
        out[name] = counts = read_counts()
        say("example", name=name, seconds=f"{seconds:.2f}",
            launches=json.dumps({k: v for k, v in counts.items() if v}),
            card=json.dumps(smi))
        for kernel in kernels:
            check(counts[kernel] > 0, f"{name}: {kernel} not launched")
    t0 = time.perf_counter()
    demo = graph_parallel_demo.main(["--device", "cuda", "--num-data", "2",
                                     "--num-graph", "2"])
    out["graph_parallel_demo"] = {m: demo[m]["launches"]
                                  for m in ("data", "graph")}
    say("example", name="graph_parallel_demo",
        seconds=f"{time.perf_counter() - t0:.2f}",
        cut="data=2 x graph=2 (4 ranks), not data=4 x graph=2",
        launches=json.dumps(out["graph_parallel_demo"]), card=json.dumps(smi))
    check(all(r["sharded_min_sum_step"] > 0 and r["min_sum"] == 0
              for r in demo["graph"]["launches"]),
          "graph demo: the graph mesh did not run K8 alone")
    check(all(r["min_sum"] > 0 for r in demo["data"]["launches"]),
          "graph demo: the data mesh did not run K2")
    return out


# -- phase 28: the benchmark suite ---------------------------------------------

def benchmarks_phase(device, smi: str) -> dict:
    """Phase 28: each script of benchmarks_torch/ through its ``main`` at
    BENCHMARK_CUTS, its records in a temporary directory, each with every
    launch count set to 0 just before it and read just after; each script's
    own gates raise.  Returns the launches per script."""
    phase("28 benchmarks")
    out = {}
    with tempfile.TemporaryDirectory(prefix="qec-benchmarks-") as tmp:
        for name, script, cut, kernels in BENCHMARK_CUTS:
            reset_counts()
            t0 = time.perf_counter()
            records = script.main(device=str(device),
                                  out=f"{tmp}/{name}.jsonl", **cut)
            seconds = time.perf_counter() - t0
            out[name] = counts = read_counts()
            say("benchmark", script=name, cut=json.dumps(cut),
                records=len(records), seconds=f"{seconds:.2f}",
                launches=json.dumps({k: v for k, v in counts.items() if v}),
                card=json.dumps(smi))
            for kernel in kernels:
                check(counts[kernel] > 0, f"{name}: {kernel} not launched")
            check(counts["lifted_bp"] == 0, f"{name} launched K6")
            if name == "large_code_scaling":
                ranks = {(r["code"].split()[0], r["num_graph"]):
                         r["launches_rank0"] for r in records
                         if "num_graph" in r}
                say("benchmark", script=name,
                    rank0_launches=json.dumps({f"{c} 1x{g}": v for (c, g), v
                                               in ranks.items()}))
                check(ranks[("qc_P521", 2)].get("sharded_min_sum_step", 0) > 0
                      and not ranks[("qc_P521", 2)].get("min_sum"),
                      "large_code_scaling: the (1,2) ranks did not run K8 "
                      "alone")
                check(not ranks[("bb_756", 3)],
                      "large_code_scaling: the lifted ranks launched a kernel")
    return out


def decide_classify_phase(device) -> dict:
    """Phase 29: the fused decide/classify kernel vs its plain composition
    (``classify_cuda.decide_classify_plain``) on one chunk of each counting
    cell's shape, decoded by its cell's kernel: counters and lane-iteration
    sums bit for bit, then kernel and plain timed in turns, beside the
    kernel's byte bound (each message, error, syndrome and iteration count
    read once).  Returns cell -> (kernel ms, plain ms, bound ms)."""
    phase("29 decide/classify")
    g610 = CodeGraphs.build(construct_code(*HEADLINE_CODE))
    gross = known_bicycle_code(GROSS).build_graphs()
    out = {}
    for label, graphs, weight, p_err, model, cfg in (
            ("hi610-sp-w15", g610, WEIGHT, P_ERR, "weight",
             BPConfig(max_iters=MAX_ITERS)),
            ("gross-ms-p01", gross, 0, GROSS_P, "depolarizing",
             BPConfig(max_iters=MAX_ITERS, algorithm="min-sum"))):
        tables = classify_cuda.prepare(
            graphs, make_rank_basis_test(graphs.code, device))
        xe, ze, sx, sz = sample_syndromes(
            graphs, chunk_generator(29, 0, device), weight, p_err, BATCH,
            model)
        prior = np.float32(cfg.prior_factor) * np.float32(p_err)
        (vx, itx), (vz, itz) = (run_decoder(g, s, prior, cfg)
                                for g, s in ((graphs.x, sx), (graphs.z, sz)))
        args = (tables, cfg, (vx, vz), (sx, sz), (xe, ze), (itx, itz))
        counters = torch.zeros(9, dtype=torch.int64, device=device)
        iters = torch.zeros(2, dtype=torch.int64, device=device)
        classify_cuda.decide_classify(*args, counters, iters)
        want, want_iters = classify_cuda.decide_classify_plain(*args)
        torch.cuda.synchronize()
        same = (counters.tolist() == want.tolist()
                and iters.tolist() == want_iters.tolist())
        say("check", kernel="decide_classify", cell=label,
            counters=json.dumps(counters.tolist()),
            plain=json.dumps(want.tolist()), iters=json.dumps(iters.tolist()),
            bit_for_bit=same)
        check(same, f"decide_classify {label}: the kernel counted "
                    f"{counters.tolist()} {iters.tolist()}, plain "
                    f"{want.tolist()} {want_iters.tolist()}")
        reads = (graphs.x.num_edges + graphs.z.num_edges + 2 * graphs.code.n
                 + graphs.x.num_checks + graphs.z.num_checks + 2)
        bound_ms = 4 * BATCH * reads / 3.35e12 * 1e3
        k_ms, p_ms = time_pair(
            "decide_classify",
            lambda: classify_cuda.decide_classify(*args, counters, iters),
            lambda: classify_cuda.decide_classify_plain(*args), 200, 20,
            device_kernel="decide_classify_kernel", cell=label,
            bound_ms=round(bound_ms, 5), bound_by="bytes")
        out[label] = (k_ms, p_ms, bound_ms)
    return out


# phase 30: the K5 pair on each lifted cell's own syndromes: (code, p,
# lanes a sector, timed calls)
K5_PAIR_CELLS = ((GROSS, GROSS_P, BATCH, 50),
                 ("[[756,16,34]]", 0.10, OSD_BATCH, 10))
K5_PAIR_SEED = 2**31 + 23


def iteration_histogram(iters: torch.Tensor) -> dict[int, int]:
    """Lanes by executed iterations: a lane stops after the test of
    iteration n (n = 0, 10, ... 90) with n + 1 iterations, or runs all
    MAX_ITERS."""
    values, counts = torch.unique(iters, return_counts=True)
    return {int(v): int(c) for v, c in zip(values.cpu(), counts.cpu())}


def graph_ms(fn, reps: int) -> float:
    """ms per replay of ``fn()`` captured once in a CUDA graph (forks onto
    other streams become parallel branches), over ``reps`` replays."""
    fn()  # warm-up: builds, caches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, reps)


def k5_pair_phase(device) -> dict:
    """Phase 30: both sectors of each lifted cell's chunk in one K5 launch
    (``lifted_min_sum_pair_run``) against one launch a sector, on the
    cell's own syndromes: the pair's messages and per-lane iterations bit
    for bit those of one launch a sector and of plain min-sum
    (:func:`min_sum_against_plain`, each sector), each sector's histogram
    of per-lane iterations, and the profiler's device time of X alone, Z
    alone and the pair, in turns, beside CUDA events for two launches one
    after the other, two launches on two streams, and the pair, eager and
    replayed from a CUDA graph.  Returns code -> (x ms, z ms, pair ms),
    device time."""
    phase("30 K5 pair")
    kernel = "lifted_min_sum_kernel"
    cfg = BPConfig(max_iters=MAX_ITERS, check_every=10, algorithm="min-sum")
    side = torch.cuda.Stream(device)
    out = {}
    for name, p_err, batch, reps in K5_PAIR_CELLS:
        graphs = known_bicycle_code(name).build_graphs()
        sx, sz = syndromes(graphs, 0, K5_PAIR_SEED, device, p_err=p_err,
                           batch=batch)
        llr_p = min_sum.prior_llr(np.float32(BPConfig().prior_factor)
                                  * np.float32(p_err))

        def one(graph, syn):
            return lifted_min_sum_cuda.lifted_min_sum_run(
                graph, syn, llr_p, cfg.max_iters, cfg.check_every,
                cfg.conv_low, cfg.min_sum_alpha)

        def pair():
            return lifted_min_sum_cuda.lifted_min_sum_pair_run(
                (graphs.x, graphs.z), (sx, sz), llr_p, cfg.max_iters,
                cfg.check_every, cfg.conv_low, cfg.min_sum_alpha)

        def two():
            return one(graphs.x, sx), one(graphs.z, sz)

        def two_streams():
            # X on the current stream, Z beside it on ``side``
            main = torch.cuda.current_stream(device)
            side.wait_stream(main)
            x = one(graphs.x, sx)
            with torch.cuda.stream(side):
                z = one(graphs.z, sz)
            main.wait_stream(side)
            return x, z

        before = lifted_min_sum_cuda.launches
        singles, paired = two(), pair()
        torch.cuda.synchronize()
        check(lifted_min_sum_cuda.launches == before + 3,
              f"K5 pair {name}: launches {lifted_min_sum_cuda.launches - before}")
        mismatches = sum(bit_mismatches(v, w)[0] + int((i != j).sum())
                         for (v, i), (w, j) in zip(paired, singles))
        check(mismatches == 0, f"K5 pair {name}: {mismatches} mismatches "
                               f"against one launch a sector")
        for side_name, graph, syn, (v, iters) in zip(
                "XZ", (graphs.x, graphs.z), (sx, sz), paired):
            mism, err, plain_iters, nans = min_sum_against_plain(
                graph, syn, llr_p, cfg, v, iters)
            say("check", kernel="lifted_min_sum pair", code=json.dumps(name),
                graph=side_name, p=p_err, batch=batch, iters=plain_iters,
                nan_entries=nans, mismatches=mism, max_abs_err=err)
            check(mism == 0, f"K5 pair {name} {side_name}: disagrees with "
                             f"plain min-sum on {mism} entries")
        for side_name, (_, iters) in zip("XZ", singles):
            hist = iteration_histogram(iters)
            past = sum(c for n, c in hist.items() if n > 11)
            say("k5pair", code=json.dumps(name), p=p_err, lanes=batch,
                sector=side_name, histogram=json.dumps(hist),
                lanes_past_11=past, share_past_11=f"{past / batch:.5f}",
                mean_iters=f"{float(iters.float().mean()):.4f}")
        x_ms = [device_ms(lambda: one(graphs.x, sx), reps, kernel)]
        z_ms = [device_ms(lambda: one(graphs.z, sz), reps, kernel)]
        pair_ms = [device_ms(pair, reps, kernel),
                   device_ms(pair, reps, kernel)]
        z_ms.append(device_ms(lambda: one(graphs.z, sz), reps, kernel))
        x_ms.append(device_ms(lambda: one(graphs.x, sx), reps, kernel))
        # in turns, each eager and replayed from a graph, as the chunk is
        timed = {"two": two, "two_streams": two_streams, "pair": pair}
        events = {k: [] for k in timed}
        graphed = {k: [] for k in timed}
        for order in (("two", "two_streams", "pair"),
                      ("pair", "two_streams", "two")):
            for k in order:
                events[k].append(round(time_ms(timed[k], reps), 4))
                graphed[k].append(round(graph_ms(timed[k], reps), 4))
        xz = float(np.mean(x_ms) + np.mean(z_ms))
        say("time", kernel="lifted_min_sum pair", code=json.dumps(name),
            p=p_err, lanes=batch, identical=mismatches == 0,
            x_device_ms=[round(t, 4) for t in x_ms],
            z_device_ms=[round(t, 4) for t in z_ms],
            pair_device_ms=[round(t, 4) for t in pair_ms],
            pair_over_x_plus_z=f"{float(np.mean(pair_ms)) / xz:.4f}",
            two_launches_event_ms=events["two"],
            two_streams_event_ms=events["two_streams"],
            pair_event_ms=events["pair"],
            two_launches_graph_ms=graphed["two"],
            two_streams_graph_ms=graphed["two_streams"],
            pair_graph_ms=graphed["pair"])
        out[name] = (float(np.mean(x_ms)), float(np.mean(z_ms)),
                     float(np.mean(pair_ms)))
    return out


def main() -> int:
    started = time.perf_counter()
    # 1. device -------------------------------------------------------------
    phase("1 device")
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
    phase("2 build")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(LIBRARIES)) as pool:
        logs = list(pool.map(lambda lib: build.build(*lib), LIBRARIES))
    for lib in KERNEL_MODULES:
        lib._library()
    say("build", seconds=f"{time.perf_counter() - t0:.2f}", arch="sm_90a",
        libraries=len(LIBRARIES))
    for (name, sources), (_, log) in zip(LIBRARIES, logs):
        say("build", library=name, source=sources[0], cached=not log)
        for kernel, regs, spill in ptxas_report(log):
            print(f"  ptxas: {kernel} {regs} registers, {spill}", flush=True)

    # 3. K1 vs plain on the card ----------------------------------------------
    phase("3 K1 vs plain")
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
    # the P=521 code that phase 20's data-only mesh decodes through K1 (V
    # and E of a lane in shared memory, one CTA per SM), and the P=1051
    # probe code (E in the lane's global slab)
    g5210 = CodeGraphs.build(construct_code(*SHARDED_CODE))
    sigma, tau = find_code_params(4, 5, 10, PROBE_P)[0]
    probe = CodeGraphs.build(construct_code(4, 5, 10, PROBE_P, sigma, tau))
    probe_weight = round(15 * probe.code.n / 610)
    s5210_bp = syndromes(g5210, SHARDED_WEIGHT, 21, device, batch=SHARDED_BATCH)
    sp_bp = syndromes(probe, probe_weight, 22, device, batch=PROBE_BP_BATCH)
    sp30 = BPConfig(max_iters=SHARDED_ITERS)
    fixed10 = BPConfig(max_iters=10, check_every=11)
    # the J=2 [[42,7]] code (column weight 2: golden_dated's max_sweep and
    # pre_detection sections) at a full batch under early exit, MAX=1000
    gj2 = CodeGraphs.build(construct_code(*J2_CODE))
    prior_golden = np.float32(BPConfig().prior_factor) * np.float32(GOLDEN_P)
    sj2 = syndromes(gj2, J2_WEIGHT, 23, device)
    j2cfg = BPConfig(max_iters=J2_MAX)
    cases += [("[[42,7]] J=2", "X", "early_exit", gj2.x, sj2[0], prior_golden,
               j2cfg),
              ("[[42,7]] J=2", "Z", "early_exit", gj2.z, sj2[1], prior_golden,
               j2cfg)]
    cases += [("[[5210,521]]", "X", "early_exit", g5210.x, s5210_bp[0], prior,
               sp30),
              ("[[5210,521]]", "Z", "early_exit", g5210.z, s5210_bp[1], prior,
               sp30),
              (f"P={PROBE_P}", "X", "fixed", probe.x, sp_bp[0], prior, fixed10),
              (f"P={PROBE_P}", "Z", "fixed", probe.z, sp_bp[1], prior, fixed10)]
    limit = placement.smem_optin(device.index)
    placements = {f"{code} {side}": placement.bp_plan(graph, limit)
                  for code, side, _, graph, *_ in cases}
    say("plan", kernel="bp_sum_product", smem_optin=limit, placements=json.dumps(
        {k: [p.threads, p.v_shared, p.e_shared, p.smem_bytes, p.slab_floats]
         for k, p in placements.items()}))
    check(placements[f"P={PROBE_P} Z"].slab_floats > 0,
          "the P=1051 check does not reach the slab")
    worst = {"bp_sum_product": run_checks("bp_sum_product", cases, compare_bp)}
    worst["bp_sum_product"] = max(worst["bp_sum_product"], long_cap_k1(
        device, g42, prior_golden))

    # 4. K1 time vs plain (fixed work, [[610,61]] X, batch 2048) --------------
    phase("4 K1 time")
    prior_t = torch.tensor(prior, device=device)
    times = {"bp_sum_product": time_pair(
        "bp_sum_product",
        lambda: bp_cuda.bp_run(g610.x, s610[0], prior, MAX_ITERS, MAX_ITERS + 1),
        lambda: sum_product.bp_run(g610.x, s610[0], prior_t, MAX_ITERS,
                                   MAX_ITERS + 1),
        20, 3, graph="[[610,61]] X", iters=MAX_ITERS)}
    # under early exit on the headline's own W=15 batches (a check every
    # 10), beside a bound from the lane-iterations the run executed
    for side, graph, syn in (("X", g610.x, s610[0]), ("Z", g610.z, s610[1])):
        _, iters = bp_cuda.bp_run(graph, syn, prior, MAX_ITERS, 10)
        lane_iters = int(iters.sum())
        bound_ms, bound_by = bound(graph, BATCH, MAX_ITERS, "sum-product",
                                   lane_iters=lane_iters)
        time_pair(
            "bp_sum_product early exit",
            lambda: bp_cuda.bp_run(graph, syn, prior, MAX_ITERS, 10),
            lambda: sum_product.bp_run(graph, syn, prior_t, MAX_ITERS, 10),
            50, 1, graph=f"[[610,61]] {side} W={WEIGHT}",
            device_kernel="bp_sum_product_kernel",
            lane_iters=lane_iters, max_lane_iters=int(iters.max()),
            mean_lane_iters=f"{lane_iters / BATCH:.3f}",
            bound_ms=f"{bound_ms:.4f}", bound_by=bound_by)

    # 5. the sum-product main path ---------------------------------------------
    phase("5 sum-product main path")
    logical_610 = make_rank_basis_test(g610.code, device)
    cfg = BPConfig(max_iters=MAX_ITERS, check_every=10)
    counters, lane_iters, seconds, counts, syncs = monte_carlo(
        "sum-product", g610, WEIGHT, P_ERR, cfg, CHUNKS, 1, logical_610, device)
    check(syncs <= 2, f"{syncs} host syncs in 2 groups (one fetch per group)")
    launches = {"bp_sum_product": check_launches("sum-product", counts,
                                                 "bp_sum_product", CHUNKS,
                                                 fused=True)}
    # the main paths' launches of the fused kernel, by counting cell
    fused_launches = {"hi610-sp-w15": counts["decide_classify"]}
    stats = CodeStatistics.from_counters(
        g610.code, 1, WEIGHT, counters, int(seconds * 1e6),
        total_bp_iterations=lane_iters)
    print(stats.to_reference_text(), end="", flush=True)
    gate_headline("sum-product", counters, two_sided=True)

    # 6. K2, K3, K4 vs plain on the card -----------------------------------------
    phase("6 K2 K3 K4 vs plain")
    llr = min_sum.prior_llr(prior)
    ms_early = BPConfig(max_iters=MAX_ITERS, algorithm="min-sum")
    ms_fixed = BPConfig(max_iters=MAX_ITERS, check_every=MAX_ITERS + 1,
                        algorithm="min-sum")
    ms42 = BPConfig(max_iters=30, check_every=31, algorithm="min-sum")
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    damping = random_damping(g610.x, gen)
    cases = []
    for mode, c in (("early_exit", ms_early), ("fixed", ms_fixed)):
        cases += [("[[610,61]]", "X", mode, g610.x, s610[0], llr, c),
                  ("[[610,61]]", "Z", mode, g610.z, s610[1], llr, c)]
    cases += [("[[42]]", "X", "fixed", g42.x, s42[0], llr, ms42),
              ("[[42]]", "Z", "fixed", g42.z, s42[1], llr, ms42),
              ("[[610,61]]", "X", "damped_early_exit", g610.x, s610[0], llr,
               ms_early, damping)]
    # a relay retry's batch at relay's prior: most lanes solved, a few W=40
    llr_relay = min_sum.prior_llr(np.float32(BPConfig().prior_factor)
                                  * np.float32(RELAY_P))
    s_relay = [relay_shaped(s) for s in syndromes(g610, RELAY_WEIGHT, 10, device)]
    for side, graph, syn in (("X", g610.x, s_relay[0]), ("Z", g610.z, s_relay[1])):
        cases += [("[[610,61]]", side, "relay_shaped", graph, syn, llr_relay,
                   ms_early),
                  ("[[610,61]]", side, "relay_shaped_damped", graph, syn,
                   llr_relay, ms_early, random_damping(graph, gen))]
    # the graph-sharded workload's code, which the data-only mesh decodes
    # through K2 (P = 521: 1024 threads, all of a lane in shared memory;
    # damped, the damping in the lane's slab)
    s5210 = syndromes(g5210, SHARDED_WEIGHT, 19, device)
    ms30 = BPConfig(max_iters=SHARDED_ITERS, algorithm="min-sum")
    cases += [("[[5210,521]]", "X", "early_exit", g5210.x, s5210[0], llr, ms30),
              ("[[5210,521]]", "Z", "damped_early_exit", g5210.z, s5210[1],
               llr, ms30, random_damping(g5210.z, gen))]
    # the osd cell's decode (phase 16's main path): a grid of 16,384 CTAs
    llr_osd = min_sum.prior_llr(np.float32(BPConfig().prior_factor)
                                * np.float32(OSD_P))
    s_osd = syndromes(g610, OSD_WEIGHT, 20, device, batch=OSD_BATCH)
    cases += [("[[610,61]]", side, "osd_cell", graph, syn, llr_osd, ms_early)
              for side, graph, syn in (("X", g610.x, s_osd[0]),
                                       ("Z", g610.z, s_osd[1]))]
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
    # the P=521 code that phase 20's data-only mesh decodes through K3 (30
    # sweeps, a test every sweep, batch 1024), and the P=1051 probe code at
    # 10 fixed sweeps (q and the state of a lane on chip: 97 / 110 KB)
    ly30 = BPConfig(max_iters=SHARDED_ITERS, algorithm="layered-min-sum")
    ly_fixed10 = BPConfig(max_iters=10, layered_check_every=11,
                          algorithm="layered-min-sum")
    sp = syndromes(probe, probe_weight, 9, device)
    cases += [("[[5210,521]]", "X", "early_exit", g5210.x, s5210_bp[0], llr,
               ly30),
              ("[[5210,521]]", "Z", "early_exit", g5210.z, s5210_bp[1], llr,
               ly30),
              (f"P={PROBE_P}", "X", "fixed", probe.x, sp[0][:, :PROBE_BP_BATCH]
               .contiguous(), llr, ly_fixed10),
              (f"P={PROBE_P}", "Z", "fixed", probe.z, sp[1][:, :PROBE_BP_BATCH]
               .contiguous(), llr, ly_fixed10)]
    placements = {f"{code} {side}": layered_cuda.plan(graph, limit)
                  for code, side, _, graph, *_ in cases}
    # every other placement: q and the state in the lane's slab (and the
    # state alone) on P=521 Z, as phase 7 times them
    for name, shape in k3_placements(g5210):
        cases.append((name, "Z", "shape", g5210.z, s5210_bp[1], llr, ly30,
                      shape))
        placements[name] = shape
    say("plan", kernel="layered_min_sum", smem_optin=limit,
        placements=json.dumps({k: [p.threads, p.q_shared,
                                   p.state_shared, p.smem_bytes, p.slab_floats]
                               for k, p in placements.items()}))
    worst["layered_min_sum"] = run_checks("layered_min_sum", cases,
                                          compare_layered)

    check(probe.x.P >= min_sum_cuda.WIDE_MIN_P, "probe code below WIDE_MIN_P")
    wide_fixed = BPConfig(max_iters=20, check_every=21, algorithm="min-sum")
    cases = []
    for mode, c in (("fixed", wide_fixed), ("early_exit", ms_early)):
        cases += [(f"P={PROBE_P}", "X", mode, probe.x, sp[0], llr, c),
                  (f"P={PROBE_P}", "Z", mode, probe.z, sp[1], llr, c)]
    # relay-shaped, and damped on the largest lane (Z: its check state and
    # damping in the lane's global slab)
    cases += [(f"P={PROBE_P}", "X", "relay_shaped", probe.x,
               relay_shaped(sp[0]), llr, ms_early),
              (f"P={PROBE_P}", "Z", "relay_shaped_damped", probe.z,
               relay_shaped(sp[1]), llr, ms_early,
               random_damping(probe.z, gen))]
    before = min_sum_cuda.wide_launches
    worst["min_sum_wide"] = run_checks("min_sum_wide", cases, compare_min_sum)
    check(min_sum_cuda.wide_launches == before + len(cases),
          "the P=1051 checks did not take the wide route")

    # 7. K2, K3, K4 time vs plain (fixed work, batch 2048) ---------------------
    phase("7 K2 K3 K4 time")
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
    time_k3(g610, g5210, s610, s5210_bp, llr, limit)
    times["min_sum_wide"] = time_pair(
        "min_sum_wide",
        lambda: min_sum_cuda.min_sum_run_wide(probe.x, sp[0], llr, 20, 21),
        lambda: min_sum.min_sum_run(probe.x, sp[0], llr, 20, 21),
        5, 2, graph=f"P={PROBE_P} X", iters=20)
    phase("7 K2 early exit and lane sort")
    worst["min_sum"] = max(worst["min_sum"], time_early_exit(device, g610, gen))

    # 8. the layered, min-sum and large-P main paths -----------------------------
    phase("8 layered, min-sum, P=1051 main paths")
    for label, c, kernel in (
            ("layered-min-sum", BPConfig(max_iters=MAX_ITERS,
                                         algorithm="layered-min-sum"),
             "layered_min_sum"),
            ("min-sum", BPConfig(max_iters=MAX_ITERS, check_every=10,
                                 algorithm="min-sum"), "min_sum")):
        counters, _, _, counts, syncs = monte_carlo(
            label, g610, WEIGHT, P_ERR, c, CHUNKS, 2, logical_610, device)
        check(syncs <= 2, f"{label}: {syncs} host syncs in 2 groups")
        launches[kernel] = check_launches(label, counts, kernel, CHUNKS,
                                          fused=kernel == "min_sum")
        gate_headline(label, counters, two_sided=False)

    probe_cfg = BPConfig(max_iters=PROBE_ITERS, check_every=10,
                         algorithm="min-sum")
    counters, _, _, counts, syncs = monte_carlo(
        f"min-sum P={PROBE_P}", probe, probe_weight, P_ERR, probe_cfg,
        PROBE_CHUNKS, 3, make_rank_basis_test(probe.code, device), device,
        steps_per_call=2)
    check(syncs <= 2, f"probe: {syncs} host syncs in 2 groups")
    calls = read_counts()
    check(calls["min_sum_wide"] > 0 and calls["min_sum"] == 0,
          f"probe: not the wide route ({calls})")
    launches["min_sum_wide"] = check_launches("probe", counts, "min_sum",
                                              PROBE_CHUNKS, fused=True)
    gate_two_proportion(f"min-sum P={PROBE_P}", counters, PROBE_CORRECTED)

    # 9. relay ------------------------------------------------------------------
    phase("9 relay")
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
    phase("10 K5 K6 vs plain")
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
    # the lifted slab placements: the probe codes' Z graphs as lifted graphs
    # (P=1051: K5's check state in the lane's slab, the damping too, and
    # K6's E; P=2081: V, 416 KB, in the slab, and K6's E too), random
    # syndromes
    for P in (PROBE_P, 2081):
        z = (probe if P == PROBE_P else CodeGraphs.build(construct_code(
            4, 5, 10, P, *find_code_params(4, 5, 10, P)[0]))).z
        big = LiftedGraph.from_circulant(z.table, P)
        syn = (torch.rand((big.num_checks, LIFTED_SLAB_BATCH), generator=gen,
                          device=device) < 0.02).to(torch.int32)
        for damped in (False, True):
            damping = (random_damping(big, gen, LIFTED_SLAB_BATCH)
                       if damped else None)
            pl = placement.plan(big, damped, limit)
            check(pl.slab_floats > 0, f"lifted P={P} does not reach the slab")
            say("plan", kernel="lifted_min_sum", graph=f"lifted P={P} Z",
                damped=damped, placement=json.dumps(
                    [pl.threads, pl.v_shared, pl.state_shared,
                     pl.damping_shared, pl.smem_bytes, pl.slab_floats]))
            lifted_cases["lifted_min_sum"].append(
                (f"lifted P={P}", "Z", "damped_early_exit" if damped
                 else "early_exit", big, syn, llr, ms_early, damping))
        # K6: E in the lane's slab at P=1051, V and E at P=2081, on the
        # syndromes of sparse errors (random ones saturate sum-product)
        pl = placement.bp_plan(big, limit)
        check(pl.slab_floats > 0 and not pl.e_shared,
              f"lifted P={P}: K6's E does not reach the slab")
        say("plan", kernel="lifted_bp", graph=f"lifted P={P} Z",
            placement=json.dumps([pl.threads, pl.v_shared, pl.e_shared,
                                  pl.smem_bytes, pl.slab_floats]))
        errors = torch.rand((big.num_vars, LIFTED_SLAB_BATCH), generator=gen,
                            device=device) < 0.004
        lifted_cases["lifted_bp"].append(
            (f"lifted P={P}", "Z", "early_exit", big,
             big.syndrome(errors.to(torch.int32)), prior, early))
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
    phase("11 K5 K6 time")
    times["lifted_min_sum"] = time_pair(
        "lifted_min_sum",
        lambda: min_sum_cuda.min_sum_run(gross.x, s_gross[0], llr, MAX_ITERS,
                                         MAX_ITERS + 1),
        lambda: min_sum.min_sum_run(gross.x, s_gross[0], llr, MAX_ITERS,
                                    MAX_ITERS + 1),
        50, 3, graph=f"{GROSS} X", iters=MAX_ITERS)
    time_k5_early_exit(gross, device, gen, llr)
    times["lifted_bp"] = time_pair(
        "lifted_bp",
        lambda: bp_cuda.bp_run(gross.x, s_gross[0], prior, MAX_ITERS,
                               MAX_ITERS + 1),
        lambda: sum_product.bp_run(gross.x, s_gross[0], prior_t, MAX_ITERS,
                                   MAX_ITERS + 1),
        50, 3, graph=f"{GROSS} X", iters=MAX_ITERS)
    time_k6_early_exit(gross, device)

    # 12. the lifted main paths: bench.py's bicycle_gross workload ---------------
    phase("12 lifted main paths")
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
        launches[kernel] = check_launches(
            label, counts, kernel, CHUNKS, fused=True,
            per_chunk=LIFTED_LAUNCHES_PER_CHUNK[kernel])
        if kernel == "lifted_min_sum":
            fused_launches["gross-ms-p01"] = counts["decide_classify"]
        gate_two_proportion(label, counters, reference)

    # 13. relay on the gross code --------------------------------------------------
    phase("13 gross relay")
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
    # both circulant routes launch min_sum_kernel
    check(counts["min_sum"] == 0, "gross relay took a circulant route")
    sx, sz = syndromes(gross, 0, 6, device, p_err=GROSS_RELAY_P)
    check_repaired_lanes(gross, sx, sz, GROSS_RELAY_P, 6, relay_cfg,
                         GROSS_RELAY_RETRIES, device)

    fused_times = decide_classify_phase(device)
    k5_pair_phase(device)

    osd_times = osd_phases(device, g610, gross, bb756, logical_610,
                           logical_gross, worst, times, launches)

    # 18.-21. K8 and the multi-device engines -----------------------------------
    phase("18 K8 vs plain")
    worst["sharded_min_sum_step"] = check_k8(device, g610, g5210, llr)
    phase("19 K8 time")
    k8_times = time_k8(device, g5210, llr)
    launches["sharded_min_sum_step"] = mesh_phases()
    cli_phase(smi)
    quality_mesh_phases(device, g610, logical_610, smi)
    bench_phase(device, smi)
    lifted_mesh_phase(device, smi)
    examples_phase(smi)
    benchmarks_phase(device, smi)
    phase(None)
    check("jax" not in sys.modules, "the port imported jax")
    left = descendants()
    say("processes", outliving_their_phases=len(left))
    check(not left, f"processes outlived their phases: {json.dumps(left)}")

    say("total", seconds=f"{time.perf_counter() - started:.2f}")
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
    rows.append({
        "name": "osd0",
        "route": "cuda",
        "source": "qec_ldpc_tpu_torch/csrc/osd0.cu",
        "replaces": "qec_ldpc_tpu/kernels/osd0_pallas.py:135",
        "launches": launches["osd0"],
        "max_abs_err": worst["osd0"],
        "ms": times["osd0"][0],
        "plain_ms": times["osd0"][1],
        "bound_ms": osd_times["Z"][2],
        "bound_by": osd_times["Z"][3],
        # no PyTorch call does GF(2) elimination
        "library_ms": None,
    })
    # at the main path's shape; phase 19 prints the other batches beside it
    k_ms, p_ms, bound_ms, bound_by = k8_times[SHARDED_BATCH]
    rows.append({
        "name": "sharded_min_sum_step",
        "route": "cuda",
        "source": "qec_ldpc_tpu_torch/csrc/sharded_min_sum_step.cu",
        "replaces": "qec_ldpc_tpu/kernels/sharded_step_pallas.py:188",
        "launches": launches["sharded_min_sum_step"],
        "max_abs_err": worst["sharded_min_sum_step"],
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        # no single PyTorch call computes a min-sum iteration
        "library_ms": None,
    })
    for cell, (k_ms, p_ms, bound_ms) in fused_times.items():
        rows.append({
            "name": f"decide_classify {cell}",
            "route": "cuda",
            "source": "qec_ldpc_tpu_torch/csrc/decide_classify.cu",
            # the JAX package leaves decisions and classification to XLA
            "replaces": None,
            "launches": fused_launches[cell],
            "max_abs_err": 0,
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes",
            "library_ms": None,
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
