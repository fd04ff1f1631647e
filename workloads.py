"""The Monte-Carlo workloads of the port's chip runs, which
``chip_smoke.py`` drives and gates.  Plain constants, and helpers that
import the port only when called.  At batch 2048, 8 chunks per host fetch,
except the OSD quality mode, which reads the host once per chunk by
design."""

BATCH = 2048
STEPS_PER_CALL = 8

# the headline: the reference's [[610,61]] code, weight-15 Pauli errors,
# p = 0.01, at most 100 iterations, 64 chunks (bench.py:172-207)
HEADLINE_CODE = (4, 5, 10, 61, 9, 49)  # construct_code(J, K, L, P, sigma, tau)
WEIGHT = 15
P_ERR = 0.01
MAX_ITERS = 100
CHUNKS = 64

# the relay setting of benchmarks/data/relay_tuning_r4.jsonl line 6
RELAY_WEIGHT = 40
RELAY_P = 0.02
RELAY_RETRIES = 16
RELAY_CHUNKS = 8

# bench.py's bicycle_gross line: the gross code, depolarizing p = 0.01,
# 100 iterations (min-sum checks every 10), CHUNKS chunks
GROSS = "[[144,12,12]]"
GROSS_P = 0.01
GROSS_RELAY_P = 0.03
GROSS_RELAY_RETRIES = 8
GROSS_RELAY_CHUNKS = 4

# the OSD quality mode, min-sum + device OSD-0 (K7) at ler_sweep.py's
# settings: [[610,61]], W = 40, p = 0.02, at most 100 iterations, check every
# 10, batch 16,384 (benchmarks/results/quality_sweep_r5.jsonl line 10)
OSD_WEIGHT = 40
OSD_P = 0.02
OSD_BATCH = 16384
OSD_CHUNKS = 8
OSD_LAM = 0
# K7 alone: the failed [[610,61]] Z lanes that one decode of the osd cell's
# shape leaves (seed OSD_FAILED_SEED), repeated to OSD_TIMED_LANES inputs
OSD_FAILED_SEED = 15
OSD_TIMED_LANES = 1024

# the host-OSD quality stacks: layered min-sum + relay 12 + OSD-60 on
# [[610,61]] at W = 40 (quality_sweep_r5.jsonl line 5), and the gross code,
# min-sum + relay 8 + OSD-20, depolarizing p = 0.05
# (benchmarks/results/bicycle_gross_r2.jsonl line 10)
QUALITY_RELAY = 12
QUALITY_LAM = 60
QUALITY_CHUNKS = 16
GROSS_QUALITY_P = 0.05
GROSS_QUALITY_RELAY = 8
GROSS_QUALITY_LAM = 20
GROSS_QUALITY_CHUNKS = 8

# the graph-sharded workload: the P=521 Hagiwara-Imai code [[5210,521]]
# (construct_code(4, 5, 10, 521, 25, 1)), weight-220 Pauli errors, p = 0.01,
# at most 30 iterations, 1024 lanes per data shard, on (data=2) and
# (data=2 x graph=2) meshes (benchmarks/data/large_code_scaling_r3.jsonl
# line 2, from benchmarks/large_code_scaling.py; 16 lanes a shard there)
SHARDED_CODE = (4, 5, 10, 521, 25, 1)
SHARDED_WEIGHT = 220
SHARDED_P = 0.01
SHARDED_ITERS = 30
SHARDED_BATCH = 1024  # per data shard
SHARDED_CHUNKS = 4
SHARDED_DATA = 2
SHARDED_GRAPH = 2
# graph-sharded relay (data=1 x graph=2) at the relay setting (RELAY_*): 4
# chunks (each damped iteration waits for one halo all_gather), held to a
# data-parallel (data=2) relay run of 16 chunks
SHARDED_RELAY_CHUNKS = 4
SHARDED_RELAY_REFERENCE_CHUNKS = 16
# K8 alone: one step of shard g=0 of G=2 on the [[5210,521]] X graph, at
# sharded_step_bench.py's batch 256, at the main path's SHARDED_BATCH and at
# 2048
K8_BATCHES = (256, SHARDED_BATCH, 2048)

# the lane-sharded lifted engine: the BB cell of
# benchmarks/large_code_scaling.py:154-177, [[756,16,34]] (lift group
# Z_21 x Z_18, so G = 3 divides l), weight-24 Pauli errors, p = 0.01,
# min-sum at most 30 iterations, on a (data=1 x graph=3) mesh, 2048 lanes a
# chunk (16 there).  Relay (8 retries) runs at the same setting, cut to
# fewer chunks: gloo stages every halo through the host, and the retries
# of the lanes that never converge cost 30 iterations each
LIFTED_MESH_CODE = "[[756,16,34]]"
LIFTED_MESH_WEIGHT = 24
LIFTED_MESH_P = 0.01
LIFTED_MESH_ITERS = 30
LIFTED_MESH_GRAPH = 3
LIFTED_MESH_CHUNKS = 4
LIFTED_MESH_RELAY_RETRIES = 8
LIFTED_MESH_RELAY_CHUNKS = 1
# the CLI on a lifted graph mesh: the gross code, depolarizing p = 0.01,
# sum-product (the CLI's default), num_graph = 2, 4 chunks
LIFTED_CLI_GRAPH = 2
LIFTED_CLI_CHUNKS = 4


def osd_failed_lanes(graphs, seed: int, device, batch: int,
                     weight: int | None = None, p_err: float | None = None):
    """One min-sum decode with soft outputs (ler_sweep's BPConfig: at most
    MAX_ITERS iterations, a check every 10) of weight-``weight`` Pauli errors
    (at OSD_P) or depolarizing ones at ``p_err``; per sector (X, Z): (H,
    syndromes, soft outputs) of the lanes it leaves syndrome-failed."""
    import torch

    from qec_ldpc_tpu_torch.decoder.decode import BPConfig, decode_batch
    from qec_ldpc_tpu_torch.parallel.chunk import chunk_generator
    from qec_ldpc_tpu_torch.sampling.errors import (
        sample_depolarizing_errors,
        sample_weight_w_errors,
    )

    gen = chunk_generator(seed, 0, device)
    if weight is not None:
        xe, ze = sample_weight_w_errors(gen, graphs.code.n, weight, batch)
    else:
        xe, ze = sample_depolarizing_errors(gen, graphs.code.n, p_err, batch)
    sx = graphs.x.syndrome(xe.to(torch.int32))
    sz = graphs.z.syndrome(ze.to(torch.int32))
    res = decode_batch(graphs, sx, sz, OSD_P if p_err is None else p_err,
                       BPConfig(max_iters=MAX_ITERS, algorithm="min-sum",
                                return_soft=True))
    out = []
    for bit, h, syn, soft in ((1, graphs.code.pcm_x, sx, res.soft_x),
                              (2, graphs.code.pcm_z, sz, res.soft_z)):
        idx = torch.nonzero((res.error_code & bit) != 0).flatten()
        out.append((h, syn[:, idx], soft[:, idx]))
    return out


def osd0_args(h, syn, soft):
    """K7's arguments for these lanes: H's packed columns, the syndromes
    and the ranking of the soft outputs, then m, n and H's rank."""
    import torch

    from qec_ldpc_tpu_torch.decoder.osd_device import DeviceOSD0, ranking

    dev = DeviceOSD0(h)
    return (dev.columns(syn.device), syn.to(torch.int32).contiguous(),
            ranking(soft), dev.m, dev.n, dev.rank)


def k7_inputs(sector, lanes: int = OSD_TIMED_LANES):
    """K7's arguments for ``lanes`` inputs made of one sector's failed lanes
    (an item of :func:`osd_failed_lanes`), repeated in order."""
    import torch

    h, syn, soft = sector
    idx = torch.arange(lanes, device=syn.device) % syn.shape[1]
    return osd0_args(h, syn[:, idx], soft[:, idx])
