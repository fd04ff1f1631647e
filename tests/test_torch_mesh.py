"""The port's mesh (parallel/mesh.py) and data-parallel ``run_monte_carlo``.

One gloo world of two CPU ranks (data=2) runs every case
(``torch_mesh_workers.mesh_cases``): the mesh's shape and refusals,
``effective_steps_per_call`` on it (held to the JAX package's), and
data-parallel runs, each equal to the sum of its per-shard chunks
recomputed here in one process from the generators of (seed, chunk, data
index), with one all_reduce per group.  ``mesh=None`` keeps the counters
the port gave before the mesh existed.  Two small worlds show that a failed
or hung rank fails the run.
"""

import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from qec_ldpc_tpu.parallel import make_mesh as jax_make_mesh
from qec_ldpc_tpu.parallel.montecarlo import (
    effective_steps_per_call as jax_effective_steps_per_call,
)
from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.decoder import BPConfig, CodeGraphs
from qec_ldpc_tpu_torch.parallel import mesh as port_mesh
from qec_ldpc_tpu_torch.parallel.chunk import chunk_generator, relay_draws
from qec_ldpc_tpu_torch.parallel.montecarlo import _chunk_body, run_monte_carlo
from qec_ldpc_tpu_torch.sampling import C_TESTED, make_rank_basis_test

from tests import torch_mesh_workers

PARAMS = (3, 3, 6, 7, 2, 3)
SEED, P_ERR = 21, 0.02
SPC_CASES = [(1000, 100, 8), (4096, 1024, 8), (6 * 64, 64, 4), (100, 7, 3),
             (1000, 33, 16), (96, 3, 5)]
CONFIGS = {"sum-product": (BPConfig(max_iters=100), 0),
           "min-sum": (BPConfig(max_iters=100, algorithm="min-sum"), 0),
           "relay": (BPConfig(max_iters=100, algorithm="min-sum"), 4)}

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world():
    """The two ranks' results of ``mesh_cases``."""
    return port_mesh.spawn(torch_mesh_workers.mesh_cases, 2,
                           device_type="cpu", args=(PARAMS, SEED, P_ERR, SPC_CASES), timeout=300)


@pytest.fixture(scope="module")
def g42():
    code = construct_code(*PARAMS)
    return CodeGraphs.build(code), make_rank_basis_test(code, "cpu")


def shard_sum(g42, cfg, relay, chunks, batch, num_data=2):
    """The data-parallel result recomputed in one process: the sum over
    data shards and chunks of the chunk body with the shard's generators."""
    graphs, test = g42
    counters = np.zeros(9, np.int64)
    iters = 0
    for c in chunks:
        for d in range(num_data):
            cnt, its = _chunk_body(
                graphs, test, chunk_generator(SEED, c, "cpu", d), 3, P_ERR,
                cfg, batch, "weight", relay,
                relay_draws(SEED, c, "cpu", d) if relay else None)
            counters += cnt.numpy()
            iters += int(its.sum())
    return counters, iters


def test_mesh_shape_ranks_and_backend(world):
    assert [r["rank"] for r in world] == [(0, 0), (1, 0)]
    for r in world:
        assert r["shape"] == {"data": 2, "graph": 1}
        assert r["backend"] == "gloo" and r["device"] == "cpu"


def test_make_mesh_refuses_a_shape_the_world_lacks(world):
    for r in world:
        assert "needs 3 ranks, have 2" in r["error-too-many"]
        assert "needs 4 ranks, have 2" in r["error-graph"]


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="no process group"):
        port_mesh.make_mesh(1, 1, device_type="cpu")


def test_backend_rule():
    assert port_mesh.choose_backend("cpu", 4) == "gloo"
    want = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    assert port_mesh.choose_backend("cuda", 2) == want
    with pytest.raises(ValueError):
        port_mesh.choose_backend("tpu", 1)


def test_maybe_init_distributed_without_a_launcher(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert port_mesh.maybe_init_distributed("cpu") is False
    assert not torch.distributed.is_initialized()


def test_effective_steps_per_call_matches_jax(world):
    jmesh = jax_make_mesh(num_data=2, num_graph=1, devices=jax.devices()[:2])
    want = [jax_effective_steps_per_call(*case, mesh=jmesh)
            for case in SPC_CASES]
    for r in world:
        assert r["spc"] == want


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_data_parallel_run_equals_the_shards_summed(world, g42, name):
    cfg, relay = CONFIGS[name]
    counters, iters = shard_sum(g42, cfg, relay, range(6), 32)
    for r in world:
        np.testing.assert_array_equal(r[name]["counters"], counters)
        assert r[name]["iters"] == iters
    assert counters[C_TESTED] == 6 * 64


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_one_all_reduce_per_group(world, name):
    for r in world:
        assert r[name]["groups"] == [0, 1, 2]
        assert r[name]["collectives"] == {"all_gather": 0, "all_reduce": 3}


def test_sharded_chunk_group_is_reduced_over_data(world, g42):
    counters, iters = shard_sum(g42, BPConfig(max_iters=100), 0, (4, 5), 32)
    for r in world:
        np.testing.assert_array_equal(r["chunk"][0], counters)
        assert int(r["chunk"][1].sum()) == iters


# run_monte_carlo(g42, 3, 6 * 64, 0.02, cfg, seed=21, batch_size=64,
# steps_per_call=2, relay_retries=relay, device="cpu") on the port as it
# stood before the mesh (commit 227c991): counters, lane-iterations.  The
# relay row is that run under relay's draw rule of a generator per graph
# and retry (decoder/relay.py RelayDraws): the same errors and primary
# decode, so every counter but the relay-repaired outcomes is the earlier
# stream's (corrected 276 and logical 108 there)
BEFORE_THE_MESH = {
    "sum-product": ([384, 365, 368, 215, 63, 67, 50, 7, 7], 73216, 0),
    "min-sum": ([384, 365, 368, 209, 74, 90, 26, 27, 34], 76800, 0),
    "layered-min-sum": ([384, 365, 368, 194, 94, 106, 12, 94, 106], 76800, 0),
    "relay": ([384, 365, 368, 264, 0, 0, 120, 27, 34], 142400, 4),
}


@pytest.mark.parametrize("name", sorted(BEFORE_THE_MESH))
def test_without_a_mesh_nothing_changes(g42, name):
    want, want_iters, relay = BEFORE_THE_MESH[name]
    algorithm = "min-sum" if name == "relay" else name
    cfg = BPConfig(max_iters=100, algorithm=algorithm)
    counters, iters = run_monte_carlo(g42[0], 3, 6 * 64, P_ERR, cfg, seed=SEED,
                                      batch_size=64, steps_per_call=2,
                                      relay_retries=relay, device="cpu")
    np.testing.assert_array_equal(counters, want)
    assert iters == want_iters


def test_a_failed_rank_fails_the_world():
    with pytest.raises(RuntimeError, match="planted failure on rank 1"):
        port_mesh.spawn(torch_mesh_workers.failing_rank, 2,
                        device_type="cpu", timeout=120)


def test_a_hung_rank_fails_the_world():
    with pytest.raises(RuntimeError, match="after the timeout"):
        port_mesh.spawn(torch_mesh_workers.sleeping_rank, 1,
                        device_type="cpu", timeout=4)


def child_pids() -> set:
    """The pids of this process's children, exited but unreaped ones too
    (the fourth field of /proc/<pid>/stat, after the parenthesised name,
    is the parent's pid)."""
    pids = set()
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rpartition(")")[2].split()
        except OSError:  # exited meanwhile
            continue
        if int(fields[1]) == os.getpid():
            pids.add(int(stat.parent.name))
    return pids


@pytest.mark.parametrize("worker", ["rank_index", "failing_rank"])
def test_spawn_leaves_no_process(worker):
    """Every process a world starts, its ranks and multiprocessing's
    resource tracker, has exited and been reaped when ``spawn`` returns or
    raises."""
    before = child_pids()
    try:
        ranks = port_mesh.spawn(getattr(torch_mesh_workers, worker), 2,
                                device_type="cpu", timeout=120)
        assert ranks == [0, 1]
    except RuntimeError:
        assert worker == "failing_rank"
    assert child_pids() <= before
