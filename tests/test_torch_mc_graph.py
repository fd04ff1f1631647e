"""Graph-parallel Monte-Carlo statistics (parallel/mc_graph.py) in the port.

Gloo worlds of (data x graph) = 1x2 and 2x2 CPU ranks run every case
(``torch_mesh_workers.mc_graph_cases``).  The pins of the JAX package's
``test_mc_graph.py``:

  * the graph-sharded chunk counters and lane-iterations equal the data-only
    mesh's exactly for min-sum and layered min-sum: the same samples (the
    generators of (seed, chunk, data index)), association-free cross-shard
    reductions.  The data-only result is recomputed here in one process,
    shard by shard (``test_torch_mesh.py`` holds the data-only mesh to the
    same sum);
  * sum-product agrees within JAX's band (its cross-shard products
    reassociate);
  * relay composes: deterministic, syndrome failures drop, corrected counts
    rise, the retries' work is counted;
  * ``run_monte_carlo(mesh=)`` dispatches on the graph axis;
  * a lifted code (the toric code) runs through the lane-sharded engine,
    its chunk and ``run_monte_carlo`` counters equal to the data-only
    mesh's (``test_torch_lifted_sharded.py`` holds that engine in full).
"""

import numpy as np
import pytest
import torch

from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.codes import toric_code
from qec_ldpc_tpu_torch.decoder import BPConfig, CodeGraphs
from qec_ldpc_tpu_torch.parallel.chunk import chunk_generator
from qec_ldpc_tpu_torch.parallel.mesh import spawn
from qec_ldpc_tpu_torch.parallel.montecarlo import _chunk_body
from qec_ldpc_tpu_torch.sampling import (
    C_CORRECTED,
    C_LOGICAL,
    C_SYN_X,
    C_SYN_Z,
    C_TESTED,
    make_rank_basis_test,
)

from tests import torch_mesh_workers

PARAMS = (3, 3, 6, 7, 2, 3)
SEED, P_ERR = 3, 0.02
WORLDS = [(1, 2), (2, 2)]

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"{w[0]}x{w[1]}")
def world(request):
    nd, ng = request.param
    return nd, spawn(torch_mesh_workers.mc_graph_cases, nd, ng,
                     device_type="cpu", args=(PARAMS, SEED, P_ERR), timeout=300)


@pytest.fixture(scope="module")
def g42():
    code = construct_code(*PARAMS)
    return CodeGraphs.build(code), make_rank_basis_test(code, "cpu")


def data_only(g42, algorithm, num_data, chunks=(0, 1), weight=2):
    """The data-only mesh's (counters, iters[2]) for these chunks at 8 lanes
    per data shard, recomputed shard by shard in one process."""
    graphs, test = g42
    cfg = BPConfig(max_iters=20, algorithm=algorithm)
    counters, iters = np.zeros(9, np.int64), np.zeros(2, np.int64)
    for c in chunks:
        for d in range(num_data):
            cnt, its = _chunk_body(graphs, test,
                                   chunk_generator(SEED, c, "cpu", d), weight,
                                   P_ERR, cfg, 8, "weight")
            counters += cnt.numpy()
            iters += its.numpy()
    return counters, iters


@pytest.mark.parametrize("algorithm", ["min-sum", "layered-min-sum"])
def test_exact_decoders_bit_match_the_data_only_mesh(world, g42, algorithm):
    nd, ranks = world
    counters, iters = data_only(g42, algorithm, nd)
    for r in ranks:
        np.testing.assert_array_equal(r[algorithm][0], counters)
        np.testing.assert_array_equal(r[algorithm][1], iters)
    assert counters[C_TESTED] == 2 * nd * 8


def test_sum_product_within_jax_band(world, g42):
    nd, ranks = world
    cd, _ = data_only(g42, "sum-product", nd)
    for r in ranks:
        cg = r["sum-product"][0]
        assert cg[C_TESTED] == cd[C_TESTED]
        assert abs(int(cd[C_CORRECTED]) - int(cg[C_CORRECTED])) <= max(
            4, 0.1 * cd[C_TESTED])


def test_relay_composes(world):
    _, ranks = world
    for r in ranks:
        base, base_it = r["relay-base"]
        relayed, relay_it = r["relay"]
        np.testing.assert_array_equal(relayed, r["relay-again"][0])
        assert relayed[C_TESTED] == base[C_TESTED]
        assert relayed[C_SYN_X] <= base[C_SYN_X]
        assert relayed[C_SYN_Z] <= base[C_SYN_Z]
        assert base[C_SYN_X] + base[C_SYN_Z] > 0, "nothing to repair"
        assert relayed[C_SYN_X] + relayed[C_SYN_Z] < base[C_SYN_X] + base[C_SYN_Z]
        assert (relayed[C_CORRECTED] + relayed[C_LOGICAL]
                >= base[C_CORRECTED] + base[C_LOGICAL])
        assert relay_it.sum() > base_it.sum()


def test_run_monte_carlo_dispatches_on_the_graph_axis(world, g42):
    nd, ranks = world
    counters, iters = data_only(g42, "min-sum", nd, chunks=range(4))
    for r in ranks:
        got, got_iters = r["run"]
        np.testing.assert_array_equal(got, counters)
        assert got_iters == int(iters.sum())
        # the graph-sharded engines ran: halo gathers
        assert r["run-collectives"]["all_gather"] > 0
    assert all(r["run"][0].tolist() == ranks[0]["run"][0].tolist()
               for r in ranks)


@pytest.mark.parametrize("entry", ["chunk", "run"])
def test_lifted_codes_wait_for_their_roadmap_item(world, entry):
    """The lifted engine (ROADMAP queue 1 item 12b) is ported: the toric
    code's graph-sharded chunk and run equal the data-only mesh's."""
    nd, ranks = world
    graphs = toric_code(4).build_graphs()
    test = make_rank_basis_test(graphs.code, "cpu")
    cfg = BPConfig(max_iters=20, algorithm="min-sum")
    counters, iters = np.zeros(9, np.int64), np.zeros(2, np.int64)
    for c in (0, 1):
        for d in range(nd):
            cnt, its = _chunk_body(graphs, test,
                                   chunk_generator(SEED, c, "cpu", d), 1,
                                   P_ERR, cfg, 8, "weight")
            counters += cnt.numpy()
            iters += its.numpy()
    for r in ranks:
        got, got_iters = r[f"lifted-{entry}"]
        np.testing.assert_array_equal(got, counters)
        if entry == "chunk":
            np.testing.assert_array_equal(got_iters, iters)
        else:
            assert got_iters == int(iters.sum())
