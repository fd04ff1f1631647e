"""The quality mode on a (data=2 x graph=2) mesh in the port: one gloo world
of four CPU ranks (``torch_mesh_workers.graph_osd_cases``) runs every case.
The pins of the JAX package's ``test_osd.py:288-318``:

* min-sum and layered min-sum with OSD-0 and OSD-1 give the ``mesh=None``
  run's counters exactly: every data rank draws the chunk's full batch and
  decodes its columns graph-sharded, and each data shard's failed lanes
  count once;
* relay + OSD-0 on the mesh is deterministic, tests every lane and leaves
  no syndrome failure (its retries draw per graph shard, as JAX's do).

And ``make_graph_sharded_arrays_chunk`` returns, on every rank, the arrays
of ``mc_chunk_arrays(mesh=None)``: the samples, and the decisions and soft
outputs of min-sum and layered min-sum bit for bit.
"""

import numpy as np
import pytest
import torch

from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.decoder import BPConfig, CodeGraphs
from qec_ldpc_tpu_torch.parallel.mesh import spawn
from qec_ldpc_tpu_torch.parallel.montecarlo import mc_chunk_arrays, run_monte_carlo_osd
from qec_ldpc_tpu_torch.sampling import C_SYN_X, C_SYN_Z, C_TESTED

from tests import torch_mesh_workers

PARAMS = (3, 3, 6, 7, 2, 3)
SEED, P_ERR = 9, 0.02
# (algorithm, weight, count, batch, lam, relay retries)
RUNS = [(alg, 5, 256, 64, lam, 0) for alg in ("min-sum", "layered-min-sum")
        for lam in (0, 1)] + [("min-sum", 5, 256, 64, 0, 4)]

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world():
    return spawn(torch_mesh_workers.graph_osd_cases, 2, 2, device_type="cpu",
                 args=(PARAMS, SEED, P_ERR, RUNS), timeout=300)


@pytest.fixture(scope="module")
def g42():
    return CodeGraphs.build(construct_code(*PARAMS))


def test_ranks(world):
    assert [r["rank"] for r in world] == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("i", [i for i, run in enumerate(RUNS) if not run[5]])
def test_exact_decoders_equal_mesh_none(world, g42, i):
    alg, w, count, batch, lam, _ = RUNS[i]
    want, _ = run_monte_carlo_osd(g42, w, count, P_ERR,
                                  BPConfig(max_iters=15, algorithm=alg),
                                  seed=SEED, batch_size=batch, lam=lam,
                                  device="cpu")
    assert want[C_TESTED] == count and want[C_SYN_X] == want[C_SYN_Z] == 0
    for rank in world:
        (got,) = rank[i]
        np.testing.assert_array_equal(got, want)


def test_relay_and_osd_are_deterministic(world):
    i = next(i for i, run in enumerate(RUNS) if run[5])
    first, again = world[0][i]
    np.testing.assert_array_equal(first, again)
    assert first[C_TESTED] == RUNS[i][2]
    assert first[C_SYN_X] == first[C_SYN_Z] == 0
    for rank in world:
        for got in rank[i]:
            np.testing.assert_array_equal(got, first)


@pytest.mark.parametrize("algorithm", ["min-sum", "layered-min-sum"])
def test_arrays_chunk_equals_the_single_device_chunk(world, g42, algorithm):
    want = torch_mesh_workers.arrays_of(mc_chunk_arrays(
        g42, SEED, 1, 5, P_ERR, BPConfig(max_iters=15, algorithm=algorithm,
                                          return_soft=True),
        64, device="cpu"))
    for rank in world:
        got = rank["arrays"][algorithm]
        for k in ("xe", "ze", "sx", "sz", "dx", "dz", "code"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("soft_x", "soft_z"):
            g, w = got[k], want[k]
            assert g.shape == w.shape == (g42.code.n, 64)
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            finite = ~np.isnan(w)
            np.testing.assert_array_equal(g[finite].view(np.int32),
                                          w[finite].view(np.int32))


def test_sum_product_arrays_chunk_draws_the_same_samples(world, g42):
    want = torch_mesh_workers.arrays_of(mc_chunk_arrays(
        g42, SEED, 1, 5, P_ERR, BPConfig(max_iters=15, return_soft=True), 64,
        device="cpu"))
    for rank in world:
        got = rank["arrays"]["sum-product"]
        for k in ("xe", "ze", "sx", "sz"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.isfinite(got["soft_x"]).all()
