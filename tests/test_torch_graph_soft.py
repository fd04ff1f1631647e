"""Soft outputs of the graph-sharded decode (``_decode_one_graph_sharded(...,
want_soft=True)``) against the JAX package's single-device decode on the
CPU: one gloo world of (data=1 x graph=2) CPU ranks
(``torch_mesh_workers.graph_osd_cases``) runs
``make_graph_sharded_arrays_chunk``, and JAX's ``decode_batch(...,
return_soft=True)`` decodes the syndromes the ranks return.

* min-sum and layered min-sum: decisions, error codes and soft outputs bit
  for bit (finite values; NaN masks equal), as JAX's
  ``graph_sharded.py:577-631`` claims for its own engine;
* sum-product: the cross-shard products reassociate the single-device
  ones, so the soft outputs (LLR sums of magnitude up to ~100) agree to a
  relative ``SUM_PRODUCT_RTOL`` (float32's 6e-8 grown over the iterations
  and the ``log``; an absolute 1e-3 near 0), and the error codes on almost
  every lane.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qec_ldpc_tpu.codes import construct_code
from qec_ldpc_tpu.decoder import BPConfig as JaxBPConfig
from qec_ldpc_tpu.decoder import CodeGraphs as JaxCodeGraphs
from qec_ldpc_tpu.decoder import decode_batch as jax_decode_batch
from qec_ldpc_tpu_torch.parallel.mesh import spawn

from tests import torch_mesh_workers

PARAMS = (3, 3, 6, 7, 2, 3)
SEED, P_ERR = 9, 0.02
SUM_PRODUCT_RTOL = 1e-4

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world():
    return spawn(torch_mesh_workers.graph_osd_cases, 1, 2, device_type="cpu",
                 args=(PARAMS, SEED, P_ERR, []), timeout=300)


def jax_decode(arrays: dict, algorithm: str):
    jg = JaxCodeGraphs.build(construct_code(*PARAMS))
    cfg = JaxBPConfig(max_iters=15, algorithm=algorithm, kernel="xla",
                      return_soft=True)
    return jax_decode_batch(jg, jnp.asarray(arrays["sx"], jnp.int32),
                            jnp.asarray(arrays["sz"], jnp.int32), P_ERR, cfg)


@pytest.mark.parametrize("algorithm", ["min-sum", "layered-min-sum"])
def test_exact_decoders_bit_match_jax(world, algorithm):
    want = jax_decode(world[0]["arrays"][algorithm], algorithm)
    for rank in world:
        got = rank["arrays"][algorithm]
        np.testing.assert_array_equal(got["dx"], np.asarray(want.decisions_x))
        np.testing.assert_array_equal(got["dz"], np.asarray(want.decisions_z))
        np.testing.assert_array_equal(got["code"], np.asarray(want.error_code))
        for g, w in ((got["soft_x"], want.soft_x), (got["soft_z"], want.soft_z)):
            w = np.asarray(w)
            assert g.dtype == np.float32 and g.shape == w.shape
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            finite = ~np.isnan(w)
            np.testing.assert_array_equal(g[finite].view(np.int32),
                                          w[finite].view(np.int32))


def test_sum_product_agrees_with_jax(world):
    want = jax_decode(world[0]["arrays"]["sum-product"], "sum-product")
    got = world[0]["arrays"]["sum-product"]
    for g, w in ((got["soft_x"], want.soft_x), (got["soft_z"], want.soft_z)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=SUM_PRODUCT_RTOL,
                                   atol=1e-3)
    same = (got["code"] == np.asarray(want.error_code)).mean()
    assert same >= 0.95, same
