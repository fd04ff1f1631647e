"""One Monte-Carlo chunk as a public entry point (parallel/montecarlo.py
``mc_chunk`` and ``mc_chunk_arrays``) in the port, on the CPU:

* ``mc_chunk``'s counters are ``classify_batch`` of ``mc_chunk_arrays``'s
  outputs and the counters ``run_monte_carlo`` reports for that chunk, for
  each decoder and with relay;
* ``mc_chunk_arrays``'s decode half is JAX's ``decode_batch`` on the
  port's samples: the syndromes, decisions, error codes and soft outputs
  (min-sum and layered min-sum bit for bit, sum-product at the 1e-5 of
  ``test_torch_soft.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qec_ldpc_tpu.codes import construct_code as jax_construct_code
from qec_ldpc_tpu.decoder import BPConfig as JaxBPConfig
from qec_ldpc_tpu.decoder import CodeGraphs as JaxCodeGraphs
from qec_ldpc_tpu.decoder import decode_batch as jax_decode_batch
from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.decoder import BPConfig, CodeGraphs
from qec_ldpc_tpu_torch.parallel import mc_chunk, mc_chunk_arrays, run_monte_carlo
from qec_ldpc_tpu_torch.sampling import classify_batch, make_rank_basis_test

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

PARAMS = (3, 3, 6, 7, 2, 3)
SEED, P_ERR, BATCH = 13, 0.02, 64
CASES = [("sum-product", 0), ("min-sum", 0), ("layered-min-sum", 0),
         ("min-sum", 4)]


@pytest.fixture(scope="module")
def g42():
    code = construct_code(*PARAMS)
    return CodeGraphs.build(code), make_rank_basis_test(code, "cpu")


@pytest.mark.parametrize("algorithm,relay", CASES)
def test_counters_agree_three_ways(g42, algorithm, relay):
    graphs, test = g42
    cfg = BPConfig(max_iters=20, algorithm=algorithm)
    per_chunk = []
    run_monte_carlo(graphs, 4, 3 * BATCH, P_ERR, cfg, SEED, batch_size=BATCH,
                    relay_retries=relay, i_minus_p=test, device="cpu",
                    progress=lambda g, ng, c, it: per_chunk.append((c, it)))
    for chunk in range(3):
        counters, iters = mc_chunk(graphs, test, SEED, chunk, 4, P_ERR, cfg,
                                   BATCH, relay_retries=relay, device="cpu")
        xe, ze, _, _, res = mc_chunk_arrays(graphs, SEED, chunk, 4, P_ERR,
                                            cfg, BATCH, relay_retries=relay,
                                            device="cpu")
        from_arrays = classify_batch(
            test, xe.to(torch.int32), ze.to(torch.int32),
            res.decisions_x.to(torch.int32), res.decisions_z.to(torch.int32),
            res.error_code)
        np.testing.assert_array_equal(counters.numpy(), from_arrays.numpy())
        np.testing.assert_array_equal(counters.numpy(), per_chunk[chunk][0])
        assert int(iters.sum()) == per_chunk[chunk][1] == int(
            res.iter_samples_x + res.iter_samples_z)
        assert counters[0] == BATCH


@pytest.mark.parametrize("algorithm", ["sum-product", "min-sum",
                                       "layered-min-sum"])
def test_decode_half_matches_jax(g42, algorithm):
    graphs, _ = g42
    jg = JaxCodeGraphs.build(jax_construct_code(*PARAMS))
    cfg = BPConfig(max_iters=20, algorithm=algorithm, return_soft=True)
    xe, ze, sx, sz, res = mc_chunk_arrays(graphs, SEED, 5, 6, P_ERR, cfg,
                                          BATCH, device="cpu")
    assert xe.dtype == sx.dtype == torch.int8
    jsx = jg.x.syndrome(jnp.asarray(xe.numpy(), jnp.int32))
    jsz = jg.z.syndrome(jnp.asarray(ze.numpy(), jnp.int32))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    np.testing.assert_array_equal(sz.numpy(), np.asarray(jsz))
    want = jax_decode_batch(jg, jsx, jsz, P_ERR,
                            JaxBPConfig(max_iters=20, algorithm=algorithm,
                                        kernel="xla", return_soft=True))
    for f in ("decisions_x", "decisions_z", "error_code"):
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    for g, w in ((res.soft_x.numpy(), np.asarray(want.soft_x)),
                 (res.soft_z.numpy(), np.asarray(want.soft_z))):
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        if algorithm == "sum-product":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        else:
            finite = ~np.isnan(w)
            np.testing.assert_array_equal(g[finite].view(np.int32),
                                          w[finite].view(np.int32))
