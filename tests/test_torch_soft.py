"""Soft outputs of decode_batch (the reliabilities OSD ranks by) against the
JAX package on the CPU, for shared syndromes: min-sum and layered min-sum
bit for bit, sum-product at rtol = atol = 1e-5 (it goes through ``log``,
and XLA's float32 ``log`` and PyTorch's differ by an ulp or two on some
inputs); relay passes the primary decode's soft output through."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qec_ldpc_tpu.codes import construct_code
from qec_ldpc_tpu.codes import known_bicycle_code as jax_known_bicycle_code
from qec_ldpc_tpu.decoder import BPConfig as JaxBPConfig
from qec_ldpc_tpu.decoder import CodeGraphs as JaxCodeGraphs
from qec_ldpc_tpu.decoder import decode_batch as jax_decode_batch
from qec_ldpc_tpu_torch.convert import bpconfig_from_jax, graphs_from_jax
from qec_ldpc_tpu_torch.decoder import BPConfig, decode_batch, relay_decode_batch
from qec_ldpc_tpu_torch.decoder.relay import RelayDraws

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

CASES = [("42", "min-sum"), ("42", "layered-min-sum"), ("42", "sum-product"),
         ("gross", "min-sum"), ("gross", "sum-product")]


@pytest.fixture(scope="module")
def graphs():
    out = {}
    for name, jg in (("42", JaxCodeGraphs.build(construct_code(3, 3, 6, 7, 2, 3))),
                     ("gross", jax_known_bicycle_code("[[144,12,12]]").build_graphs())):
        out[name] = (jg, graphs_from_jax(jg))
    return out


def shared_syndromes(jg, batch: int, p: float, seed: int):
    rng = np.random.default_rng(seed)
    n = jg.code.n
    xe = (rng.random((n, batch)) < p).astype(np.int32)
    ze = (rng.random((n, batch)) < p).astype(np.int32)
    return (np.array(jg.x.syndrome(jnp.asarray(xe))),
            np.array(jg.z.syndrome(jnp.asarray(ze))))


@pytest.mark.parametrize("max_iters", [7, 30])
@pytest.mark.parametrize("code,algorithm", CASES)
def test_soft_matches_jax(graphs, code, algorithm, max_iters):
    jg, tg = graphs[code]
    sx, sz = shared_syndromes(jg, 96, 0.06, seed=max_iters + len(algorithm))
    cfg = JaxBPConfig(max_iters=max_iters, algorithm=algorithm, kernel="xla",
                      return_soft=True)
    want = jax_decode_batch(jg, jnp.asarray(sx), jnp.asarray(sz), 0.02, cfg)
    got = decode_batch(tg, torch.from_numpy(sx), torch.from_numpy(sz), 0.02,
                       bpconfig_from_jax(cfg))
    for g, w in ((got.soft_x, want.soft_x), (got.soft_z, want.soft_z)):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape == (jg.code.n, 96)
        g = g.numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        if algorithm == "sum-product":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        else:
            finite = ~np.isnan(w)
            np.testing.assert_array_equal(g[finite].view(np.int32),
                                          w[finite].view(np.int32))
    # the decisions and codes are unchanged by asking for soft outputs
    np.testing.assert_array_equal(got.decisions_x.numpy(),
                                  np.asarray(want.decisions_x))
    np.testing.assert_array_equal(got.error_code.numpy(),
                                  np.asarray(want.error_code))


def test_sum_product_nan_edges_count_zero(graphs):
    """Saturated sum-product lanes hold NaN messages; their soft outputs
    stay finite (a NaN edge adds 0), as in JAX."""
    jg, tg = graphs["42"]
    sx, sz = shared_syndromes(jg, 128, 0.2, seed=5)
    cfg = BPConfig(max_iters=100, check_every=101, return_soft=True)
    got = decode_batch(tg, torch.from_numpy(sx), torch.from_numpy(sz), 0.02, cfg)
    want = jax_decode_batch(jg, jnp.asarray(sx), jnp.asarray(sz), 0.02,
                            JaxBPConfig(max_iters=100, check_every=101,
                                        kernel="xla", return_soft=True))
    np.testing.assert_allclose(got.soft_x.numpy(), np.asarray(want.soft_x),
                               rtol=1e-5, atol=1e-5)
    assert torch.isfinite(got.soft_x).all()


@pytest.mark.parametrize("algorithm", ["sum-product", "min-sum",
                                       "layered-min-sum"])
def test_soft_absent_unless_asked(graphs, algorithm):
    jg, tg = graphs["42"]
    sx, sz = shared_syndromes(jg, 8, 0.05, seed=1)
    res = decode_batch(tg, torch.from_numpy(sx), torch.from_numpy(sz), 0.02,
                       BPConfig(max_iters=10, algorithm=algorithm))
    assert res.soft_x is None and res.soft_z is None


def test_layered_soft_is_the_posterior(graphs):
    jg, tg = graphs["42"]
    sx, sz = shared_syndromes(jg, 32, 0.06, seed=2)
    res = decode_batch(tg, torch.from_numpy(sx), torch.from_numpy(sz), 0.02,
                       BPConfig(max_iters=20, algorithm="layered-min-sum",
                                return_soft=True))
    assert torch.equal(res.decisions_x, (res.soft_x <= 0).to(torch.int8))
    assert torch.equal(res.decisions_z, (res.soft_z <= 0).to(torch.int8))


@pytest.mark.parametrize("code", ["42", "gross"])
def test_relay_passes_soft_through(graphs, code):
    """The relay result keeps the primary decode's soft outputs, as JAX's
    dataclasses.replace does, while relay replaces the decisions of the
    lanes it repairs."""
    jg, tg = graphs[code]
    sx, sz = shared_syndromes(jg, 64, 0.08, seed=3)
    cfg = BPConfig(max_iters=20, algorithm="min-sum", return_soft=True)
    sx, sz = torch.from_numpy(sx), torch.from_numpy(sz)
    primary = decode_batch(tg, sx, sz, 0.02, cfg)
    res, _, _ = relay_decode_batch(tg, sx, sz, 0.02, RelayDraws([4], "cpu"),
                                   cfg, retries=3)
    assert torch.equal(res.soft_x, primary.soft_x)
    assert torch.equal(res.soft_z, primary.soft_z)
