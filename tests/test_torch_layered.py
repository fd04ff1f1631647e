"""The port's plain layered min-sum against the JAX package, bit for bit.

Same syndromes (NumPy draws) through JAX ``layered_min_sum_run`` (and the
Pallas kernel in interpret mode) and through the port's
``layered_min_sum_run``.  Tolerance: none — posteriors must be
bit-identical (NaN masks equal) and the sweep counts equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qec_ldpc_tpu.codes import construct_code
from qec_ldpc_tpu.decoder import CodeGraphs as JaxCodeGraphs
from qec_ldpc_tpu.decoder.layered import layered_min_sum_run as jax_layered_run
from qec_ldpc_tpu.decoder.layered import syndrome_satisfied as jax_satisfied
from qec_ldpc_tpu.kernels.layered_pallas import layered_run_pallas
from qec_ldpc_tpu_torch.convert import graph_from_jax, prior_llr_from_jax
from qec_ldpc_tpu_torch.decoder import layered
from qec_ldpc_tpu_torch.kernels import layered_cuda

CODES = {"42": ((3, 3, 6, 7, 2, 3), 3), "610": ((4, 5, 10, 61, 9, 49), 15)}
BATCH = 256
PRIOR = np.float32(2.0 / 3.0) * np.float32(0.01)

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


def np_errors(rng, n, weight, batch):
    """Weight-W Pauli errors from NumPy draws (x|y -> X bit, z|y -> Z bit)."""
    idx = rng.integers(0, n, (weight, batch))
    typ = rng.integers(0, 3, (weight, batch))
    cols = np.broadcast_to(np.arange(batch), idx.shape)
    xe = np.zeros((n, batch), np.int32)
    ze = np.zeros((n, batch), np.int32)
    xe[idx[typ <= 1], cols[typ <= 1]] = 1
    ze[idx[typ >= 1], cols[typ >= 1]] = 1
    return xe, ze


def assert_bits_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    np.testing.assert_array_equal(nan_g, nan_w)
    np.testing.assert_array_equal(got[~nan_g].view(np.int32),
                                  want[~nan_w].view(np.int32))


def jax_prior_llr(prior):
    p = jnp.float32(prior)
    return prior_llr_from_jax(jax.jit(lambda p: jnp.log1p(-p) - jnp.log(p))(p))


@pytest.fixture(scope="module", params=[(c, s) for c in CODES for s in "xz"],
                ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    code_name, side = request.param
    params, weight = CODES[code_name]
    code = construct_code(*params)
    jg = getattr(JaxCodeGraphs.build(code), side)
    xe, ze = np_errors(np.random.default_rng(17), code.n, weight, BATCH)
    syn = np.array(jax.jit(jg.syndrome)(jnp.asarray(xe if side == "x" else ze)))
    return jg, graph_from_jax(jg), syn


@pytest.mark.parametrize("mode", ["fixed-1", "fixed-20", "early-exit",
                                  "every-3"])
def test_layered_run_bit_exact_vs_jax(case, mode):
    """Fixed sweeps (no convergence test reached), early exit with the
    default check every sweep, and a test every third sweep (it fires at
    n % 3 == 2, unlike the flooding paths' n % k == 0)."""
    jg, tg, syn = case
    max_iters, check_every = {"fixed-1": (1, 2), "fixed-20": (20, 21),
                              "early-exit": (100, 1), "every-3": (40, 3)}[mode]
    q_j, n_j = jax_layered_run(jg, jnp.asarray(syn), jnp.float32(PRIOR),
                               max_iters=max_iters, check_every=check_every)
    q_t, n_t = layered.layered_min_sum_run(tg, torch.from_numpy(syn),
                                           jax_prior_llr(PRIOR), max_iters,
                                           check_every)
    assert q_t.shape == (tg.num_vars, BATCH) and q_t.dtype == torch.float32
    assert int(n_t) == int(n_j)
    if mode == "every-3":
        assert int(n_t) % 3 == 0 or int(n_t) == max_iters
    assert_bits_equal(q_t.numpy(), q_j)


@pytest.mark.parametrize("max_iters,check_every", [(20, 21), (50, 1)])
def test_layered_run_bit_exact_vs_pallas_interpret(max_iters, check_every):
    """The Pallas kernel (interpret mode) on the [[42]] code, 8-lane tiles."""
    code = construct_code(*CODES["42"][0])
    jg = JaxCodeGraphs.build(code).x
    xe, _ = np_errors(np.random.default_rng(18), code.n, 3, 64)
    syn = np.array(jax.jit(jg.syndrome)(jnp.asarray(xe)))
    q_k, it_k = layered_run_pallas(jg, jnp.asarray(syn), jnp.float32(PRIOR),
                                   max_iters=max_iters, check_every=check_every,
                                   tile_batch=8, interpret=True)
    q_t, n_t = layered.layered_min_sum_run(graph_from_jax(jg),
                                           torch.from_numpy(syn),
                                           jax_prior_llr(PRIOR), max_iters,
                                           check_every)
    assert int(n_t) == int(np.max(np.asarray(it_k)))
    assert_bits_equal(q_t.numpy(), q_k)


def test_syndrome_satisfied_matches_reencode_and_jax(case):
    """The sign-product parity test equals re-encoding the hard decision
    ``q <= 0`` (including -0, NaN and lanes built to satisfy their
    syndrome) and equals JAX's ``syndrome_satisfied``."""
    jg, tg, syn = case
    rng = np.random.default_rng(19)
    q = rng.standard_normal((tg.num_vars, BATCH)).astype(np.float32)
    q[rng.random(q.shape) < 0.01] = -0.0
    q[rng.random(q.shape) < 0.01] = np.nan
    # half the lanes: the syndrome of their own decision (satisfied)
    decided = np.where(q <= 0, 1, 0).astype(np.int32)
    own = np.array(jax.jit(jg.syndrome)(jnp.asarray(decided)))
    s = np.where(np.arange(BATCH) % 2 == 0, own, syn).astype(np.int32)
    syn_sign = 1.0 - 2.0 * s.astype(np.float32)
    got = layered.syndrome_satisfied(tg, torch.from_numpy(q),
                                     torch.from_numpy(syn_sign)).numpy()
    reencode = (tg.syndrome(torch.from_numpy(decided)).numpy() == s).all(axis=0)
    want = np.asarray(jax_satisfied(jg, jnp.asarray(q), jnp.asarray(syn_sign)))
    np.testing.assert_array_equal(got, reencode)
    np.testing.assert_array_equal(got, want)
    assert got[::2].all()


def test_wrapper_cpu_tensor_takes_plain_path():
    code = construct_code(*CODES["42"][0])
    jg = JaxCodeGraphs.build(code).z
    tg = graph_from_jax(jg)
    _, ze = np_errors(np.random.default_rng(20), code.n, 3, 32)
    syn = torch.from_numpy(np.array(jax.jit(jg.syndrome)(jnp.asarray(ze))))
    llr = jax_prior_llr(PRIOR)
    before = layered_cuda.launches
    q, iters = layered_cuda.layered_run(tg, syn, llr, 30)
    assert layered_cuda.launches == before
    q_p, n_p = layered.layered_min_sum_run(tg, syn, llr, 30)
    assert_bits_equal(q.numpy(), q_p.numpy())
    assert iters.shape == (32,) and iters.dtype == torch.int32
    assert bool((iters == n_p).all())
    with pytest.raises(TypeError):
        layered_cuda.layered_run(tg, syn.to(torch.int64), llr, 5)
    with pytest.raises(ValueError):
        layered_cuda.layered_run(tg, syn[:-1], llr, 5)
    with pytest.raises(ValueError):
        layered_cuda.layered_run(tg, syn, llr, 5, check_every=0)
