"""The port's plain min-sum against the JAX package, bit for bit.

Same syndromes (NumPy draws) through JAX ``min_sum_run`` (and the Pallas
kernels in interpret mode) and through the port's ``min_sum_run``.
Tolerance: none — finite messages must be bit-identical, NaN masks equal and
the iteration counts equal.  That holds for the damped path too: XLA on the
CPU contracts the blend ``d*v + (1-d)*v_new`` into ``fma(1-d, v_new, d*v)``,
which the port forms with ``fma_f32``.  The prior LLR is carried across from
JAX (``convert.prior_llr_from_jax``); at the repository's priors it equals
the port's own ``prior_llr``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qec_ldpc_tpu.codes import construct_code
from qec_ldpc_tpu.decoder import CodeGraphs as JaxCodeGraphs
from qec_ldpc_tpu.decoder.layout import CirculantGraph as JaxCirculantGraph
from qec_ldpc_tpu.decoder.min_sum import _not_converged_mask_llr as jax_mask
from qec_ldpc_tpu.decoder.min_sum import min_sum_run as jax_min_sum_run
from qec_ldpc_tpu.decoder.min_sum import np_log_band as jax_log_band
from qec_ldpc_tpu.kernels.min_sum_pallas import WIDE_MIN_P, min_sum_run_pallas
from qec_ldpc_tpu.kernels.min_sum_wide_pallas import min_sum_run_wide_pallas
from qec_ldpc_tpu_torch.convert import (
    float32_from_numpy,
    graph_from_jax,
    prior_llr_from_jax,
)
from qec_ldpc_tpu_torch.decoder import min_sum
from qec_ldpc_tpu_torch.kernels import min_sum_cuda

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
    xe, ze = np_errors(np.random.default_rng(13), code.n, weight, BATCH)
    syn = np.array(jax.jit(jg.syndrome)(jnp.asarray(xe if side == "x" else ze)))
    return jg, graph_from_jax(jg), syn


@pytest.mark.parametrize("error_probability", [0.005, 0.01, 0.02, 0.05])
def test_prior_llr_matches_jax(error_probability):
    """At the priors the repository runs, the port's host LLR equals XLA's
    float32 ``log1p(-p) - log(p)`` bit for bit."""
    prior = np.float32(2.0 / 3.0) * np.float32(error_probability)
    got = min_sum.prior_llr(prior)
    assert got == jax_prior_llr(prior)
    assert got == float(np.float32(got))


def test_band_and_mask_match_jax():
    """The band is JAX's ln(99), compared in float32: values one ulp either
    side of it, +-0, inf and NaN give JAX's per-lane mask."""
    band = min_sum.np_log_band(0.01)
    assert band == jax_log_band(0.01)
    b32 = np.float32(band)
    edge = np.array([np.nextafter(b32, np.float32(0)), b32,
                     np.nextafter(b32, np.float32(np.inf))], np.float32)
    vals = np.concatenate([edge, -edge, np.float32([0.0, -0.0, np.inf,
                                                    -np.inf, np.nan, 1.0])])
    v = np.full((4, vals.size), 10.0, np.float32)
    v[2] = vals
    got = min_sum._not_converged_mask_llr(torch.from_numpy(v), band)
    want = jax_mask(jnp.asarray(v), band)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["fixed-1", "fixed-7", "fixed-20", "early-exit"])
def test_min_sum_run_bit_exact_vs_jax(case, mode):
    jg, tg, syn = case
    if mode == "early-exit":
        max_iters, check_every = 100, 10
    else:
        max_iters = int(mode.split("-")[1])
        check_every = max_iters + 1
    v_j, n_j = jax_min_sum_run(jg, jnp.asarray(syn), jnp.float32(PRIOR),
                               max_iters=max_iters, check_every=check_every)
    v_t, n_t = min_sum.min_sum_run(tg, torch.from_numpy(syn),
                                   jax_prior_llr(PRIOR), max_iters, check_every)
    assert v_t.dtype == torch.float32 and n_t.dtype == torch.int32
    assert int(n_t) == int(n_j)
    assert_bits_equal(v_t.numpy(), v_j)


def test_min_sum_run_damped_bit_exact_vs_jax(case):
    """Random per-variable damping (the relay engine), 25 fixed iterations
    and an early-exit run: bit-exact, the FMA form above included."""
    jg, tg, syn = case
    gamma = np.random.default_rng(3).uniform(
        0.05, 1.0, (jg.num_vars, BATCH)).astype(np.float32)
    damping = np.array(jg.expand_vars(jnp.asarray(gamma)))
    llr = jax_prior_llr(PRIOR)
    for max_iters, check_every in ((25, 26), (60, 10)):
        v_j, n_j = jax_min_sum_run(jg, jnp.asarray(syn), jnp.float32(PRIOR),
                                   max_iters=max_iters, check_every=check_every,
                                   damping=jnp.asarray(damping))
        v_t, n_t = min_sum.min_sum_run(
            tg, torch.from_numpy(syn), llr, max_iters, check_every,
            damping=float32_from_numpy(damping, "cpu"))
        assert int(n_t) == int(n_j)
        assert_bits_equal(v_t.numpy(), v_j)


def test_damped_blend_is_one_rounding():
    """``damped_blend`` equals the exactly rounded fma(1-d, new, d*old)."""
    rng = np.random.default_rng(8)
    d = rng.uniform(0.05, 1.0, 4000).astype(np.float32)
    old = (rng.standard_normal(4000) * 20).astype(np.float32)
    new = (rng.standard_normal(4000) * 20).astype(np.float32)
    got = min_sum.damped_blend(torch.from_numpy(d), torch.from_numpy(old),
                               torch.from_numpy(new)).numpy()
    one_minus_d = (np.float32(1) - d).astype(np.float64)
    # (1-d)*new is exact in float64 and d*old is rounded to float32 first;
    # their float64 sum rounds once more, which can move the float32 result
    # only at a near-tie (about one input in 2^29)
    exact = one_minus_d * new.astype(np.float64) + (d * old).astype(np.float64)
    np.testing.assert_array_equal(got, exact.astype(np.float32))


@pytest.mark.parametrize("max_iters,check_every", [(20, 21), (50, 10)])
def test_min_sum_run_bit_exact_vs_pallas_interpret(max_iters, check_every):
    """The Pallas kernel (interpret mode) on the [[42]] code, 8-lane tiles."""
    code = construct_code(*CODES["42"][0])
    jg = JaxCodeGraphs.build(code).z
    _, ze = np_errors(np.random.default_rng(14), code.n, 3, 64)
    syn = np.array(jax.jit(jg.syndrome)(jnp.asarray(ze)))
    v_k, it_k = min_sum_run_pallas(jg, jnp.asarray(syn), jnp.float32(PRIOR),
                                   max_iters=max_iters, check_every=check_every,
                                   tile_batch=8, interpret=True)
    v_t, n_t = min_sum.min_sum_run(graph_from_jax(jg), torch.from_numpy(syn),
                                   jax_prior_llr(PRIOR), max_iters, check_every)
    assert int(n_t) == int(np.max(np.asarray(it_k)))
    assert_bits_equal(v_t.numpy(), v_k)


def large_p_graph():
    """The synthetic P >= WIDE_MIN_P graph of the JAX package's own wide
    kernel test: a 2 x 3 random exponent table at P = WIDE_MIN_P + 32."""
    P = WIDE_MIN_P + 32
    rng = np.random.default_rng(0)
    jg = JaxCirculantGraph.from_table(rng.integers(0, P, size=(2, 3)), P)
    syn = rng.integers(0, 2, size=(jg.num_checks, 8)).astype(np.int32)
    return jg, syn


def test_large_p_matches_jax_xla_and_wide_kernel():
    """P >= 768 (the wide route, K4's domain): the plain port and the
    wrapper's CPU path equal JAX's XLA loop and the wide Pallas kernel in
    interpret mode, bit for bit."""
    jg, syn = large_p_graph()
    tg = graph_from_jax(jg)
    assert tg.P >= min_sum_cuda.WIDE_MIN_P == WIDE_MIN_P
    v_x, n_x = jax_min_sum_run(jg, jnp.asarray(syn), jnp.float32(PRIOR),
                               max_iters=6, check_every=8)
    v_w, it_w = min_sum_run_wide_pallas(jg, jnp.asarray(syn), jnp.float32(PRIOR),
                                        max_iters=6, check_every=8,
                                        tile_batch=8, interpret=True)
    before = (min_sum_cuda.launches, min_sum_cuda.wide_launches)
    v_t, it_t = min_sum_cuda.min_sum_run(tg, torch.from_numpy(syn),
                                         jax_prior_llr(PRIOR), 6, 8)
    assert (min_sum_cuda.launches, min_sum_cuda.wide_launches) == before
    assert int(it_t.max()) == int(n_x) == int(np.max(np.asarray(it_w)))
    assert_bits_equal(v_t.numpy(), v_x)
    assert_bits_equal(v_t.numpy(), v_w)


def test_large_p_early_exit_matches_jax_xla():
    jg, syn = large_p_graph()
    syn[:, :4] = 0  # quiet lanes converge at the first check
    v_x, n_x = jax_min_sum_run(jg, jnp.asarray(syn), jnp.float32(PRIOR),
                               max_iters=30, check_every=5)
    v_t, n_t = min_sum.min_sum_run(graph_from_jax(jg), torch.from_numpy(syn),
                                   jax_prior_llr(PRIOR), 30, 5)
    assert int(n_t) == int(n_x)
    assert_bits_equal(v_t.numpy(), v_x)


def test_alpha_is_applied_in_float32():
    """A non-representable alpha is rounded to float32 first, as JAX's weak
    typing does."""
    jg = JaxCodeGraphs.build(construct_code(*CODES["42"][0])).x
    tg = graph_from_jax(jg)
    xe, _ = np_errors(np.random.default_rng(5), 42, 3, 32)
    syn = np.array(jax.jit(jg.syndrome)(jnp.asarray(xe)))
    v_j, _ = jax_min_sum_run(jg, jnp.asarray(syn), jnp.float32(PRIOR),
                             max_iters=12, check_every=13, alpha=0.7)
    v_t, _ = min_sum.min_sum_run(tg, torch.from_numpy(syn),
                                 jax_prior_llr(PRIOR), 12, 13, alpha=0.7)
    assert_bits_equal(v_t.numpy(), v_j)
    assert math.isfinite(float(v_t.abs().max()))
