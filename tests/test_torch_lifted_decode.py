"""Lifted-graph decoding in the port against the JAX package.

Same syndromes (NumPy draws) through JAX's XLA loops, JAX's lifted Pallas
kernels in interpret mode (``lifted_min_sum_run_pallas``,
``lifted_bp_run_pallas``) and the port's plain ``min_sum_run`` and
``bp_run`` on its ``LiftedGraph``, for the gross code [[144,12,12]] and the
d=4 toric code, X and Z graphs, batch 32, 20 iterations.  Tolerance: none —
finite messages bit for bit, NaN masks and iteration counts equal — with one
exception: JAX's damped Pallas kernel rounds the blend as
``fma(d, v_old, (1-d) * v_new)`` where its own XLA loop (and the port, and
the port's CUDA kernel) forms ``fma(1-d, v_new, d * v_old)``, so the damped
Pallas comparison takes the tolerance the JAX package holds its own kernel
to (rtol = atol = 1e-5, tests/test_bicycle.py), while the damped XLA one is
exact.  The JAX prior LLR is carried across (``convert.prior_llr_from_jax``).

Then the slice on the gross code: ``decode_batch`` (decisions, error codes),
the layered rejection, ``classify_batch`` with the default (physical)
logical test, relay on shared damping draws, and a CPU ``run_monte_carlo``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qec_ldpc_tpu import codes as jax_codes
from qec_ldpc_tpu.decoder import BPConfig as JaxBPConfig
from qec_ldpc_tpu.decoder import CodeGraphs as JaxCodeGraphs
from qec_ldpc_tpu.decoder import decode_batch as jax_decode_batch
from qec_ldpc_tpu.decoder.min_sum import min_sum_run as jax_min_sum_run
from qec_ldpc_tpu.decoder.sum_product import bp_run as jax_bp_run
from qec_ldpc_tpu.kernels.lifted_bp_pallas import lifted_bp_run_pallas
from qec_ldpc_tpu.kernels.lifted_min_sum_pallas import lifted_min_sum_run_pallas
from qec_ldpc_tpu.sampling.classify import classify_batch as jax_classify_batch
from qec_ldpc_tpu.sampling.classify import make_rank_basis_test as jax_rank_basis_test
from qec_ldpc_tpu_torch import codes
from qec_ldpc_tpu_torch.convert import (
    bpconfig_from_jax,
    float32_from_numpy,
    graphs_from_jax,
    prior_llr_from_jax,
)
from qec_ldpc_tpu_torch.decoder import (
    SYNDROME_FAIL_X,
    SYNDROME_FAIL_Z,
    BPConfig,
    decode_batch,
    min_sum,
    relay,
    sum_product,
)
from qec_ldpc_tpu_torch.kernels import (
    bp_cuda,
    lifted_bp_cuda,
    lifted_min_sum_cuda,
    min_sum_cuda,
)
from qec_ldpc_tpu_torch.parallel.montecarlo import run_monte_carlo
from qec_ldpc_tpu_torch.sampling import (
    C_CORRECTED,
    C_LOGICAL,
    C_TESTED,
    classify_batch,
    make_rank_basis_test,
)

CODES = {"gross": lambda c: c.known_bicycle_code("[[144,12,12]]"),
         "toric4": lambda c: c.toric_code(4)}
BATCH = 32
ITERS = 20
P_ERR = 0.03
PRIOR = np.float32(2.0 / 3.0) * np.float32(P_ERR)
MODES = {"fixed": (ITERS, ITERS + 1), "early-exit": (ITERS, 5)}

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


def np_depolarizing(rng, n, p, batch):
    """Depolarizing errors from NumPy draws (x|y -> X bit, z|y -> Z bit)."""
    err = rng.random((n, batch)) < p
    typ = rng.integers(0, 3, (n, batch))
    return ((err & (typ <= 1)).astype(np.int32),
            (err & (typ >= 1)).astype(np.int32))


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
    name, side = request.param
    jcode = CODES[name](jax_codes)
    jg = getattr(jcode.build_graphs(), side)
    tg = getattr(CODES[name](codes).build_graphs(), side)
    rng = np.random.default_rng(17)
    xe, ze = np_depolarizing(rng, jcode.n, P_ERR, BATCH)
    syn = np.array(jax.jit(jg.syndrome)(jnp.asarray(xe if side == "x" else ze)))
    gamma = rng.uniform(0.05, 1.0, (jg.num_vars, BATCH)).astype(np.float32)
    damping = np.array(jax.jit(jg.expand_vars)(jnp.asarray(gamma)))
    return jg, tg, syn, damping


@pytest.mark.parametrize("mode", sorted(MODES))
def test_min_sum_bit_exact_vs_jax_and_pallas(case, mode):
    jg, tg, syn, _ = case
    max_iters, check_every = MODES[mode]
    v_x, n_x = jax_min_sum_run(jg, jnp.asarray(syn), jnp.float32(PRIOR),
                               max_iters=max_iters, check_every=check_every)
    v_p, it_p = lifted_min_sum_run_pallas(
        jg, jnp.asarray(syn), jnp.float32(PRIOR), max_iters,
        check_every=check_every, tile_batch=16, interpret=True)
    before = (lifted_min_sum_cuda.launches, min_sum_cuda.launches,
              min_sum_cuda.wide_launches)
    v_t, it_t = min_sum_cuda.min_sum_run(tg, torch.from_numpy(syn),
                                         jax_prior_llr(PRIOR), max_iters,
                                         check_every)
    assert (lifted_min_sum_cuda.launches, min_sum_cuda.launches,
            min_sum_cuda.wide_launches) == before
    assert int(it_t.max()) == int(n_x) == int(np.max(np.asarray(it_p)))
    assert_bits_equal(v_t.numpy(), v_x)
    assert_bits_equal(v_t.numpy(), v_p)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_damped_min_sum_vs_jax_and_pallas(case, mode):
    jg, tg, syn, damping = case
    max_iters, check_every = MODES[mode]
    v_x, n_x = jax_min_sum_run(jg, jnp.asarray(syn), jnp.float32(PRIOR),
                               max_iters=max_iters, check_every=check_every,
                               damping=jnp.asarray(damping))
    v_p, it_p = lifted_min_sum_run_pallas(
        jg, jnp.asarray(syn), jnp.float32(PRIOR), max_iters,
        check_every=check_every, tile_batch=16, interpret=True,
        damping=jnp.asarray(damping))
    v_t, n_t = min_sum.min_sum_run(tg, torch.from_numpy(syn),
                                   jax_prior_llr(PRIOR), max_iters,
                                   check_every,
                                   damping=float32_from_numpy(damping, "cpu"))
    assert int(n_t) == int(n_x) == int(np.max(np.asarray(it_p)))
    assert_bits_equal(v_t.numpy(), v_x)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_p), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_sum_product_bit_exact_vs_jax_and_pallas(case, mode):
    jg, tg, syn, _ = case
    max_iters, check_every = MODES[mode]
    v_x, n_x = jax_bp_run(jg, jnp.asarray(syn), jnp.float32(PRIOR),
                          max_iters=max_iters, check_every=check_every)
    v_p, it_p = lifted_bp_run_pallas(
        jg, jnp.asarray(syn), jnp.float32(PRIOR), max_iters,
        check_every=check_every, tile_batch=16, interpret=True)
    before = (lifted_bp_cuda.launches, bp_cuda.launches)
    v_t, it_t = bp_cuda.bp_run(tg, torch.from_numpy(syn), PRIOR, max_iters,
                               check_every)
    assert (lifted_bp_cuda.launches, bp_cuda.launches) == before
    assert int(it_t.max()) == int(n_x) == int(np.max(np.asarray(it_p)))
    assert_bits_equal(v_t.numpy(), v_x)
    assert_bits_equal(v_t.numpy(), v_p)
    v_s, n_s = sum_product.bp_run(tg, torch.from_numpy(syn),
                                  torch.tensor(PRIOR), max_iters, check_every)
    assert_bits_equal(v_s.numpy(), v_x)


def test_lifted_wrappers_reject_bad_input(case):
    _, tg, syn, damping = case
    s = torch.from_numpy(syn)
    llr = jax_prior_llr(PRIOR)
    with pytest.raises(TypeError):
        lifted_min_sum_cuda.lifted_min_sum_run(tg, s.to(torch.int64), llr, 5)
    with pytest.raises(ValueError):
        lifted_bp_cuda.lifted_bp_run(tg, s[:-1], PRIOR, 5)
    with pytest.raises(TypeError):
        lifted_min_sum_cuda.lifted_min_sum_run(
            tg, s, llr, 5, damping=torch.from_numpy(damping).double())
    with pytest.raises(ValueError):
        lifted_min_sum_cuda.lifted_min_sum_run(
            tg, s, llr, 5, damping=torch.from_numpy(damping)[:, :4])
    circulant = graphs_from_jax(JaxCodeGraphs.build(
        jax_codes.construct_code(3, 3, 6, 7, 2, 3))).x
    with pytest.raises(TypeError):
        lifted_bp_cuda.lifted_bp_run(circulant, s, PRIOR, 5)


# -- the slice on the gross code -------------------------------------------------


@pytest.fixture(scope="module")
def gross():
    jg = jax_codes.known_bicycle_code("[[144,12,12]]").build_graphs()
    tg = codes.known_bicycle_code("[[144,12,12]]").build_graphs()
    xe, ze = np_depolarizing(np.random.default_rng(23), jg.code.n, 0.04, 128)
    sx, sz = (np.array(s) for s in jax.jit(
        lambda a, b: (jg.x.syndrome(a), jg.z.syndrome(b)))(xe, ze))
    return jg, tg, xe, ze, sx, sz


@pytest.mark.parametrize("cfg", [
    JaxBPConfig(max_iters=40, check_every=10),
    JaxBPConfig(max_iters=25, check_every=26),
    JaxBPConfig(max_iters=40, check_every=10, algorithm="min-sum"),
    JaxBPConfig(max_iters=25, check_every=26, algorithm="min-sum"),
], ids=["sum-product", "sum-product-fixed", "min-sum", "min-sum-fixed"])
def test_decode_batch_exact_vs_jax(gross, cfg):
    jg, tg, _, _, sx, sz = gross
    want = jax_decode_batch(jg, jnp.asarray(sx), jnp.asarray(sz), P_ERR, cfg)
    got = decode_batch(tg, torch.from_numpy(sx), torch.from_numpy(sz), P_ERR,
                       bpconfig_from_jax(cfg))
    np.testing.assert_array_equal(got.decisions_x.numpy(), np.asarray(want.decisions_x))
    np.testing.assert_array_equal(got.decisions_z.numpy(), np.asarray(want.decisions_z))
    np.testing.assert_array_equal(got.error_code.numpy(), np.asarray(want.error_code))
    assert int(got.iters_x) == int(want.iters_x)
    assert int(got.iters_z) == int(want.iters_z)
    assert int(got.iter_samples_z) == int(want.iter_samples_z)
    assert int((got.error_code != 0).sum()) > 0  # the batch exercises failures


def test_layered_on_lifted_graph_raises(gross):
    _, tg, _, _, sx, sz = gross
    cfg = BPConfig(max_iters=10, algorithm="layered-min-sum")
    with pytest.raises(ValueError, match="layered-min-sum requires"):
        decode_batch(tg, torch.from_numpy(sx), torch.from_numpy(sz), P_ERR, cfg)


@pytest.mark.parametrize("algorithm", ["sum-product", "min-sum"])
def test_classify_counters_match_jax(gross, algorithm):
    """The default logical test of a lifted family is the physical one:
    classify_batch on the port's decode equals JAX's counters."""
    jg, tg, xe, ze, sx, sz = gross
    cfg = JaxBPConfig(max_iters=40, algorithm=algorithm)
    want_res = jax_decode_batch(jg, jnp.asarray(sx), jnp.asarray(sz), P_ERR, cfg)
    want = np.asarray(jax_classify_batch(
        jax_rank_basis_test(jg.code), jnp.asarray(xe), jnp.asarray(ze),
        want_res.decisions_x.astype(jnp.int32),
        want_res.decisions_z.astype(jnp.int32), want_res.error_code))
    res = decode_batch(tg, torch.from_numpy(sx), torch.from_numpy(sz), P_ERR,
                       bpconfig_from_jax(cfg))
    test = make_rank_basis_test(tg.code, "cpu")
    got = classify_batch(test, torch.from_numpy(xe), torch.from_numpy(ze),
                         res.decisions_x.to(torch.int32),
                         res.decisions_z.to(torch.int32), res.error_code)
    np.testing.assert_array_equal(got.numpy(), want)
    for a, b in zip(test, jax_rank_basis_test(jg.code, "reference")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    physical = make_rank_basis_test(tg.code, "cpu", "physical")
    assert all(torch.equal(a, b) for a, b in zip(test, physical))


@pytest.mark.parametrize("side", ["x", "z"])
def test_relay_retries_match_jax_on_shared_gammas(gross, side):
    """Up to two damped retries with the same gammas: the port's retry loop
    (K5's route on a CUDA tensor) equals JAX's damped XLA min-sum +
    re-encode + replace-only-newly-solved, lane for lane, and stops after
    the same retry."""
    jg, tg, _, _, sx, sz = gross
    cfg = JaxBPConfig(max_iters=50, algorithm="min-sum")
    batch = sx.shape[1]
    res = decode_batch(tg, torch.from_numpy(sx), torch.from_numpy(sz), P_ERR,
                       bpconfig_from_jax(cfg))
    bit = SYNDROME_FAIL_X if side == "x" else SYNDROME_FAIL_Z
    jgraph, tgraph = getattr(jg, side), getattr(tg, side)
    syn = sx if side == "x" else sz
    dec0 = getattr(res, f"decisions_{side}")
    solved0 = (res.error_code & bit) == 0
    assert not bool(solved0.all())
    rng = np.random.default_rng(29)
    gam = [rng.uniform(0.05, 1.0, (jgraph.num_vars, batch)).astype(np.float32)
           for _ in range(2)]
    prior = jnp.float32(2 / 3) * jnp.float32(P_ERR)
    dec, solved = jnp.asarray(dec0.numpy()), jnp.asarray(solved0.numpy())
    used_j = 0
    for g in gam:
        if bool(solved.all()):
            break
        used_j += 1
        s_eff = jnp.where(solved[None, :], 0, jnp.asarray(syn))
        v, _ = jax_min_sum_run(jgraph, s_eff, prior, max_iters=50,
                               check_every=10,
                               damping=jgraph.expand_vars(jnp.asarray(g)))
        d_new = jnp.any(jgraph.vn_view(jgraph.to_var(v)) <= 0.0,
                        axis=0).astype(dec.dtype)
        sat = ~jnp.any(jgraph.syndrome(d_new.astype(jnp.int32))
                       != jnp.asarray(syn), axis=0)
        newly = sat & ~solved
        dec = jnp.where(newly[None, :], d_new, dec)
        solved = solved | newly
    llr = min_sum.prior_llr(np.float32(2 / 3) * np.float32(P_ERR))
    assert llr == jax_prior_llr(np.float32(2 / 3) * np.float32(P_ERR))
    d_t, s_t, used, _ = relay._relay_one_graph(
        tgraph, torch.from_numpy(syn), llr, bpconfig_from_jax(cfg),
        lambda r: float32_from_numpy(gam[r], "cpu"), dec0, solved0, retries=2)
    assert used == used_j >= 1
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(dec))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(solved))


@pytest.mark.parametrize("algorithm,relay_retries", [
    ("sum-product", 0), ("min-sum", 0), ("min-sum", 4)],
    ids=["sum-product", "min-sum", "relay"])
def test_run_monte_carlo_on_gross(algorithm, relay_retries):
    """A small CPU run counts every sample, with the physical logical test."""
    tg = codes.known_bicycle_code("[[144,12,12]]").build_graphs()
    cfg = BPConfig(max_iters=30, algorithm=algorithm)
    counters, lane_iters = run_monte_carlo(
        tg, 0, 4 * 64, 0.03, cfg, seed=5, batch_size=64, steps_per_call=2,
        error_model="depolarizing", relay_retries=relay_retries, device="cpu")
    assert counters[C_TESTED] == 256 and lane_iters > 0
    assert 0 < counters[C_CORRECTED] + counters[C_LOGICAL] <= 256
    assert counters[C_CORRECTED] > 0.8 * 256
