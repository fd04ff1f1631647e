"""The port's plain sum-product BP against the JAX package, bit for bit.

Same syndromes (NumPy draws) through JAX ``bp_run`` (and the Pallas kernel
in interpret mode) and through the port's ``bp_run``.  Tolerance: none —
finite messages must be bit-identical, NaN masks (saturated lanes) equal and
the iteration counts equal.  The one fused multiply-add XLA forms on the CPU
(the variable-node denominator) is reproduced by ``fma_f32``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qec_ldpc_tpu.codes import construct_code
from qec_ldpc_tpu.decoder import BPConfig as JaxBPConfig
from qec_ldpc_tpu.decoder import CodeGraphs as JaxCodeGraphs
from qec_ldpc_tpu.decoder import bp_run as jax_bp_run
from qec_ldpc_tpu.kernels.bp_pallas import bp_run_pallas
from qec_ldpc_tpu_torch.convert import bpconfig_from_jax, graph_from_jax
from qec_ldpc_tpu_torch.decoder.sum_product import BPConfig, bp_run, fma_f32

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


@pytest.fixture(scope="module", params=[(c, s) for c in CODES for s in "xz"],
                ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    code_name, side = request.param
    params, weight = CODES[code_name]
    code = construct_code(*params)
    jg = getattr(JaxCodeGraphs.build(code), side)
    xe, ze = np_errors(np.random.default_rng(11), code.n, weight, BATCH)
    syn = np.array(jax.jit(jg.syndrome)(jnp.asarray(xe if side == "x" else ze)))
    return jg, graph_from_jax(jg), syn


def test_bpconfig_matches_jax():
    jf = {f.name: f.default for f in dataclasses.fields(JaxBPConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(BPConfig)}
    assert tf == jf
    cfg = JaxBPConfig(max_iters=7, check_every=3, conv_low=0.02)
    assert dataclasses.asdict(bpconfig_from_jax(cfg)) == dataclasses.asdict(cfg)


@pytest.mark.parametrize("mode", ["fixed-1", "fixed-7", "fixed-20", "early-exit"])
def test_bp_run_bit_exact_vs_jax(case, mode):
    jg, tg, syn = case
    if mode == "early-exit":
        max_iters, check_every = 100, 10
    else:
        max_iters = int(mode.split("-")[1])
        check_every = max_iters + 1
    v_j, n_j = jax_bp_run(jg, jnp.asarray(syn), jnp.float32(PRIOR),
                          max_iters=max_iters, check_every=check_every)
    v_t, n_t = bp_run(tg, torch.from_numpy(syn), torch.tensor(PRIOR),
                      max_iters, check_every)
    assert v_t.dtype == torch.float32 and n_t.dtype == torch.int32
    assert int(n_t) == int(n_j)
    assert_bits_equal(v_t.numpy(), v_j)


@pytest.mark.parametrize("max_iters,check_every", [(20, 21), (50, 10)])
def test_bp_run_bit_exact_vs_pallas_interpret(max_iters, check_every):
    """The Pallas kernel (interpret mode) on the [[42]] code, 8-lane tiles."""
    code = construct_code(*CODES["42"][0])
    jg = JaxCodeGraphs.build(code).z
    xe, ze = np_errors(np.random.default_rng(12), code.n, 3, 64)
    syn = np.array(jax.jit(jg.syndrome)(jnp.asarray(ze)))
    v_k, it_k = bp_run_pallas(jg, jnp.asarray(syn), jnp.float32(PRIOR),
                              max_iters=max_iters, check_every=check_every,
                              tile_batch=8, interpret=True)
    v_t, n_t = bp_run(graph_from_jax(jg), torch.from_numpy(syn),
                      torch.tensor(PRIOR), max_iters, check_every)
    assert int(n_t) == int(np.max(np.asarray(it_k)))
    assert_bits_equal(v_t.numpy(), v_k)


def test_fma_f32_rounds_once():
    """Against exact rational arithmetic on random and tie-prone inputs."""
    from fractions import Fraction

    rng = np.random.default_rng(5)
    a = rng.random(2000, dtype=np.float32)
    b = rng.random(2000, dtype=np.float32) * np.float32(1e-3)
    c = rng.random(2000, dtype=np.float32) * np.float32(1e-6)
    # c = -a*b rounded: the sum is the tiny rounding error of the product
    c[:500] = -(a[:500] * b[:500])
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c))
    for i in range(len(a)):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        # np.float32(float) of a double is correctly rounded; the exact value
        # needs two steps, so compare against both f32 neighbours' distance
        want = np.float32(float(exact))
        lo = np.nextafter(want, np.float32(-np.inf))
        hi = np.nextafter(want, np.float32(np.inf))
        best = min((want, lo, hi), key=lambda f: (abs(Fraction(float(f)) - exact),
                                                  int(np.float32(f).view(np.int32)) & 1))
        assert got[i].item() == float(best), (i, a[i], b[i], c[i])
