"""K8, one graph-sharded min-sum iteration (kernels/sharded_step_cuda.py),
against the JAX package on the CPU, bit for bit.

The same NumPy inputs, with planted +-0.0, NaN and +-inf, half the lanes
done and ``last`` 0 and 1, go through the port's plain step (row layout)
and through JAX's ``sharded_min_sum_step_pallas`` in interpret mode, as the
JAX package's own tests run it (transposed, 128-padded lanes; converted with
``convert.lanes_to_rows``), and through an XLA image of the JAX engine's
body in its own row layout (``benchmarks/sharded_step_bench.py:137-202``).
Tolerance: none — NaN masks equal and every other bit equal.  The wrapper
and the kernel against the plain version on the card are
``test_torch_kernel_sharded_step.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qec_ldpc_tpu.codes import construct_code
from qec_ldpc_tpu.decoder import CodeGraphs as JaxCodeGraphs
from qec_ldpc_tpu.kernels.sharded_step_pallas import sharded_min_sum_step_pallas
from qec_ldpc_tpu.parallel.graph_sharded import _static_roll_blocks
from qec_ldpc_tpu_torch.convert import (
    done_to_lanes,
    graph_from_jax,
    lanes_to_rows,
)
from qec_ldpc_tpu_torch.kernels import sharded_step_cuda
from qec_ldpc_tpu_torch.parallel.graph_sharded import ShardRouter

CODES = {"42": (3, 3, 6, 7, 2, 3), "610": (4, 5, 10, 61, 9, 49)}
# (code, graph, G): every shard position g of each
SHARDS = [("42", "x", 2), ("42", "z", 3), ("610", "x", 2)]
CASES = [(c, s, G, g) for c, s, G in SHARDS for g in range(G)]
BATCH = 16
ALPHA = 0.75
LLR = np.float32(4.59)

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


def assert_bits_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    np.testing.assert_array_equal(nan_g, nan_w)
    np.testing.assert_array_equal(got[~nan_g].view(np.int32),
                                  want[~nan_w].view(np.int32))


def planted(rng, shape, scale=4.0, nonneg=False):
    """Normal draws with about 3% each of +0.0, -0.0, NaN, +inf, -inf."""
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    if nonneg:
        a = np.abs(a) + np.float32(0.5)
    pick = rng.random(shape)
    specials = [0.0, -0.0, math.nan, math.inf, -math.inf]
    for i, value in enumerate(specials):
        a[(pick >= 0.03 * i) & (pick < 0.03 * (i + 1))] = value
    return a


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: f"{c[0]}-{c[1]}-G{c[2]}-g{c[3]}")
def case(request):
    """The shard's JAX graph, router and NumPy inputs in the TPU layout."""
    code_name, side, G, g = request.param
    jg = getattr(JaxCodeGraphs.build(construct_code(*CODES[code_name])), side)
    B, P = jg.B, jg.P
    Lc = jg.L // G
    Pl = -(-P // 128) * 128
    rng = np.random.default_rng(100 + 10 * G + g)
    v = planted(rng, (Lc * B, BATCH, Pl))
    omin = planted(rng, (B, BATCH, Pl), nonneg=True)
    osgn = np.where(rng.random((B, BATCH, Pl)) < 0.5, -1.0, 1.0)
    syn = np.where(rng.random((B, BATCH, Pl)) < 0.3, -1.0, 1.0)
    done = torch.from_numpy(rng.random(BATCH) < 0.5)
    return dict(jg=jg, G=G, g=g, Lc=Lc, P=P,
                router=ShardRouter(graph_from_jax(jg), G, g), v=v,
                other=np.concatenate([omin, osgn]).astype(np.float32),
                syn=syn.astype(np.float32), done=done)


def port_inputs(c, device="cpu"):
    P = c["P"]
    return (lanes_to_rows(c["syn"], P, device),
            lanes_to_rows(c["other"], P, device), c["done"].to(device),
            lanes_to_rows(c["v"], P, device))


def port_step(c, last, device="cpu"):
    syn, other, done, v = port_inputs(c, device)
    return sharded_step_cuda.sharded_min_sum_step(
        c["router"], float(LLR), last, syn, other, done, v, ALPHA)


@pytest.mark.parametrize("last", [0, 1])
def test_plain_step_bit_exact_vs_pallas_interpret(case, last):
    c = case
    v_new, part = port_step(c, last)
    want_v, want_p = sharded_min_sum_step_pallas(
        c["jg"], c["Lc"], c["g"], jnp.asarray([LLR]),
        jnp.asarray([last], jnp.int32), jnp.asarray(c["syn"]),
        jnp.asarray(c["other"]), jnp.asarray(done_to_lanes(c["done"])),
        jnp.asarray(c["v"]), alpha=ALPHA, interpret=True)
    assert_bits_equal(v_new, lanes_to_rows(want_v, c["P"]))
    assert_bits_equal(part, lanes_to_rows(want_p, c["P"]))
    # the planted values reach the outputs
    assert v_new.isnan().any() and v_new.isinf().any()
    assert (v_new == 0).any()


def engine_body(jg, Lc, g, last, syn_rows, other_rows, done, v_rows):
    """The JAX engine's body on its row layout (graph_sharded.py:397-439 with
    the other shards' reduction as an input): the shipped step K8 replaces
    (sharded_step_bench.py:137-202)."""
    B, P = jg.B, jg.P
    table = np.asarray(jg.table)[:, g * Lc:(g + 1) * Lc] % P
    bt = v_rows.shape[-1]
    syn_sign = syn_rows.reshape(B, P * bt)
    o_min = other_rows[:B * P].reshape(B, P * bt)
    o_sgn = other_rows[B * P:].reshape(B, P * bt)
    t = v_rows.reshape(Lc, B, P * bt)
    mags = [jnp.abs(t[i]) for i in range(Lc)]
    sgns = [jnp.where(t[i] < 0, -1.0, 1.0) for i in range(Lc)]
    big = jnp.full_like(mags[0], jnp.inf)
    ones = jnp.ones_like(sgns[0])
    pre_m, pre_s = [big] * Lc, [ones] * Lc
    for i in range(1, Lc):
        pre_m[i] = jnp.minimum(pre_m[i - 1], mags[i - 1])
        pre_s[i] = pre_s[i - 1] * sgns[i - 1]
    suf_m, suf_s = [big] * Lc, [ones] * Lc
    for i in range(Lc - 2, -1, -1):
        suf_m[i] = jnp.minimum(suf_m[i + 1], mags[i + 1])
        suf_s[i] = suf_s[i + 1] * sgns[i + 1]
    es = []
    for i in range(Lc):
        loo_min = jnp.minimum(jnp.minimum(pre_m[i], suf_m[i]), o_min)
        loo_sgn = pre_s[i] * suf_s[i] * o_sgn
        es.append(syn_sign * (ALPHA * loo_sgn * loo_min))
    e = jnp.stack(es).reshape(Lc * B * P, bt)
    var_shifts = tuple(int(-table[b, l]) % P for l in range(Lc) for b in range(B))
    chk_shifts = tuple(int(table[b, l]) % P for l in range(Lc) for b in range(B))
    ev = _static_roll_blocks(e, var_shifts, P).reshape(Lc, B, P * bt)
    terms = [ev[:, i] for i in range(B)]
    zeros = jnp.zeros_like(terms[0])
    pre = [zeros] * B
    for i in range(1, B):
        pre[i] = pre[i - 1] + terms[i - 1]
    suf = [zeros] * B
    for i in range(B - 2, -1, -1):
        suf[i] = suf[i + 1] + terms[i + 1]
    full = (pre[-1] + suf[-1]) + terms[-1]
    outs = [LLR + jnp.where(last > 0, full, pre[i] + suf[i]) for i in range(B)]
    vv = jnp.stack(outs, axis=1).reshape(Lc * B * P, bt)
    v_new = jnp.where(done[None, :], v_rows,
                      _static_roll_blocks(vv, chk_shifts, P))
    tr = v_new.reshape(Lc, B * P, bt)
    pm = jnp.abs(tr[0])
    ps = jnp.where(tr[0] < 0, -1.0, 1.0)
    for i in range(1, Lc):
        pm = jnp.minimum(pm, jnp.abs(tr[i]))
        ps = ps * jnp.where(tr[i] < 0, -1.0, 1.0)
    return v_new, jnp.concatenate([pm, ps])


@pytest.mark.parametrize("last", [0, 1])
def test_plain_step_bit_exact_vs_engine_body(case, last):
    c = case
    syn, other, done, v = port_inputs(c)
    v_new, part = sharded_step_cuda.sharded_min_sum_step(
        c["router"], float(LLR), last, syn, other, done, v, ALPHA)
    body = jax.jit(engine_body, static_argnums=(0, 1, 2))
    want_v, want_p = body(c["jg"], c["Lc"], c["g"], jnp.int32(last),
                          jnp.asarray(syn.numpy()), jnp.asarray(other.numpy()),
                          jnp.asarray(done.numpy()), jnp.asarray(v.numpy()))
    assert_bits_equal(v_new, want_v)
    assert_bits_equal(part, want_p)
