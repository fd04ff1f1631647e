"""The port's relay decoder (decoder/relay.py) against the JAX package.

Damping draws cannot match (torch.Generator vs JAX keys), so relay is held
exactly on shared gammas — one or two retries equal JAX's
``min_sum_run(damping=expand_vars(gamma))`` followed by the exact re-encode —
and statistically end to end: the repair rate on shared syndromes agrees
with JAX's ``relay_decode_batch`` by a two-sample z-test.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qec_ldpc_tpu.codes import construct_code
from qec_ldpc_tpu.decoder import BPConfig as JaxBPConfig
from qec_ldpc_tpu.decoder import CodeGraphs as JaxCodeGraphs
from qec_ldpc_tpu.decoder.min_sum import min_sum_run as jax_min_sum_run
from qec_ldpc_tpu.decoder.relay import relay_decode_batch as jax_relay_decode_batch
from qec_ldpc_tpu_torch.convert import (
    bpconfig_from_jax,
    float32_from_numpy,
    graphs_from_jax,
)
from qec_ldpc_tpu_torch.decoder import (
    SYNDROME_FAIL_X,
    SYNDROME_FAIL_Z,
    decode_batch,
    min_sum,
    relay,
)

CODE42 = (3, 3, 6, 7, 2, 3)
P_ERR = 0.02
CFG = JaxBPConfig(max_iters=100, algorithm="min-sum")
SYN_BITS = SYNDROME_FAIL_X | SYNDROME_FAIL_Z

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


def np_errors(rng, n, weight, batch):
    idx = rng.integers(0, n, (weight, batch))
    typ = rng.integers(0, 3, (weight, batch))
    cols = np.broadcast_to(np.arange(batch), idx.shape)
    xe = np.zeros((n, batch), np.int32)
    ze = np.zeros((n, batch), np.int32)
    xe[idx[typ <= 1], cols[typ <= 1]] = 1
    ze[idx[typ >= 1], cols[typ >= 1]] = 1
    return xe, ze


@pytest.fixture(scope="module")
def g42():
    jg = JaxCodeGraphs.build(construct_code(*CODE42))
    return jg, graphs_from_jax(jg)


def syndromes(jg, weight, batch, seed):
    xe, ze = np_errors(np.random.default_rng(seed), jg.code.n, weight, batch)
    sx, sz = jax.jit(lambda a, b: (jg.x.syndrome(a), jg.z.syndrome(b)))(xe, ze)
    return np.array(sx), np.array(sz)


def draws(seed):
    return relay.RelayDraws([seed], "cpu")


def test_zero_damping_equals_undamped(g42):
    """d = 0 blends fma(1, v_new, 0 * v_old) = v_new: bit for bit the
    undamped run, early exit included."""
    jg, tg = g42
    sx, _ = syndromes(jg, 4, 128, seed=1)
    llr = min_sum.prior_llr(np.float32(2 / 3) * np.float32(P_ERR))
    zeros = torch.zeros((tg.x.num_edges, 128), dtype=torch.float32)
    v_d, n_d = min_sum.min_sum_run(tg.x, torch.from_numpy(sx), llr, 100, 10,
                                   damping=zeros)
    v_u, n_u = min_sum.min_sum_run(tg.x, torch.from_numpy(sx), llr, 100, 10)
    assert int(n_d) == int(n_u)
    assert torch.equal(v_d.view(torch.int32), v_u.view(torch.int32))


@pytest.mark.parametrize("side", ["x", "z"])
def test_retries_match_jax_on_shared_gammas(g42, side):
    """Two retries with the same gammas: the port's retry loop equals JAX's
    damped min-sum + re-encode + replace-only-newly-solved, lane for lane,
    and counts each retry's lane-iterations (iterations x batch on the plain
    path)."""
    jg, tg = g42
    batch = 256
    sx, sz = syndromes(jg, 4, batch, seed=2)
    res = decode_batch(tg, torch.from_numpy(sx), torch.from_numpy(sz), P_ERR,
                       bpconfig_from_jax(CFG))
    bit = SYNDROME_FAIL_X if side == "x" else SYNDROME_FAIL_Z
    jgraph, tgraph = getattr(jg, side), getattr(tg, side)
    syn = sx if side == "x" else sz
    dec0 = getattr(res, f"decisions_{side}")
    solved0 = (res.error_code & bit) == 0
    assert not bool(solved0.all())
    rng = np.random.default_rng(5)
    gam = [rng.uniform(0.05, 1.0, (jgraph.num_vars, batch)).astype(np.float32)
           for _ in range(2)]

    prior = jnp.float32(2 / 3) * jnp.float32(P_ERR)
    dec, solved, iters = (jnp.asarray(dec0.numpy()),
                          jnp.asarray(solved0.numpy()), 0)
    for g in gam:
        s_eff = jnp.where(solved[None, :], 0, jnp.asarray(syn))
        v, n = jax_min_sum_run(jgraph, s_eff, prior, max_iters=100,
                               check_every=10,
                               damping=jgraph.expand_vars(jnp.asarray(g)))
        d_new = jnp.any(jgraph.vn_view(jgraph.to_var(v)) <= 0.0,
                        axis=0).astype(dec.dtype)
        sat = ~jnp.any(jgraph.syndrome(d_new.astype(jnp.int32))
                       != jnp.asarray(syn), axis=0)
        newly = sat & ~solved
        dec = jnp.where(newly[None, :], d_new, dec)
        solved = solved | newly
        iters += int(n) * batch

    llr = min_sum.prior_llr(np.float32(2 / 3) * np.float32(P_ERR))
    d_t, s_t, used, extra = relay._relay_one_graph(
        tgraph, torch.from_numpy(syn), llr, bpconfig_from_jax(CFG),
        lambda r: float32_from_numpy(gam[r], "cpu"), dec0, solved0, retries=2)
    assert used == 2
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(dec))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(solved))
    assert int(extra) == iters
    assert int(s_t.sum()) > int(solved0.sum())


def test_flags_and_accounting(g42):
    jg, tg = g42
    batch = 256
    sx, sz = (torch.from_numpy(s) for s in syndromes(jg, 4, batch, seed=3))
    cfg = bpconfig_from_jax(CFG)
    base = decode_batch(tg, sx, sz, P_ERR, cfg)
    res, rx, rz = relay.relay_decode_batch(tg, sx, sz, P_ERR, draws(7),
                                           cfg, retries=4)
    ec0, ec = base.error_code, res.error_code
    assert 0 < rx <= 4 and 0 < rz <= 4
    # convergence bits keep the primary decode's meaning; syndrome bits are
    # only ever cleared
    assert torch.equal(ec & ~SYN_BITS, ec0 & ~SYN_BITS)
    assert not bool(((ec & SYN_BITS) & ~(ec0 & SYN_BITS)).any())
    repaired = ((ec0 & SYN_BITS) != 0) & ((ec & SYN_BITS) == 0)
    assert bool(repaired.any())
    for side, bit, graph, syn in (("x", SYNDROME_FAIL_X, tg.x, sx),
                                  ("z", SYNDROME_FAIL_Z, tg.z, sz)):
        d, d0 = getattr(res, f"decisions_{side}"), getattr(base, f"decisions_{side}")
        ok0 = (ec0 & bit) == 0
        # lanes the primary decode solved keep their decisions
        assert torch.equal(d[:, ok0], d0[:, ok0])
        # every lane reported solved satisfies its syndrome
        sat = (graph.syndrome(d.to(torch.int32)) == syn).all(dim=0)
        assert bool(sat[(ec & bit) == 0].all())
        # retries' lane-iterations are added, whole batches on the plain path
        extra = int(getattr(res, f"iter_samples_{side}")
                    - getattr(base, f"iter_samples_{side}"))
        assert extra > 0 and extra % batch == 0


def test_clean_batch_is_a_no_op(g42, monkeypatch):
    _, tg = g42
    s = torch.zeros((tg.x.num_checks, 64), dtype=torch.int32)
    cfg = bpconfig_from_jax(CFG)
    base = decode_batch(tg, s, s, P_ERR, cfg)
    seeded = []
    monkeypatch.setattr(relay, "seeded_generator",
                        lambda *a: seeded.append(a))
    res, rx, rz = relay.relay_decode_batch(tg, s, s, P_ERR, draws(9), cfg,
                                           retries=8)
    assert rx == rz == 0
    assert seeded == []  # no gammas drawn
    for f in ("decisions_x", "decisions_z", "error_code", "iter_samples_x",
              "iter_samples_z"):
        assert torch.equal(getattr(res, f), getattr(base, f)), f


def test_repair_rate_agrees_with_jax(g42):
    """Shared syndromes, different damping streams: the fraction of primary
    syndrome failures the relay repairs agrees by a two-sample z-test."""
    jg, tg = g42
    batch = 1024
    sx, sz = syndromes(jg, 4, batch, seed=4)
    res_j, _, _ = jax_relay_decode_batch(jg, jnp.asarray(sx), jnp.asarray(sz),
                                         P_ERR, jax.random.PRNGKey(4), CFG,
                                         retries=8)
    base = decode_batch(tg, torch.from_numpy(sx), torch.from_numpy(sz), P_ERR,
                        bpconfig_from_jax(CFG))
    res_t, _, _ = relay.relay_decode_batch(
        tg, torch.from_numpy(sx), torch.from_numpy(sz), P_ERR, draws(4),
        bpconfig_from_jax(CFG), retries=8)
    fail0 = int(((base.error_code & SYN_BITS) != 0).sum())
    left_t = int(((res_t.error_code & SYN_BITS) != 0).sum())
    left_j = int((np.asarray(res_j.error_code) & SYN_BITS != 0).sum())
    assert fail0 > 200
    p1, p2 = 1 - left_t / fail0, 1 - left_j / fail0
    pool = (p1 + p2) / 2
    z = (p1 - p2) / math.sqrt(pool * (1 - pool) * 2 / fail0)
    assert abs(z) < 4, (p1, p2, z)
