"""What the graph-sharded step kernel (csrc/sharded_min_sum_step.cu) rests
on, checked on the CPU.

* The compressed check state.  Per check and lane, over the shard's Lc
  columns: min1 and min2 of |V| over the non-NaN edges, each combined with
  the other shards' minimum, the argmin, the NaN count (capped at 2) and the
  edge of a single NaN, the sign parity xor the syndrome and the other
  shards' sign, and each edge's own sign bit.  A torch emulation of the
  kernel's check phase and of the variable phase's rebuild of each E gives
  ``sharded_step_cuda.check_messages`` bit for bit, and through
  ``variable_sums`` the step's ``variable_update``.
* The partials.  The kernel folds them into the variable phase (a
  NaN-first key of |V_new| under atomicMin, an xor of the sign bits), and
  takes a done lane's from its check-phase state; emulated both ways they
  equal ``local_partials`` of the masked V_new.
* ``sharded_step_cuda.plan`` at several shared-memory limits.

Inputs carry +-0.0, NaN, +-inf and ties in V, NaN and +-0.0 in the other
shards' minima, half the lanes done, ``last`` 0 and 1, on every shard
position at G=2 and G=5.  Tolerance: none — NaN masks equal and every other
bit equal.
"""

import math

import pytest
import torch

from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.decoder.decode import CodeGraphs
from qec_ldpc_tpu_torch.decoder.min_sum import f32
from qec_ldpc_tpu_torch.kernels import sharded_step_cuda
from qec_ldpc_tpu_torch.parallel.graph_sharded import ShardRouter

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

CODES = {"610": (4, 5, 10, 61, 9, 49), "5210": (4, 5, 10, 521, 25, 1)}
# (code, graph, G): every shard position g of each
SHARDS = [("610", "x", 2), ("610", "x", 5), ("610", "z", 2), ("610", "z", 5)]
CASES = [(c, s, G, g) for c, s, G in SHARDS for g in range(G)]
ALPHA = 0.75
LLR = 4.59
BATCH = 24
H100_SMEM = 232448


def assert_bits_equal(got, want):
    assert torch.equal(got.isnan(), want.isnan())
    keep = ~want.isnan()
    assert torch.equal(got.view(torch.int32)[keep], want.view(torch.int32)[keep])


def planted(gen, shape, values, share=0.04):
    """Values rounded to halves (ties in |V|) with about ``share`` each of
    ``values`` planted."""
    a = torch.round(torch.randn(shape, generator=gen) * 8) / 2
    pick = torch.rand(shape, generator=gen)
    for i, value in enumerate(values):
        a[(pick >= share * i) & (pick < share * (i + 1))] = value
    return a


def inputs(router, seed):
    """(syn_sign, other, done, v) in the row layout, on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    checks = router.B * router.P
    v = planted(gen, (router.Lc * checks, BATCH),
                (0.0, -0.0, math.nan, math.inf, -math.inf))
    omin = planted(gen, (checks, BATCH), (0.0, -0.0, math.nan, math.inf)).abs()
    omin[torch.rand(omin.shape, generator=gen) < 0.04] = -0.0
    osgn = torch.where(torch.rand((checks, BATCH), generator=gen) < 0.5, -1.0, 1.0)
    syn = torch.where(torch.rand((checks, BATCH), generator=gen) < 0.3, -1.0, 1.0)
    done = torch.rand(BATCH, generator=gen) < 0.5
    return syn, torch.cat([omin, osgn]), done, v


def check_state(router, syn_sign, other, v):
    """The kernel's check phase: per check and lane, (min1', min2', arg,
    nans capped at 2, the single NaN's edge, parity, own sign bits), edges
    walked in order l = 0 .. Lc-1, plus the local minimum and sign parity a
    done lane's partials come from."""
    checks = router.B * router.P
    t = v.reshape(router.Lc, checks, -1)
    m1 = torch.full_like(t[0], math.inf)
    m2 = torch.full_like(t[0], math.inf)
    arg = torch.full(m1.shape, 31, dtype=torch.int32)
    nans = torch.zeros(m1.shape, dtype=torch.int32)
    nan_at = torch.zeros(m1.shape, dtype=torch.int32)
    neg = torch.zeros(m1.shape, dtype=torch.bool)
    signs = []
    for l in range(router.Lc):
        x = t[l]
        a, isn = x.abs(), x.isnan()
        neg = neg ^ (x < 0)
        signs.append(x < 0)
        nans = nans + isn
        nan_at = torch.where(isn, l, nan_at)
        lt1 = ~isn & (a < m1)
        lt2 = ~isn & ~lt1 & (a < m2)
        m2 = torch.where(lt1, m1, torch.where(lt2, a, m2))
        m1 = torch.where(lt1, a, m1)
        arg = torch.where(lt1, l, arg)
    omin, osgn = other[:checks], other[checks:]
    parity = neg ^ (osgn < 0) ^ (syn_sign < 0)
    state = (torch.minimum(m1, omin), torch.minimum(m2, omin), arg,
             nans.clamp(max=2), nan_at, parity, signs)
    local = (torch.where(nans > 0, math.nan, m1), neg)
    return state, local


def rebuild_messages(router, state, alpha):
    """The variable phase's rebuild of each E from the state alone."""
    alpha = f32(alpha)
    m1, m2, arg, nans, nan_at, parity, signs = state
    out = []
    for l in range(router.Lc):
        nan_other = nans > (nan_at == l).to(torch.int32)
        loo = torch.where(nan_other, math.nan, torch.where(arg == l, m2, m1))
        out.append(torch.where(parity ^ signs[l], -alpha, alpha) * loo)
    return torch.stack(out).reshape(-1, m1.shape[-1])


def folded_partials(router, v_new):
    """The fold: atomicMin of the key (0 for NaN, else the bits of |V_new|
    plus one) and the xor of the sign bits, per check, over the Lc edges in
    any order (here backwards)."""
    t = v_new.reshape(router.Lc, router.B * router.P, -1)
    key = torch.full(t[0].shape, 2 ** 32 - 1, dtype=torch.int64)
    neg = torch.zeros(t[0].shape, dtype=torch.bool)
    for l in reversed(range(router.Lc)):
        x = t[l]
        bits = x.abs().view(torch.int32).to(torch.int64) + 1
        key = torch.minimum(key, torch.where(x.isnan(), 0, bits))
        neg = neg ^ (x < 0)
    m = torch.where(key == 0, math.nan,
                    (key - 1).clamp(min=0).to(torch.int32).view(torch.float32))
    return torch.cat([m, torch.where(neg, -1.0, 1.0)])


@pytest.fixture(scope="module")
def graphs():
    return {"610": CodeGraphs.build(construct_code(*CODES["610"]))}


@pytest.mark.parametrize("last", [0, 1])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-G{c[2]}-g{c[3]}")
def test_state_rebuilds_the_step(graphs, case, last):
    code, side, G, g = case
    router = ShardRouter(getattr(graphs[code], side), G, g)
    syn, other, done, v = inputs(router, 100 + 10 * G + g)
    state, local = check_state(router, syn, other, v)
    e = rebuild_messages(router, state, ALPHA)
    want_e = sharded_step_cuda.check_messages(router, syn, other, v, ALPHA)
    assert_bits_equal(e, want_e)
    assert want_e.isnan().any() and (want_e == 0).any()
    vv = sharded_step_cuda.variable_sums(router, f32(LLR), bool(last), e)
    assert_bits_equal(vv, sharded_step_cuda.variable_update(
        router, f32(LLR), bool(last), syn, other, v, ALPHA))
    # the step: live lanes fold their partials, done lanes keep V and take
    # theirs from the local state
    v_new = torch.where(done[None, :], v, vv)
    part = torch.where(done[None, :], torch.cat(
        [local[0], torch.where(local[1], -1.0, 1.0)]),
        folded_partials(router, v_new))
    want_v, want_p = sharded_step_cuda.sharded_min_sum_step(
        router, LLR, last, syn, other, done, v, ALPHA)
    assert_bits_equal(v_new, want_v)
    assert_bits_equal(part, want_p)
    assert_bits_equal(part, sharded_step_cuda.local_partials(v_new, router.Lc))
    assert part[:router.B * router.P].isnan().any()


def test_plan_places_the_state():
    """The main path's shard ([[5210,521]] X and Z, G=2): 8 lanes of X's
    12-byte state fit an H100's CTA (25.0 KB a lane), Z's (31.3 KB a lane)
    at 4; 16 lanes go to the slab; folding adds 4 bytes per check."""
    g5210 = CodeGraphs.build(construct_code(*CODES["5210"]))
    x = ShardRouter(g5210.x, 2, 0)
    z = ShardRouter(g5210.z, 2, 1)
    assert sharded_step_cuda.state_bytes(x, 1, False) == 12 * x.B * x.P
    assert sharded_step_cuda.state_bytes(x, 1, True) == 16 * x.B * x.P
    px, pz = (sharded_step_cuda.plan(r, H100_SMEM) for r in (x, z))
    assert (px.lanes, px.slab_bytes) == (8, 0) and px.smem_bytes <= H100_SMEM
    assert (pz.lanes, pz.slab_bytes) == (4, 0) and pz.smem_bytes <= H100_SMEM
    # the fold's key fits beside Z's 4 lanes, not beside X's 8
    assert pz.fold and not px.fold
    assert px.threads == 1024 and px.threads % px.lanes == 0
    p16 = sharded_step_cuda.plan(x, H100_SMEM, lanes=16)
    assert p16.smem_bytes == 0
    assert p16.slab_bytes == sharded_step_cuda.state_bytes(x, 16, p16.fold)
    assert sharded_step_cuda.plan(x, H100_SMEM, lanes=4, fold=True).slab_bytes == 0
    with pytest.raises(ValueError):
        sharded_step_cuda.plan(x, H100_SMEM, lanes=6)


@pytest.mark.parametrize("limit", [16 * 1024, 48 * 1024, 100 * 1024, H100_SMEM])
def test_plan_follows_the_device_limit(limit):
    """A smaller limit gets fewer lanes per CTA with the state on chip; what
    stays on chip never exceeds the limit, and a state too large for one
    lane goes to the slab at the default lanes."""
    router = ShardRouter(CodeGraphs.build(construct_code(*CODES["5210"])).z, 2, 0)
    pl = sharded_step_cuda.plan(router, limit)
    one = sharded_step_cuda.state_bytes(router, 1, False)
    if one > limit:
        assert pl.lanes == sharded_step_cuda.DEFAULT_LANES and pl.smem_bytes == 0
        assert pl.slab_bytes == sharded_step_cuda.state_bytes(router, pl.lanes,
                                                              pl.fold)
    else:
        assert pl.slab_bytes == 0 and pl.smem_bytes <= limit
        assert (pl.lanes == sharded_step_cuda.DEFAULT_LANES
                or sharded_step_cuda.state_bytes(router, 2 * pl.lanes, False) > limit)
        if pl.fold:
            assert sharded_step_cuda.state_bytes(router, pl.lanes, True) <= limit
