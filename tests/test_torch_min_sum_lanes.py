"""What the min-sum kernel (csrc/min_sum.cu) rests on, checked on the CPU.

* ``min_sum.min_sum_run_lanes``, the per-lane iteration reference the card
  tests hold the kernel's ``iters`` to: each lane's count equals the plain
  ``min_sum_run`` on that lane alone, and their maximum is the batch run's
  count, damped and undamped; its messages are ``min_sum_run``'s.
* The kernel's compressed check state: per check, min1 and min2 of |V| over
  the non-NaN edges, the argmin, the NaN count and the sign parity xor the
  syndrome.  A torch emulation of the kernel's check phase and of the
  variable phase's rebuild of each E gives the plain check-node update bit
  for bit, on messages with planted +-0.0, NaN, +-inf and ties.
"""

import math

import numpy as np
import pytest
import torch

from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.decoder import min_sum
from qec_ldpc_tpu_torch.decoder.decode import CodeGraphs
from qec_ldpc_tpu_torch.decoder.layout import CirculantGraph

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

LLR = min_sum.prior_llr(np.float32(2.0 / 3.0) * np.float32(0.02))


@pytest.fixture(scope="module")
def g42():
    return CodeGraphs.build(construct_code(3, 3, 6, 7, 2, 3))


def relay_shaped(graph, n, batch, seed, heavy=6, weight=4):
    """Mostly zero syndromes (solved lanes) and ``heavy`` lanes with a
    weight-``weight`` error: the shape of a relay retry."""
    rng = np.random.default_rng(seed)
    e = np.zeros((n, batch), np.int32)
    for lane in rng.choice(batch, heavy, replace=False):
        e[rng.choice(n, weight, replace=False), lane] = 1
    for lane in range(batch):  # and some light lanes
        if rng.random() < 0.3:
            e[rng.integers(n), lane] = 1
    return graph.syndrome(torch.from_numpy(e))


def gammas(graph, batch, seed):
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((graph.num_vars, batch), generator=g)
    return graph.expand_vars(u * 0.95 + 0.05).contiguous()


@pytest.mark.parametrize("damped", [False, True], ids=["undamped", "damped"])
@pytest.mark.parametrize("max_iters,check_every", [(30, 1), (40, 5), (12, 13)])
def test_lane_iters_equal_each_lane_alone(g42, damped, max_iters, check_every):
    for graph in (g42.x, g42.z):
        syn = relay_shaped(graph, g42.code.n, 24, seed=max_iters)
        damping = gammas(graph, 24, 5) if damped else None
        v_l, lanes = min_sum.min_sum_run_lanes(graph, syn, LLR, max_iters,
                                               check_every, damping=damping)
        v, n = min_sum.min_sum_run(graph, syn, LLR, max_iters, check_every,
                                   damping=damping)
        assert torch.equal(v_l.view(torch.int32), v.view(torch.int32))
        assert lanes.dtype == torch.int32 and lanes.shape == (24,)
        alone = [int(min_sum.min_sum_run(
            graph, syn[:, i:i + 1], LLR, max_iters, check_every,
            damping=None if damping is None else damping[:, i:i + 1])[1])
            for i in range(24)]
        assert lanes.tolist() == alone
        assert int(lanes.max()) == int(n)
        if check_every < max_iters:
            assert len(set(alone)) > 1  # the lanes really differ


def compressed_check_update(graph, v, syndrome, alpha):
    """The kernel's check phase (compressed state per check, edges walked in
    order l = 0 .. L-1) and the variable phase's rebuild of E, in torch."""
    alpha = min_sum.f32(alpha)
    t = graph.cn_view(v)                                  # (B, L, P*batch)
    neg = syndrome.reshape(graph.B, -1).to(torch.bool)    # (B, P*batch)
    m1 = torch.full_like(t[:, 0], math.inf)
    m2 = torch.full_like(t[:, 0], math.inf)
    arg = torch.full(m1.shape, 31, dtype=torch.int32)
    nans = torch.zeros(m1.shape, dtype=torch.int32)
    for l in range(graph.L):
        x = t[:, l]
        a, isn = x.abs(), x.isnan()
        neg = neg ^ (x < 0)
        nans = nans + isn
        lt1 = ~isn & (a < m1)
        lt2 = ~isn & ~lt1 & (a < m2)
        m2 = torch.where(lt1, m1, torch.where(lt2, a, m2))
        m1 = torch.where(lt1, a, m1)
        arg = torch.where(lt1, l, arg)
    out = []
    for l in range(graph.L):
        x = t[:, l]
        loo = torch.where(arg == l, m2, m1)
        loo = torch.where(nans > x.isnan().to(torch.int32), math.nan, loo)
        out.append(torch.where(neg ^ (x < 0), -alpha, alpha) * loo)
    return torch.stack(out, dim=1).reshape(v.shape)


def planted_messages(graph, batch, seed):
    g = torch.Generator().manual_seed(seed)
    v = torch.randn((graph.num_edges, batch), generator=g) * 4
    v = torch.round(v * 2) / 2  # ties in |V|
    pick = torch.rand(v.shape, generator=g)
    for i, value in enumerate((0.0, -0.0, math.nan, math.inf, -math.inf, 1e38)):
        v[(pick >= 0.04 * i) & (pick < 0.04 * (i + 1))] = value
    return v


@pytest.mark.parametrize("table,P", [
    (np.array([[0, 1, 2], [0, 2, 4]]), 7),
    (np.array([[0, 1, 2, 3, 5, 8, 9, 11, 12, 13, 14, 15, 16, 17, 18, 19]]), 5),
    (np.array([[0], [3], [5]]), 11),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_compressed_state_gives_the_check_update(table, P, seed):
    graph = CirculantGraph.from_table(table, P)
    batch = 64
    v = planted_messages(graph, batch, seed)
    g = torch.Generator().manual_seed(seed + 10)
    syn = (torch.rand((graph.num_checks, batch), generator=g) < 0.4).to(torch.int32)
    sign = graph.expand_checks(1.0 - 2.0 * syn.to(torch.float32))
    want = min_sum.cn_update_min_sum(graph, v, sign, 0.75)
    got = compressed_check_update(graph, v, syn, 0.75)
    assert torch.equal(got.isnan(), want.isnan())
    # NaN leave-one-out minima need a second edge; L = 1 gives inf
    assert int((want.isinf() if graph.L == 1 else want.isnan()).sum()) > 0
    keep = ~want.isnan()
    assert torch.equal(got.view(torch.int32)[keep], want.view(torch.int32)[keep])


def test_compressed_state_on_real_messages(g42):
    """Messages of a real decode (saturated to inf at 100 iterations)."""
    syn = relay_shaped(g42.z, g42.code.n, 32, seed=9, heavy=20)
    v, _ = min_sum.min_sum_run(g42.z, syn, LLR, 100, 101)
    sign = g42.z.expand_checks(1.0 - 2.0 * syn.to(torch.float32))
    want = min_sum.cn_update_min_sum(g42.z, v, sign, 0.75)
    got = compressed_check_update(g42.z, v, syn, 0.75)
    assert torch.equal(got.isnan(), want.isnan())
    keep = ~want.isnan()
    assert torch.equal(got.view(torch.int32)[keep], want.view(torch.int32)[keep])
