"""What the layered kernel (csrc/layered_min_sum.cu) rests on, checked on the
CPU.

* r as a compressed check state.  The kernel keeps, per check, min1 and min2
  of |t| over the non-NaN edges, the argmin, the NaN count, the sign parity
  xor the syndrome, the index of a NaN edge and each edge's sign bit, and
  rebuilds r from them.  A torch emulation of the kernel's sweep (the first
  sweep taking t = q, every later one rebuilding the old r from the stored
  state) gives the plain ``layered.layered_sweep`` bit for bit: q after each
  sweep and every rebuilt r, from posteriors with planted +-0.0, NaN, +-inf
  and ties, and through a whole fixed-work decode whose posteriors saturate.
* ``layered_cuda.plan``, the owner of the launch shape and of a lane's
  placement: q and the state in shared memory while they fit in the
  device's limit, the rest in the lane's slab; one lane per CTA.
"""

import math

import numpy as np
import pytest
import torch

from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.codes import find_code_params
from qec_ldpc_tpu_torch.decoder import layered, min_sum
from qec_ldpc_tpu_torch.decoder.decode import CodeGraphs
from qec_ldpc_tpu_torch.decoder.layout import CirculantGraph
from qec_ldpc_tpu_torch.kernels import layered_cuda

#: the shared memory an H100's CTA may take with the opt-in (227 KB)
H100_SMEM = 232448
ALPHA = 0.75

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


def fold(ts, syn_bits):
    """The kernel's state of one layer's checks from their edges' t, edges
    in order l = 0 .. L-1: (m1, m2, arg, nans, neg, nan_at, signs)."""
    m1 = torch.full_like(ts[0], math.inf)
    m2 = torch.full_like(ts[0], math.inf)
    arg = torch.full(m1.shape, 31, dtype=torch.int32)
    nans = torch.zeros(m1.shape, dtype=torch.int32)
    nan_at = torch.zeros(m1.shape, dtype=torch.int32)
    signs = torch.zeros(m1.shape, dtype=torch.int32)
    neg = syn_bits.to(torch.bool)
    for l, x in enumerate(ts):
        a, isn = x.abs(), x.isnan()
        neg = neg ^ (x < 0)
        nans = nans + isn
        lt1 = ~isn & (a < m1)
        lt2 = ~isn & ~lt1 & (a < m2)
        m2 = torch.where(lt1, m1, torch.where(lt2, a, m2))
        m1 = torch.where(lt1, a, m1)
        arg = torch.where(lt1, l, arg)
        nan_at = torch.where(isn, l, nan_at)
        signs = signs | ((x < 0).to(torch.int32) << l)
    return m1, m2, arg, nans, neg, nan_at, signs


def message(state, l, own_nan, own_neg):
    """r of edge l from the state and the edge's own t's NaN-ness and sign
    (csrc/check_state.cuh::loo_message)."""
    m1, m2, arg, nans, neg, *_ = state
    loo = torch.where(arg == l, m2, m1)
    loo = torch.where(nans > own_nan.to(torch.int32), math.nan, loo)
    return torch.where(neg ^ own_neg, -ALPHA, ALPHA) * loo


def stored_message(state, l):
    """r of edge l from a stored state alone (the kernel's stored_message):
    the edge's own sign bit and whether it was the NaN edge."""
    nans, nan_at, signs = state[3], state[5], state[6]
    return message(state, l, (nans != 0) & (nan_at == l),
                   ((signs >> l) & 1).to(torch.bool))


def emulated_sweep(graph, q, states, syn):
    """One sweep as the kernel runs it; ``states`` None on the first sweep
    (r = 0), else the per-layer states of the sweep before.  Returns the
    new (q, states)."""
    B, L, P = graph.B, graph.L, graph.P
    rows = graph.index("var_of_edge", "cpu").view(B, L, P)
    q = q.clone()
    out = []
    for b in range(B):
        ts = []
        for l in range(L):
            qv = q[rows[b, l]]
            ts.append(qv if states is None
                      else qv - stored_message(states[b], l))
        st = fold(ts, syn[b * P:(b + 1) * P])
        for l in range(L):
            q[rows[b, l]] = ts[l] + message(st, l, ts[l].isnan(), ts[l] < 0)
        out.append(st)
    return q, out


def rebuilt_r(graph, states):
    """Every message r (num_edges, batch), check-indexed, from the states."""
    return torch.stack([torch.stack([stored_message(st, l)
                                     for l in range(graph.L)])
                        for st in states]).reshape(graph.num_edges, -1)


def assert_bits_equal(got, want):
    assert torch.equal(got.isnan(), want.isnan())
    keep = ~want.isnan()
    assert torch.equal(got.view(torch.int32)[keep], want.view(torch.int32)[keep])


def planted_posteriors(graph, batch, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((graph.num_vars, batch), generator=g) * 4
    q = torch.round(q * 2) / 2  # ties in |t|
    pick = torch.rand(q.shape, generator=g)
    for i, value in enumerate((0.0, -0.0, math.nan, math.inf, -math.inf, 1e38)):
        q[(pick >= 0.03 * i) & (pick < 0.03 * (i + 1))] = value
    return q


@pytest.mark.parametrize("table,P", [
    (np.array([[0, 1, 2], [0, 2, 4]]), 7),
    (np.array([[0, 1, 2, 3, 5, 8, 9, 11, 12, 13, 14, 15, 16, 17, 18, 19]]), 5),
    (np.array([[0], [3], [5]]), 11),
    (np.array([[0, 1, 3, 4], [0, 2, 5, 1], [0, 3, 2, 6]]), 7),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_compressed_state_gives_the_layered_sweep(table, P, seed):
    """Three sweeps from planted posteriors: q and every rebuilt r equal
    the plain sweep's, the first sweep's zero messages included."""
    graph = CirculantGraph.from_table(table, P)
    batch = 48
    q = planted_posteriors(graph, batch, seed)
    g = torch.Generator().manual_seed(seed + 10)
    syn = (torch.rand((graph.num_checks, batch), generator=g) < 0.4).to(torch.int32)
    syn_sign = 1.0 - 2.0 * syn.to(torch.float32)
    r = torch.zeros((graph.num_edges, batch))
    q_e, states = q, None
    nan_states = 0
    for _ in range(3):
        q, r = layered.layered_sweep(graph, q, r, syn_sign, ALPHA)
        q_e, states = emulated_sweep(graph, q_e, states, syn)
        assert_bits_equal(q_e, q)
        assert_bits_equal(rebuilt_r(graph, states), r)
        nan_states += sum(int((st[3] == 1).sum()) for st in states)
    assert nan_states > 0  # the single-NaN edge path was taken
    assert int(q.isnan().sum()) > 0


def test_first_sweep_keeps_the_sign_of_zero():
    """t = q on the first sweep: q = -0.0 stays -0.0 (q - (+0.0)), which
    -0.0 - (-0.0) = +0.0 would not; with every syndrome bit set the new
    messages are -0.0 and the posteriors stay -0.0."""
    graph = CirculantGraph.from_table(np.array([[0, 1], [0, 2]]), 3)
    q = torch.full((graph.num_vars, 1), -0.0)
    syn = torch.ones((graph.num_checks, 1), dtype=torch.int32)
    want, _ = layered.layered_sweep(graph, q, torch.zeros((graph.num_edges, 1)),
                                    1.0 - 2.0 * syn.to(torch.float32), ALPHA)
    got, _ = emulated_sweep(graph, q, None, syn)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool(torch.signbit(want).any())


@pytest.mark.parametrize("side", ["x", "z"])
def test_compressed_state_through_a_saturating_decode(side):
    """130 fixed sweeps of the [[42]] code on random syndromes, where the
    posteriors grow past float32 and become NaN (inf - inf): the
    emulation's posteriors equal ``layered_min_sum_run``'s along the way."""
    graphs = CodeGraphs.build(construct_code(3, 3, 6, 7, 2, 3))
    graph = getattr(graphs, side)
    g = torch.Generator().manual_seed(9)
    syn = (torch.rand((graph.num_checks, 32), generator=g) < 0.05).to(torch.int32)
    llr = min_sum.prior_llr(np.float32(2.0 / 3.0) * np.float32(0.01))
    q = torch.full((graph.num_vars, 32), min_sum.f32(llr))
    states = None
    for n in range(1, 131):
        q, states = emulated_sweep(graph, q, states, syn)
        if n in (1, 2, 5, 100, 130):
            want, _ = layered.layered_min_sum_run(graph, syn, llr, n, n + 1)
            assert_bits_equal(q, want)
    assert int(q.isnan().sum()) > 0


def aligned(n):
    return (n + 15) // 16 * 16


def lane_bytes(graph):
    return (aligned(graph.num_checks), aligned(4 * graph.num_vars),
            aligned(8 * graph.num_checks) + aligned(4 * graph.num_checks))


@pytest.fixture(scope="module")
def sizes():
    """Every circulant size the card checks K3 on: [[42]], [[610,61]], the
    P=521 codes, the P=1051 probe, and P=4201 (its state in the slab)."""
    out = {"42": CodeGraphs.build(construct_code(3, 3, 6, 7, 2, 3)),
           "610": CodeGraphs.build(construct_code(4, 5, 10, 61, 9, 49)),
           "521": CodeGraphs.build(construct_code(4, 5, 10, 521, 25, 1))}
    for P in (1051, 4201):
        s, t = find_code_params(4, 5, 10, P)[0]
        out[str(P)] = CodeGraphs.build(construct_code(4, 5, 10, P, s, t))
    return out


def test_plan_keeps_every_checked_size_on_chip(sizes):
    """[[42]], [[610,61]], P=521 and P=1051 hold q and the state in an H100's
    shared memory, one lane per CTA of one thread per row (P rounded up to a
    whole warp, at most 1024); P=4201 keeps q and puts the state in the
    lane's slab.  Every plan fits a CTA."""
    threads = {"42": 32, "610": 64, "521": 544, "1051": 1024, "4201": 1024}
    for name, graphs in sizes.items():
        for graph in (graphs.x, graphs.z):
            pl = layered_cuda.plan(graph, H100_SMEM)
            syn, q, state = lane_bytes(graph)
            assert pl.threads == threads[name]
            assert pl.smem_bytes <= H100_SMEM
            if name == "4201":
                assert pl.q_shared and not pl.state_shared
                assert pl.slab_floats * 4 == state
                assert pl.smem_bytes == syn + q
            else:
                assert (pl.q_shared, pl.state_shared, pl.slab_floats) == (True, True, 0)
                assert pl.smem_bytes == syn + q + state
    # [[610,61]]: 2.4 KB of q and 2.9 / 3.7 KB of state per lane
    x, z = sizes["610"].x, sizes["610"].z
    assert layered_cuda.plan(x, H100_SMEM).smem_bytes == 256 + 2448 + 2928
    assert layered_cuda.plan(z, H100_SMEM).smem_bytes == 320 + 2448 + 3680


@pytest.mark.parametrize("limit", [4 * 1024, 24 * 1024, 48 * 1024, H100_SMEM])
def test_plan_follows_the_device_limit(sizes, limit):
    """Less shared memory puts more of the lane in its slab: q, then the
    state, placed in order while they fit."""
    graph = sizes["521"].z
    syn, q, state = lane_bytes(graph)
    pl = layered_cuda.plan(graph, limit)
    assert pl.q_shared == (syn + q <= limit)
    assert pl.state_shared == (syn + q * pl.q_shared + state <= limit)
    assert pl.smem_bytes == syn + q * pl.q_shared + state * pl.state_shared
    assert pl.smem_bytes <= max(limit, syn)
    assert pl.slab_floats * 4 == q * (not pl.q_shared) + state * (not pl.state_shared)
