"""What the lifted min-sum kernel (csrc/lifted_min_sum.cu) rests on, checked
on the CPU.

* One iteration as the kernel computes it: the check phase keeps the
  min-sum kernels' compressed check state per check row (min1, min2, the
  argmin, the NaN count, the sign parity xor the syndrome), and the
  variable phase routes each variable's rank-i edge by the launcher's
  resolved rank table (shifts, edge row base eb*P, check row base
  (eb / Dc)*P, position eb % Dc, from ``launch.lifted_description``),
  rebuilds E from the state and the edge's own V, and sums in rank order.
  A torch emulation of that gives the plain check and variable updates
  (``min_sum.cn_update_min_sum`` then ``vn_update_llr``) bit for bit, on
  messages with planted +-0.0, NaN, +-inf and ties, the last iteration's
  full posterior included, on bicycle, hypergraph-product, toric and 1-D
  lifted graphs.
* The placement: the kernel takes ``placement.plan`` (one lane per CTA,
  V, state and damping in shared memory while they fit), at every lifted
  size the card checks: the gross code, toric d=32, [[756,16,34]], and the
  P=1051 and P=2081 circulant codes as lifted graphs (the first puts its
  check state in the lane's slab, the second its V: 416 KB).
"""

import math

import numpy as np
import pytest
import torch

from qec_ldpc_tpu_torch import codes
from qec_ldpc_tpu_torch.codes import find_code_params
from qec_ldpc_tpu_torch.decoder import min_sum
from qec_ldpc_tpu_torch.decoder.decode import CodeGraphs
from qec_ldpc_tpu_torch.decoder.lifted import LiftedGraph
from qec_ldpc_tpu_torch.kernels import launch, placement

#: the shared memory an H100's CTA may take with the opt-in (227 KB)
H100_SMEM = 232448
ALPHA = 0.75
LLR = min_sum.prior_llr(np.float32(2.0 / 3.0) * np.float32(0.01))

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


def check_state(graph, v, syndrome):
    """The kernel's check phase: per check row (cb, r), the state over its
    Dc edges (cb*Dc + d)*P + r in order d = 0 .. Dc-1."""
    t = v.reshape(graph.num_check_blocks, graph.check_degree, graph.P, -1)
    m1 = torch.full_like(t[:, 0], math.inf)
    m2 = torch.full_like(t[:, 0], math.inf)
    arg = torch.full(m1.shape, 31, dtype=torch.int32)
    nans = torch.zeros(m1.shape, dtype=torch.int32)
    neg = syndrome.reshape(m1.shape).to(torch.bool)
    for d in range(graph.check_degree):
        x = t[:, d]
        a, isn = x.abs(), x.isnan()
        neg = neg ^ (x < 0)
        nans = nans + isn
        lt1 = ~isn & (a < m1)
        lt2 = ~isn & ~lt1 & (a < m2)
        m2 = torch.where(lt1, m1, torch.where(lt2, a, m2))
        m1 = torch.where(lt1, a, m1)
        arg = torch.where(lt1, d, arg)
    return [x.reshape(graph.num_checks, -1) for x in (m1, m2, arg, nans, neg)]


def kernel_iteration(graph, v, syndrome, last):
    """One iteration as the kernel computes it (no damping): the check
    state, then the variable phase by the resolved rank table."""
    edges, ranks, l, m, C, V, Dc, Dv, E = launch.lifted_description(graph)
    table = np.ctypeslib.as_array(edges).reshape(E, 4)
    P = l * m
    m1, m2, arg, nans, neg = check_state(graph, v, syndrome)
    q = np.arange(P)
    q1, q2 = q // m, q % m
    v_new = torch.empty_like(v)
    for vb in range(V):
        rows, t = [], []
        for i in range(Dv):
            eb = ranks[i * V + vb]
            a, b = table[eb, 2], table[eb, 3]
            r = torch.from_numpy(((q1 - a) % l) * m + (q2 - b) % m)
            edge, c, d = eb * P + r, (eb // Dc) * P + r, eb % Dc
            own = v[edge]
            loo = torch.where(arg[c] == d, m2[c], m1[c])
            loo = torch.where(nans[c] > own.isnan().to(torch.int32), math.nan, loo)
            t.append(torch.where(neg[c] ^ (own < 0), -ALPHA, ALPHA) * loo)
            rows.append(edge)
        pre = [torch.zeros_like(t[0])]
        for i in range(1, Dv):
            pre.append(pre[-1] + t[i - 1])
        full = (pre[-1] + 0.0) + t[-1]
        suf = torch.zeros_like(t[0])
        for i in reversed(range(Dv)):
            v_new[rows[i]] = LLR + (full if last else pre[i] + suf)
            suf = suf + t[i]
    return v_new


def planted_messages(graph, batch, seed):
    g = torch.Generator().manual_seed(seed)
    v = torch.randn((graph.num_edges, batch), generator=g) * 4
    v = torch.round(v * 2) / 2  # ties in |V|
    pick = torch.rand(v.shape, generator=g)
    for i, value in enumerate((0.0, -0.0, math.nan, math.inf, -math.inf, 1e38)):
        v[(pick >= 0.03 * i) & (pick < 0.03 * (i + 1))] = value
    return v


GRAPHS = {
    "gross": lambda: codes.known_bicycle_code("[[144,12,12]]").build_graphs().x,
    "hgp": lambda: codes.hgp_code(7, 7, "1 + x + x3", "1 + y + y3").build_graphs().z,
    "toric": lambda: codes.toric_code(5).build_graphs().x,
    "one-dimensional": lambda: LiftedGraph.from_circulant(
        np.array([[1, 2, 4], [6, 5, 3]]), 7),
}


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("last", [False, True], ids=["loo", "last"])
def test_kernel_iteration_gives_the_plain_update(name, last):
    graph = GRAPHS[name]()
    batch = 24
    v = planted_messages(graph, batch, 3)
    g = torch.Generator().manual_seed(4)
    syn = (torch.rand((graph.num_checks, batch), generator=g) < 0.4).to(torch.int32)
    sign = graph.expand_checks(1.0 - 2.0 * syn.to(torch.float32))
    e = min_sum.cn_update_min_sum(graph, v, sign, ALPHA)
    want = min_sum.vn_update_llr(graph, e, LLR, last)
    got = kernel_iteration(graph, v, syn, last)
    assert torch.equal(got.isnan(), want.isnan())
    keep = ~want.isnan()
    assert torch.equal(got.view(torch.int32)[keep], want.view(torch.int32)[keep])
    assert int(want.isnan().sum()) > 0 and int(v.isinf().sum()) > 0


def test_kernel_iterations_through_a_decode():
    """Twenty iterations of a real gross-code decode, fed back each time."""
    graphs = codes.known_bicycle_code("[[144,12,12]]").build_graphs()
    g = torch.Generator().manual_seed(5)
    syn = (torch.rand((graphs.z.num_checks, 16), generator=g) < 0.1).to(torch.int32)
    sign = graphs.z.expand_checks(1.0 - 2.0 * syn.to(torch.float32))
    v = torch.full((graphs.z.num_edges, 16), min_sum.f32(LLR))
    for n in range(20):
        want = min_sum.vn_update_llr(
            graphs.z, min_sum.cn_update_min_sum(graphs.z, v, sign, ALPHA),
            LLR, n == 19)
        got = kernel_iteration(graphs.z, v, syn, n == 19)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        v = want


@pytest.fixture(scope="module")
def lifted_sizes():
    out = {
        "gross": codes.known_bicycle_code("[[144,12,12]]").build_graphs(),
        "toric32": codes.toric_code(32).build_graphs(),
        "756": codes.known_bicycle_code("[[756,16,34]]").build_graphs(),
    }
    for P in (1051, 2081):
        s, t = find_code_params(4, 5, 10, P)[0]
        z = CodeGraphs.build(codes.construct_code(4, 5, 10, P, s, t)).z
        out[f"lifted {P}"] = LiftedGraph.from_circulant(z.table, P)
    return out


def aligned(n):
    return (n + 15) // 16 * 16


def test_plan_places_every_lifted_size(lifted_sizes):
    """The gross code, toric d=32 and [[756,16,34]] hold every array in an
    H100's shared memory, damping included; the P=1051 circulant code as a
    lifted graph keeps V there (210 KB) and puts its state in the slab; the
    P=2081 one overflows 227 KB with V alone (416 KB) and puts V in the
    slab, its state on chip.  Every plan fits a CTA."""
    threads = {"gross": 128, "toric32": 1024, "756": 384}
    for name in ("gross", "toric32", "756"):
        for graph in (lifted_sizes[name].x, lifted_sizes[name].z):
            for damped in (False, True):
                pl = placement.plan(graph, damped, H100_SMEM)
                assert (pl.v_shared, pl.state_shared, pl.slab_floats) == (True, True, 0)
                assert pl.damping_shared == damped
                assert pl.threads == threads[name]
    gross = lifted_sizes["gross"].x
    assert placement.plan(gross, True, H100_SMEM).smem_bytes == (
        aligned(gross.num_checks) + 2 * aligned(4 * gross.num_edges)
        + aligned(8 * gross.num_checks) + aligned(4 * gross.num_checks))
    big = lifted_sizes["lifted 2081"]
    assert 4 * big.num_edges > H100_SMEM and big.num_edge_blocks <= 64
    pl = placement.plan(big, True, H100_SMEM)
    assert not pl.v_shared and pl.state_shared and not pl.damping_shared
    assert pl.slab_floats == 2 * aligned(4 * big.num_edges) // 4
    mid = lifted_sizes["lifted 1051"]
    pl = placement.plan(mid, False, H100_SMEM)
    assert pl.v_shared and not pl.state_shared
    for graph in lifted_sizes.values():
        for g in ((graph.x, graph.z) if hasattr(graph, "x") else (graph,)):
            pl = placement.plan(g, True, H100_SMEM)
            assert pl.smem_bytes <= H100_SMEM
            assert pl.threads % 32 == 0 and 128 <= pl.threads <= 1024


def test_limits_take_the_large_lifts(lifted_sizes):
    """The lifted kernels' description takes both circulant probes as
    lifted graphs (50 edge blocks, check degree 10, variable degree 5)."""
    for name in ("lifted 1051", "lifted 2081"):
        g = lifted_sizes[name]
        syn = torch.zeros((g.num_checks, 2), dtype=torch.int32)
        with pytest.raises(ValueError, match="unsupported device"):
            launch.check_lifted_cuda_args(g, syn)
        assert (g.num_edge_blocks, g.check_degree, g.var_degree) == (50, 10, 5)
