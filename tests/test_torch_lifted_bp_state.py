"""What the lifted sum-product kernel (csrc/lifted_bp.cu) rests on, checked
on the CPU.

* ``sum_product.bp_run_lanes`` on a ``LiftedGraph``, the per-lane reference
  the card holds the kernel's ``iters`` to: its messages are JAX
  ``bp_run``'s on the batch, bit for bit, and each lane's count is JAX
  ``bp_run``'s count for that lane decoded alone (the batch count their
  maximum), early exit and fixed work, on the gross code, a small toric
  code and a hypergraph-product code.  The same NumPy syndromes feed both
  packages.
* One iteration as the kernel computes it: the check phase writes each
  edge's exclusive prefix product into E and forms E in place on the way
  back; the variable phase routes each variable's rank-i edge by the
  launcher's resolved rank table (shifts and edge row base, from
  ``launch.lifted_description``) and takes products in rank order.  A torch
  emulation of that gives the plain ``sum_product.cn_update`` then
  ``vn_update`` bit for bit, on messages with planted 0, 1, 0.5 and
  denormals, the last iteration's full posterior included.
* The placement: the kernel takes ``placement.bp_plan`` (K1's plan), at
  every lifted size the card checks: the gross code, toric d=32 and
  [[756,16,34]] on chip, the P=1051 circulant code as a lifted graph with
  its E in the lane's slab and the P=2081 one with V and E there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qec_ldpc_tpu import codes as jax_codes
from qec_ldpc_tpu.decoder import bp_run as jax_bp_run
from qec_ldpc_tpu_torch import codes
from qec_ldpc_tpu_torch.codes import find_code_params
from qec_ldpc_tpu_torch.decoder import sum_product
from qec_ldpc_tpu_torch.decoder.decode import CodeGraphs
from qec_ldpc_tpu_torch.decoder.lifted import LiftedGraph
from qec_ldpc_tpu_torch.kernels import launch, placement

#: the shared memory an H100's CTA may take with the opt-in (227 KB)
H100_SMEM = 232448
PRIOR = np.float32(2.0 / 3.0) * np.float32(0.03)
LANES_ALONE = 5

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

CODES = {
    "gross": lambda c: c.known_bicycle_code("[[144,12,12]]"),
    "toric4": lambda c: c.toric_code(4),
    "hgp7": lambda c: c.hgp_code(7, 7, "1 + x + x3", "1 + y + y3"),
}


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
    """JAX's and the port's graph of one sector, and syndromes of NumPy
    depolarizing draws at rates that spread the lanes' convergence."""
    name, side = request.param
    jcode = CODES[name](jax_codes)
    jg = getattr(jcode.build_graphs(), side)
    tg = getattr(CODES[name](codes).build_graphs(), side)
    rng = np.random.default_rng(23)
    batch = 24
    p = np.linspace(0.005, 0.08, batch)
    e = (rng.random((jcode.n, batch)) < p).astype(np.int32)
    syn = np.array(jax.jit(jg.syndrome)(jnp.asarray(e)))
    return jg, tg, syn


@pytest.mark.parametrize("max_iters,check_every", [(100, 10), (40, 1), (7, 8)],
                         ids=["early-exit", "early-exit-1", "fixed-7"])
def test_lane_iters_equal_jax_on_each_lane_alone(case, max_iters, check_every):
    jg, tg, syn = case
    v_l, lanes = sum_product.bp_run_lanes(tg, torch.from_numpy(syn),
                                          torch.tensor(PRIOR), max_iters,
                                          check_every)
    v_j, n_j = jax_bp_run(jg, jnp.asarray(syn), jnp.float32(PRIOR),
                          max_iters=max_iters, check_every=check_every)
    assert_bits_equal(v_l.numpy(), v_j)
    assert lanes.dtype == torch.int32 and lanes.shape == (syn.shape[1],)
    assert int(lanes.max()) == int(n_j)
    for i in range(LANES_ALONE):
        lane = (i * syn.shape[1]) // LANES_ALONE
        v_a, n_alone = jax_bp_run(jg, jnp.asarray(syn[:, lane:lane + 1]),
                                  jnp.float32(PRIOR), max_iters=max_iters,
                                  check_every=check_every)
        assert int(lanes[lane]) == int(n_alone)
        assert_bits_equal(v_l.numpy()[:, lane:lane + 1], v_a)
    if check_every > max_iters:  # only the test at n = 0 can stop a lane
        assert set(lanes.tolist()) <= {1, max_iters}


# -- the kernel's iteration ---------------------------------------------------


def kernel_iteration(graph, v, syndrome, prior, last):
    """One iteration as the kernel computes it: the check phase with the
    prefix products stored in E and the backward pass in place, then the
    variable phase by the resolved rank table."""
    edges, ranks, l, m, C, V, Dc, Dv, E = launch.lifted_description(graph)
    table = np.ctypeslib.as_array(edges).reshape(E, 4)
    P = l * m
    # check phase: check row (cb, r) owns edges (cb*Dc + d)*P + r
    vv = v.reshape(C, Dc, P, -1)
    e = torch.empty_like(vv)
    sgn = torch.where(syndrome.reshape(C, P, -1) != 0, -0.5, 0.5)
    pre = torch.ones_like(vv[:, 0])
    for d in range(Dc):
        e[:, d] = pre
        pre = pre * (1.0 - 2.0 * vv[:, d])
    suf = torch.ones_like(pre)
    for d in reversed(range(Dc)):
        t = 1.0 - 2.0 * vv[:, d]
        e[:, d] = 0.5 - sgn * (e[:, d] * suf)
        suf = suf * t
    e = e.reshape(v.shape)
    # variable phase: var (vb, q1, q2)'s rank-i edge is check lane
    # ((q1 - a) mod l, (q2 - b) mod m) of edge block ranks[i*V + vb]
    q = np.arange(P)
    q1, q2 = q // m, q % m
    prior = torch.tensor(prior)
    v_new = torch.empty_like(v)
    for vb in range(V):
        rows, ep, em = [], [], []
        for i in range(Dv):
            eb = ranks[i * V + vb]
            a, b = table[eb, 2], table[eb, 3]
            r = torch.from_numpy(((q1 - a) % l) * m + (q2 - b) % m)
            rows.append(eb * P + r)
            ep.append(e[rows[-1]])
            em.append(1.0 - ep[-1])
        pre_p, pre_m = [torch.ones_like(ep[0])], [torch.ones_like(ep[0])]
        for i in range(1, Dv):
            pre_p.append(pre_p[-1] * ep[i - 1])
            pre_m.append(pre_m[-1] * em[i - 1])
        full_p, full_m = pre_p[-1] * ep[-1], pre_m[-1] * em[-1]
        suf_p, suf_m = torch.ones_like(ep[0]), torch.ones_like(ep[0])
        for i in reversed(range(Dv)):
            prod_p = full_p if last else pre_p[i] * suf_p
            prod_m = full_m if last else pre_m[i] * suf_m
            num = prior * prod_p
            den = sum_product.fma_f32(1.0 - prior, prod_m, num)
            v_new[rows[i]] = num / den
            suf_p = suf_p * ep[i]
            suf_m = suf_m * em[i]
    return v_new


def planted_messages(graph, batch, seed):
    """Probabilities with planted 0, 1, 0.5 and denormals, and check rows
    whose every edge holds 0 or 1 (their E is exactly 0 or 1, and a
    variable that meets both gets 0/0)."""
    g = torch.Generator().manual_seed(seed)
    v = torch.rand((graph.num_edges, batch), generator=g)
    pick = torch.rand(v.shape, generator=g)
    for i, value in enumerate((0.0, 1.0, 0.5, 1e-40, 1 - 2 ** -24)):
        v[(pick >= 0.04 * i) & (pick < 0.04 * (i + 1))] = value
    rows = graph.cn_view(v)  # (C, Dc, P*batch), a view of v
    hard = torch.rand(rows[:, 0].shape, generator=g) < 0.3
    bits = (torch.rand(rows.shape, generator=g) < 0.5).to(v.dtype)
    rows.copy_(torch.where(hard[:, None], bits, rows))
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
    sign = graph.expand_checks(0.5 - syn.to(torch.float32))
    want = sum_product.vn_update(graph, sum_product.cn_update(graph, v, sign),
                                 torch.tensor(PRIOR), last)
    got = kernel_iteration(graph, v, syn, PRIOR, last)
    assert_bits_equal(got.numpy(), want.numpy())
    if last or graph.var_degree > 2:  # 0/0 where E = 0 and E = 1 meet
        assert int(want.isnan().sum()) > 0
    assert int(((v > 0) & (v < 2 ** -126)).sum()) > 0  # denormals in


def test_kernel_iterations_through_a_decode():
    """Twenty iterations of a real gross-code decode, fed back each time."""
    graphs = codes.known_bicycle_code("[[144,12,12]]").build_graphs()
    g = torch.Generator().manual_seed(5)
    syn = (torch.rand((graphs.z.num_checks, 16), generator=g) < 0.1).to(torch.int32)
    sign = graphs.z.expand_checks(0.5 - syn.to(torch.float32))
    v = torch.full((graphs.z.num_edges, 16), float(PRIOR))
    for n in range(20):
        want = sum_product.vn_update(
            graphs.z, sum_product.cn_update(graphs.z, v, sign),
            torch.tensor(PRIOR), n == 19)
        got = kernel_iteration(graphs.z, v, syn, PRIOR, n == 19)
        assert_bits_equal(got.numpy(), want.numpy())
        v = want


# -- the placement ------------------------------------------------------------


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
    """The gross code (1.7 KB each of V and E), [[756,16,34]] (9 KB) and
    toric d=32 (16 KB) hold a lane in an H100's shared memory; the P=1051
    circulant code as a lifted graph keeps V there (210 KB) and puts E in
    the slab; the P=2081 one (416 KB each) puts both in the slab."""
    sizes = {"gross": (1728, 128), "756": (9072, 384), "toric32": (16384, 1024)}
    for name, (msg_bytes, threads) in sizes.items():
        for graph in (lifted_sizes[name].x, lifted_sizes[name].z):
            assert 4 * graph.num_edges == msg_bytes
            pl = placement.bp_plan(graph, H100_SMEM)
            assert (pl.v_shared, pl.e_shared, pl.slab_floats) == (True, True, 0)
            assert pl.smem_bytes == aligned(graph.num_checks) + 2 * aligned(msg_bytes)
            assert pl.threads == threads
    mid = lifted_sizes["lifted 1051"]
    assert 4 * mid.num_edges == 210200
    pl = placement.bp_plan(mid, H100_SMEM)
    assert pl.v_shared and not pl.e_shared
    assert pl.slab_floats == aligned(4 * mid.num_edges) // 4
    big = lifted_sizes["lifted 2081"]
    assert 4 * big.num_edges == 416200 and big.num_edge_blocks <= 64
    pl = placement.bp_plan(big, H100_SMEM)
    assert not pl.v_shared and not pl.e_shared
    assert pl.slab_floats == 2 * aligned(4 * big.num_edges) // 4
    for graph in lifted_sizes.values():
        for g in ((graph.x, graph.z) if hasattr(graph, "x") else (graph,)):
            pl = placement.bp_plan(g, H100_SMEM)
            assert pl.smem_bytes <= H100_SMEM
            assert pl.threads % 32 == 0 and 128 <= pl.threads <= 1024
