"""The lifted-graph kernel wrappers: K5 (kernels/lifted_min_sum_cuda.py,
csrc/lifted_min_sum.cu) and K6 (kernels/lifted_bp_cuda.py, csrc/lifted_bp.cu).

On a machine without a GPU the wrappers must import (no nvcc needed), be
reached from ``min_sum_cuda.min_sum_run`` and ``bp_cuda.bp_run`` for every
``LiftedGraph`` (a large toric code included, which must not take the
circulant wide route), send CPU tensors to the plain version without
counting a launch, and describe the graph as the sources expect.  The
kernels are compared with their plain versions bit for bit by the
``cuda``-marked tests, which run only where there is a card.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from qec_ldpc_tpu_torch import codes
from qec_ldpc_tpu_torch.decoder import min_sum, sum_product
from qec_ldpc_tpu_torch.decoder.decode import CodeGraphs
from qec_ldpc_tpu_torch.decoder.lifted import LiftedGraph
from qec_ldpc_tpu_torch.kernels import (
    bp_cuda,
    build,
    launch,
    layered_cuda,
    lifted_bp_cuda,
    lifted_min_sum_cuda,
    min_sum_cuda,
    placement,
)
from qec_ldpc_tpu_torch.parallel.chunk import chunk_generator
from qec_ldpc_tpu_torch.sampling.errors import sample_depolarizing_errors

PRIOR = np.float32(2.0 / 3.0) * np.float32(0.01)
LLR = min_sum.prior_llr(PRIOR)

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


def syndrome(graph, n, p, batch, device, seed=3):
    xe, _ = sample_depolarizing_errors(chunk_generator(seed, 0, device), n, p,
                                       batch)
    return graph.syndrome(xe.to(torch.int32))


def gammas(graph, batch, device, seed=4):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    u = torch.rand((graph.num_vars, batch), generator=g, device=device)
    return graph.expand_vars(u * 0.95 + 0.05).contiguous()


def assert_same(v, v_p):
    assert torch.equal(v.isnan(), v_p.isnan())
    finite = ~v.isnan()
    assert torch.equal(v.view(torch.int32)[finite], v_p.view(torch.int32)[finite])


def counts():
    return (lifted_min_sum_cuda.launches, lifted_bp_cuda.launches,
            min_sum_cuda.launches, min_sum_cuda.wide_launches,
            bp_cuda.launches)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("build_code", [
    lambda: codes.known_bicycle_code("[[144,12,12]]"),
    lambda: codes.toric_code(28),
], ids=["gross", "toric28"])
def test_cpu_tensors_route_to_plain_lifted_path(build_code, monkeypatch):
    """Lifted graphs reach the lifted wrappers, before the large-P test
    (toric d=28 has P = 784 >= WIDE_MIN_P), and run the plain version on
    the CPU without counting a launch."""
    graphs = build_code().build_graphs()
    g = graphs.x
    syn = syndrome(g, graphs.code.n, 0.02, 16, "cpu")
    seen = []

    def spy(module, name):
        real = getattr(module, name)

        def wrapped(*args, **kwargs):
            seen.append(name)
            return real(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)

    spy(lifted_min_sum_cuda, "lifted_min_sum_run")
    spy(lifted_bp_cuda, "lifted_bp_run")
    monkeypatch.setattr(min_sum_cuda, "min_sum_run_wide", None)
    before = counts()
    damping = gammas(g, 16, "cpu")
    v, iters = min_sum_cuda.min_sum_run(g, syn, LLR, 12, 5, damping=damping)
    v_p, n_p = min_sum.min_sum_run(g, syn, LLR, 12, 5, damping=damping)
    assert_same(v, v_p)
    assert iters.shape == (16,) and bool((iters == n_p).all())
    v, iters = bp_cuda.bp_run(g, syn, PRIOR, 12, 5)
    v_p, n_p = sum_product.bp_run(g, syn, torch.tensor(PRIOR), 12, 5)
    assert_same(v, v_p)
    assert iters.dtype == torch.int32 and bool((iters == n_p).all())
    assert seen == ["lifted_min_sum_run", "lifted_bp_run"]
    assert counts() == before


def test_layered_wrapper_rejects_lifted_graphs():
    g = codes.toric_code(3).build_graphs().x
    syn = torch.zeros((g.num_checks, 4), dtype=torch.int32)
    with pytest.raises(TypeError, match="CirculantGraph"):
        layered_cuda.layered_run(g, syn, LLR, 5)


@pytest.mark.parametrize("module,source", [
    (lifted_min_sum_cuda, "lifted_min_sum.cu"), (lifted_bp_cuda, "lifted_bp.cu")])
def test_limits_match_source(module, source):
    """Both lifted kernels take their limits from the one shared header."""
    assert module.SOURCES == (source,)
    assert '#include "lifted.cuh"' in (build.CSRC_DIR / source).read_text()
    src = (build.CSRC_DIR / "lifted.cuh").read_text()
    assert f"constexpr int kMaxEdgeBlocks = {launch.LIFTED_MAX_EDGE_BLOCKS};" in src
    assert f"constexpr int kMaxDc = {launch.LIFTED_MAX_CHECK_DEGREE};" in src
    assert f"constexpr int kMaxDv = {launch.LIFTED_MAX_VAR_DEGREE};" in src


def test_library_name_keys_on_shared_header(monkeypatch, tmp_path):
    """An edit to csrc/lifted.cuh rebuilds the libraries that include it."""
    for f in build.CSRC_DIR.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    before = build.library_path("qec_lifted_bp", lifted_bp_cuda.SOURCES)
    with open(tmp_path / "lifted.cuh", "a") as f:
        f.write("// edited\n")
    assert build.library_path("qec_lifted_bp", lifted_bp_cuda.SOURCES) != before


def test_every_kernel_builds_its_own_library():
    libraries = [("qec_bp", bp_cuda.SOURCES), ("qec_min_sum", min_sum_cuda.SOURCES),
                 ("qec_layered", layered_cuda.SOURCES),
                 ("qec_lifted_min_sum", lifted_min_sum_cuda.SOURCES),
                 ("qec_lifted_bp", lifted_bp_cuda.SOURCES)]
    assert len({build.library_path(*lib) for lib in libraries}) == 5


@pytest.mark.parametrize("build_graph,want_lm", [
    (lambda: codes.known_bicycle_code("[[144,12,12]]").build_graphs().x, (12, 6)),
    (lambda: codes.hgp_code(7, 7, "1 + x + x3", "1 + y + y3").build_graphs().z, (7, 7)),
    (lambda: LiftedGraph.from_circulant(np.array([[1, 2, 4], [6, 5, 3]]), 7), (7, 1)),
], ids=["gross", "hgp", "one-dimensional"])
def test_lifted_description(build_graph, want_lm):
    """Shifts normalised into [0, l) x [0, m) (HGP's are negative before
    normalisation), a 1-D group as (P, 1), and a rank table that walks each
    var block's edges in check-major order."""
    g = build_graph()
    edges, ranks, l, m, C, V, Dc, Dv, E = launch.lifted_description(g)
    assert (l, m) == want_lm and l * m == g.P
    assert (C, V, Dc, Dv, E) == (g.num_check_blocks, g.num_var_blocks,
                                 g.check_degree, g.var_degree, g.num_edge_blocks)
    table = np.ctypeslib.as_array(edges).reshape(E, 4)
    assert isinstance(ranks, ctypes.Array) and list(ranks) == list(g._var_rank_edges)
    assert (table[:, 0] == np.arange(E) // Dc).all()
    assert (table[:, 1] == np.asarray(g.var_blocks)).all()
    assert ((0 <= table[:, 2]) & (table[:, 2] < l)).all()
    assert ((0 <= table[:, 3]) & (table[:, 3] < m)).all()
    # the kernel's index arithmetic reproduces the graph's routing index
    P = g.P
    for e, (_, v, a, b) in enumerate(table):
        q = g.lanes(g.shifts[e])                 # var lane of check lane r
        r = ((q // m - a) % l) * m + (q % m - b) % m
        np.testing.assert_array_equal(r, np.arange(P))
        assert (g.index("var_of_edge", "cpu")[e * P:(e + 1) * P].numpy()
                == v * P + q).all()


def test_limits_raise_before_launch():
    big = LiftedGraph.build(1, 1, 5, [(0, 0, s) for s in range(9)])  # Dv = 9
    syn = torch.zeros((big.num_checks, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="exceeds the kernel's"):
        launch.check_lifted_cuda_args(big, syn.to("meta"))


# -- on the card -----------------------------------------------------------------


def compare_on_cuda(graph, syn, max_iters, check_every, damping=None):
    """K5 and, undamped, K6 against their plain versions: each lane's
    ``iters`` the plain count of that lane alone."""
    before = counts()
    v, iters = min_sum_cuda.min_sum_run(graph, syn, LLR, max_iters,
                                        check_every, damping=damping)
    v_p, lanes_p = min_sum.min_sum_run_lanes(graph, syn, LLR, max_iters,
                                             check_every, damping=damping)
    torch.cuda.synchronize()
    assert_same(v, v_p)
    assert torch.equal(iters, lanes_p)
    if damping is None:
        b, it_b = bp_cuda.bp_run(graph, syn, PRIOR, max_iters, check_every)
        b_p, lanes_b = sum_product.bp_run_lanes(
            graph, syn, torch.tensor(PRIOR, device=syn.device), max_iters,
            check_every)
        torch.cuda.synchronize()
        assert_same(b, b_p)
        assert torch.equal(it_b, lanes_b)
    after = counts()
    assert after[0] == before[0] + 1
    assert after[1] == before[1] + (damping is None)
    assert after[2:] == before[2:]  # no circulant route, not even the wide one


@pytest.mark.cuda
@pytest.mark.parametrize("name,p,max_iters,check_every,damped", [
    ("[[144,12,12]]", 0.01, 100, 10, False),
    ("[[144,12,12]]", 0.03, 100, 101, False),
    ("[[144,12,12]]", 0.03, 100, 10, True),
    ("[[90,8,10]]", 0.03, 50, 10, False),
    ("[[756,16,34]]", 0.03, 20, 21, False),
])
def test_bicycle_kernels_match_plain_on_cuda(cuda_device, name, p, max_iters,
                                             check_every, damped):
    graphs = codes.known_bicycle_code(name).build_graphs()
    for graph in (graphs.x, graphs.z):
        syn = syndrome(graph, graphs.code.n, p, 1000, cuda_device)
        damping = gammas(graph, 1000, cuda_device) if damped else None
        compare_on_cuda(graph, syn, max_iters, check_every, damping)


@pytest.mark.cuda
@pytest.mark.parametrize("build_code", [
    lambda: codes.toric_code(32),
    lambda: codes.hgp_code(7, 7, "1 + x + x3", "1 + y + y3"),
], ids=["toric32", "hgp7"])
def test_hypergraph_kernels_match_plain_on_cuda(cuda_device, build_code):
    graphs = build_code().build_graphs()
    for graph in (graphs.x, graphs.z):
        syn = syndrome(graph, graphs.code.n, 0.05, 256, cuda_device)
        compare_on_cuda(graph, syn, 20, 21)
        compare_on_cuda(graph, syn, 100, 10)


@pytest.mark.cuda
def test_one_dimensional_group_matches_circulant_kernel(cuda_device):
    """``LiftedGraph.from_circulant`` of [[610,61]] through K5/K6 equals the
    circulant kernels K2/K1 bit for bit.  All four count each lane's own
    iterations: K5's counts equal K2's, and K6's K1's."""
    code = codes.construct_code(4, 5, 10, 61, 9, 49)
    cg = CodeGraphs.build(code).x
    lg = LiftedGraph.from_circulant(cg.table, cg.P)
    xe, _ = sample_depolarizing_errors(chunk_generator(6, 0, cuda_device),
                                       code.n, 0.02, 512)
    syn = cg.syndrome(xe.to(torch.int32))
    for run, arg in ((min_sum_cuda.min_sum_run, LLR), (bp_cuda.bp_run, PRIOR)):
        v_c, it_c = run(cg, syn, arg, 60, 10)
        v_l, it_l = run(lg, syn, arg, 60, 10)
        torch.cuda.synchronize()
        assert_same(v_l, v_c)
        assert torch.equal(it_l, it_c)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1051, 2081])
@pytest.mark.parametrize("damped", [False, True], ids=["undamped", "damped"])
def test_large_lift_slab_on_cuda(cuda_device, P, damped):
    """The probe codes' Z graphs as lifted graphs: at P=1051 K5's check
    state (and damping) in the lane's slab, at P=2081 its V (416 KB)."""
    s, t = codes.find_code_params(4, 5, 10, P)[0]
    z = CodeGraphs.build(codes.construct_code(4, 5, 10, P, s, t)).z
    graph = LiftedGraph.from_circulant(z.table, P)
    pl = placement.plan(graph, damped,
                           placement.smem_optin(cuda_device.index))
    assert pl.slab_floats > 0 and pl.v_shared == (P == 1051)
    g = torch.Generator(device=cuda_device)
    g.manual_seed(P)
    syn = (torch.rand((graph.num_checks, 64), generator=g, device=cuda_device)
           < 0.02).to(torch.int32)
    damping = gammas(graph, 64, cuda_device) if damped else None
    before = lifted_min_sum_cuda.launches
    for max_iters, check_every in ((20, 21), (60, 10)):
        v, iters = min_sum_cuda.min_sum_run(graph, syn, LLR, max_iters,
                                            check_every, damping=damping)
        v_p, lanes_p = min_sum.min_sum_run_lanes(graph, syn, LLR, max_iters,
                                                 check_every, damping=damping)
        torch.cuda.synchronize()
        assert_same(v, v_p)
        assert torch.equal(iters, lanes_p)
    assert lifted_min_sum_cuda.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1051, 2081])
def test_large_lift_slab_sum_product_on_cuda(cuda_device, P):
    """K6 on the probe codes' Z graphs as lifted graphs: at P=1051 its E in
    the lane's slab (V on chip, 210 KB), at P=2081 V and E (416 KB each)."""
    s, t = codes.find_code_params(4, 5, 10, P)[0]
    z = CodeGraphs.build(codes.construct_code(4, 5, 10, P, s, t)).z
    graph = LiftedGraph.from_circulant(z.table, P)
    pl = placement.bp_plan(graph, placement.smem_optin(cuda_device.index))
    assert pl.slab_floats > 0 and not pl.e_shared and pl.v_shared == (P == 1051)
    g = torch.Generator(device=cuda_device)
    g.manual_seed(P + 1)
    errors = torch.rand((graph.num_vars, 64), generator=g, device=cuda_device)
    syn = graph.syndrome((errors < 0.004).to(torch.int32))
    prior = torch.tensor(PRIOR, device=cuda_device)
    before = lifted_bp_cuda.launches
    for max_iters, check_every in ((20, 21), (60, 10)):
        v, iters = bp_cuda.bp_run(graph, syn, PRIOR, max_iters, check_every)
        v_p, lanes_p = sum_product.bp_run_lanes(graph, syn, prior, max_iters,
                                                check_every)
        torch.cuda.synchronize()
        assert_same(v, v_p)
        assert torch.equal(iters, lanes_p)
    assert lifted_bp_cuda.launches == before + 2


def test_lifted_min_sum_signature_matches_argtypes():
    src = (build.CSRC_DIR / "lifted_min_sum.cu").read_text()
    sig = re.search(r'extern "C" int qec_lifted_min_sum\(([^)]*)\)', src).group(1)
    assert len(sig.split(",")) == len(lifted_min_sum_cuda.ARGTYPES)


def test_lifted_bp_signature_matches_argtypes():
    src = (build.CSRC_DIR / "lifted_bp.cu").read_text()
    sig = re.search(r'extern "C" int qec_lifted_bp\(([^)]*)\)', src).group(1)
    assert len(sig.split(",")) == len(lifted_bp_cuda.ARGTYPES)
