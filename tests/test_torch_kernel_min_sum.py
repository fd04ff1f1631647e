"""The min-sum kernel wrappers (kernels/min_sum_cuda.py): the K2 route
``min_sum_run`` and the large-P K4 route ``min_sum_run_wide``.

On a machine without a GPU the wrappers must import (no nvcc needed), send
CPU tensors to the plain version without counting a launch, hand
``P >= WIDE_MIN_P`` to the wide route, reject bad input, and plan each
lane's arrays into the shared memory a CTA may take.  The kernel is
compared with the plain version bit for bit, damped and undamped, and each
lane's ``iters`` with the plain count of that lane alone
(``min_sum.min_sum_run_lanes``), by the ``cuda``-marked tests, which run
only where there is a card.
"""

import re

import numpy as np
import pytest
import torch

from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.codes import find_code_params
from qec_ldpc_tpu_torch.decoder import min_sum
from qec_ldpc_tpu_torch.decoder.decode import CodeGraphs
from qec_ldpc_tpu_torch.decoder.layout import CirculantGraph
from qec_ldpc_tpu_torch.kernels import build, layered_cuda, min_sum_cuda, placement
from qec_ldpc_tpu_torch.parallel.chunk import chunk_generator
from qec_ldpc_tpu_torch.sampling.errors import sample_weight_w_errors

LLR = min_sum.prior_llr(np.float32(2.0 / 3.0) * np.float32(0.01))

#: the shared memory an H100's CTA may take with the opt-in (227 KB)
H100_SMEM = 232448

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def g42():
    return CodeGraphs.build(construct_code(3, 3, 6, 7, 2, 3))


def syndrome(graph, n, weight, batch, device, seed=3):
    xe, _ = sample_weight_w_errors(chunk_generator(seed, 0, device), n,
                                   weight, batch)
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("damped", [False, True], ids=["undamped", "damped"])
@pytest.mark.parametrize("max_iters,check_every", [(30, 31), (100, 10)])
def test_cpu_tensor_takes_plain_path(g42, max_iters, check_every, damped):
    syn = syndrome(g42.x, g42.code.n, 3, 64, "cpu")
    damping = gammas(g42.x, 64, "cpu") if damped else None
    before = (min_sum_cuda.launches, min_sum_cuda.wide_launches)
    v, iters = min_sum_cuda.min_sum_run(g42.x, syn, LLR, max_iters,
                                        check_every, damping=damping)
    assert (min_sum_cuda.launches, min_sum_cuda.wide_launches) == before
    v_p, n_p = min_sum.min_sum_run(g42.x, syn, LLR, max_iters, check_every,
                                   damping=damping)
    assert_same(v, v_p)
    assert iters.shape == (64,) and iters.dtype == torch.int32
    assert bool((iters == n_p).all())


def test_large_p_goes_to_the_wide_route(monkeypatch):
    calls = []
    real = min_sum_cuda.min_sum_run_wide
    monkeypatch.setattr(min_sum_cuda, "min_sum_run_wide",
                        lambda *a, **k: calls.append(a[0].P) or real(*a, **k))
    small = CirculantGraph.from_table(np.array([[0, 1, 2], [0, 2, 4]]), 61)
    big = CirculantGraph.from_table(np.array([[0, 1, 2], [0, 2, 4]]),
                                    min_sum_cuda.WIDE_MIN_P)
    for graph in (small, big):
        syn = torch.zeros((graph.num_checks, 4), dtype=torch.int32)
        v, _ = min_sum_cuda.min_sum_run(graph, syn, LLR, 3)
        assert v.shape == (graph.num_edges, 4)
    assert calls == [min_sum_cuda.WIDE_MIN_P]


def test_wrapper_rejects_bad_input(g42):
    syn = syndrome(g42.x, g42.code.n, 3, 8, "cpu")
    damping = gammas(g42.x, 8, "cpu")
    run = min_sum_cuda.min_sum_run
    with pytest.raises(TypeError):
        run(g42.x, syn.to(torch.int64), LLR, 5)
    with pytest.raises(ValueError):
        run(g42.x, syn[:-1], LLR, 5)
    with pytest.raises(ValueError):
        run(g42.x, syn, LLR, 5, check_every=0)
    with pytest.raises(TypeError):
        run(g42, syn, LLR, 5)
    with pytest.raises(TypeError):
        run(g42.x, syn, LLR, 5, damping=damping.double())
    with pytest.raises(ValueError):
        run(g42.x, syn, LLR, 5, damping=damping[:, :4])


@pytest.mark.parametrize("module,source", [
    (min_sum_cuda, "min_sum.cu"), (layered_cuda, "layered_min_sum.cu")])
def test_kernel_degree_limits_match_source(module, source):
    assert module.SOURCES == (source,)
    src = (build.CSRC_DIR / source).read_text()
    assert f"constexpr int kMaxB = {module.MAX_VAR_DEGREE};" in src
    assert f"constexpr int kMaxL = {module.MAX_CHECK_DEGREE};" in src


def test_each_kernel_builds_its_own_library():
    paths = {build.library_path(name, sources) for name, sources in (
        ("qec_bp", ("bp_sum_product.cu",)),
        ("qec_min_sum", min_sum_cuda.SOURCES),
        ("qec_layered", layered_cuda.SOURCES))}
    assert len(paths) == 3


def aligned(floats):
    """A slab array's length in floats: each array starts 16-byte aligned."""
    return -(-floats // 4) * 4


def test_plan_keeps_the_main_path_on_chip():
    """[[610,61]] (K2's main path, relay's damping included) and the P=1051
    probe's X graph hold every array in shared memory; the probe's Z graph
    keeps V there and puts its check state in the lane's slab; P=4201 puts V
    in the slab.  Every plan fits a CTA's shared memory."""
    g610 = CodeGraphs.build(construct_code(4, 5, 10, 61, 9, 49))
    for graph in (g610.x, g610.z):
        for damped in (False, True):
            pl = placement.plan(graph, damped, H100_SMEM)
            assert (pl.v_shared, pl.state_shared, pl.slab_floats) == (True, True, 0)
            assert pl.damping_shared == damped and pl.threads == 320
    probes = {}
    for P in (1051, 4201):
        s, t = find_code_params(4, 5, 10, P)[0]
        probes[P] = CodeGraphs.build(construct_code(4, 5, 10, P, s, t))
    x, z = probes[1051].x, probes[1051].z
    assert placement.plan(x, False, H100_SMEM).slab_floats == 0
    assert placement.plan(x, True, H100_SMEM).slab_floats == x.num_edges
    pz = placement.plan(z, False, H100_SMEM)
    assert pz.v_shared and not pz.state_shared
    # {min1, min2} and meta, each array 16-byte aligned
    state_floats = aligned(2 * z.num_checks) + aligned(z.num_checks)
    assert pz.slab_floats == state_floats and pz.threads == 1024
    p4 = placement.plan(probes[4201].z, True, H100_SMEM)
    assert not p4.v_shared and not p4.damping_shared
    for graph in (x, z, probes[4201].x, probes[4201].z, g610.x):
        for damped in (False, True):
            pl = placement.plan(graph, damped, H100_SMEM)
            assert pl.smem_bytes <= H100_SMEM
            assert pl.threads % 32 == 0 and 128 <= pl.threads <= 1024


@pytest.mark.parametrize("limit", [48 * 1024, 120 * 1024, H100_SMEM])
def test_plan_follows_the_device_limit(limit):
    """A device that lets a CTA take less shared memory gets the same
    kernel with more of the lane in its slab: the arrays are placed in
    order while they fit, and what stays on chip never exceeds the limit."""
    graph = CodeGraphs.build(construct_code(4, 5, 10, 521, 25, 1)).z
    v_bytes = 4 * aligned(graph.num_edges)
    state_bytes = 4 * (aligned(2 * graph.num_checks) + aligned(graph.num_checks))
    syn_bytes = 4 * aligned(-(-graph.num_checks // 4))
    for damped in (False, True):
        pl = placement.plan(graph, damped, limit)
        assert pl.smem_bytes <= limit
        assert pl.v_shared == (syn_bytes + v_bytes <= limit)
        on_chip = syn_bytes + v_bytes * pl.v_shared
        assert pl.state_shared == (on_chip + state_bytes <= limit)
        on_chip += state_bytes * pl.state_shared
        assert pl.damping_shared == (damped and on_chip + v_bytes <= limit)
        slab = ((not pl.v_shared) * v_bytes + (not pl.state_shared) * state_bytes
                + (damped and not pl.damping_shared) * v_bytes)
        assert pl.slab_floats * 4 == slab


def test_launcher_signature_matches_argtypes():
    src = (build.CSRC_DIR / "min_sum.cu").read_text()
    sig = re.search(r'extern "C" int qec_min_sum\(([^)]*)\)', src).group(1)
    assert len(sig.split(",")) == len(min_sum_cuda.ARGTYPES)


def compare_on_cuda(graph, syn, max_iters, check_every, damping=None):
    """Kernel vs plain: messages bit for bit, and each lane's ``iters`` the
    plain count of that lane alone."""
    v, iters = min_sum_cuda.min_sum_run(graph, syn, LLR, max_iters,
                                        check_every, damping=damping)
    v_p, lanes_p = min_sum.min_sum_run_lanes(graph, syn, LLR, max_iters,
                                             check_every, damping=damping)
    torch.cuda.synchronize()
    assert_same(v, v_p)
    assert torch.equal(iters, lanes_p)
    return iters


@pytest.mark.cuda
@pytest.mark.parametrize("code,weight,max_iters,check_every,damped", [
    ((4, 5, 10, 61, 9, 49), 15, 100, 10, False),
    ((4, 5, 10, 61, 9, 49), 15, 100, 101, False),
    ((4, 5, 10, 61, 9, 49), 40, 100, 10, True),
    ((3, 3, 6, 7, 2, 3), 3, 30, 31, False),
    ((4, 5, 10, 521, 25, 1), 220, 30, 10, False),
    ((4, 5, 10, 521, 25, 1), 220, 30, 10, True),
])
def test_kernel_matches_plain_on_cuda(cuda_device, code, weight, max_iters,
                                      check_every, damped):
    graphs = CodeGraphs.build(construct_code(*code))
    for graph in (graphs.x, graphs.z):
        syn = syndrome(graph, graphs.code.n, weight, 1000, cuda_device)
        damping = gammas(graph, 1000, cuda_device) if damped else None
        before = min_sum_cuda.launches
        compare_on_cuda(graph, syn, max_iters, check_every, damping)
        assert min_sum_cuda.launches == before + 1


def relay_shaped(graph, n, batch, device, heavy=24, seed=5):
    """A relay retry's batch: most lanes solved (a zero syndrome), a few
    W=40 lanes."""
    syn = syndrome(graph, n, 40, batch, device, seed=seed)
    keep = torch.zeros(batch, dtype=torch.bool, device=device)
    keep[torch.randperm(batch, device=device)[:heavy]] = True
    return torch.where(keep[None, :], syn, 0).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("damped", [False, True], ids=["undamped", "damped"])
def test_relay_shaped_batch_on_cuda(cuda_device, damped):
    """Mostly zero syndromes and a few W=40 lanes: bit for bit, and the
    solved lanes stop after their first test while the few run on."""
    graphs = CodeGraphs.build(construct_code(4, 5, 10, 61, 9, 49))
    for graph in (graphs.x, graphs.z):
        syn = relay_shaped(graph, graphs.code.n, 2048, cuda_device)
        damping = gammas(graph, 2048, cuda_device) if damped else None
        iters = compare_on_cuda(graph, syn, 100, 10, damping)
        assert int((iters == 1).sum()) >= 2048 - 24


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 17, 16384])
def test_batches_on_cuda(cuda_device, batch):
    graphs = CodeGraphs.build(construct_code(4, 5, 10, 61, 9, 49))
    syn = syndrome(graphs.x, graphs.code.n, 40, batch, cuda_device)
    compare_on_cuda(graphs.x, syn, 100, 10)


@pytest.mark.cuda
@pytest.mark.parametrize("damped", [False, True], ids=["undamped", "damped"])
def test_kernel_on_every_device(damped):
    """The shared-memory opt-in belongs to each device: a lane above 48 KB
    (P = 521, 83 KB of V) decodes bit for bit on every visible card, each
    planned from its own limit, in a process that launched on card 0 first."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    graphs = CodeGraphs.build(construct_code(4, 5, 10, 521, 25, 1))
    for index in range(torch.cuda.device_count()):
        device = torch.device("cuda", index)
        syn = syndrome(graphs.z, graphs.code.n, 220, 256, device)
        damping = gammas(graphs.z, 256, device) if damped else None
        pl = placement.plan(graphs.z, damped, placement.smem_optin(index))
        assert pl.smem_bytes > 48 * 1024
        with torch.cuda.device(device):
            compare_on_cuda(graphs.z, syn, 30, 10, damping)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1051, 2081, 4201])
def test_wide_route_matches_plain_on_cuda(cuda_device, P):
    """The probe codes of benchmarks/large_code_real.py (K4's domain),
    fixed work and early exit."""
    s, t = find_code_params(4, 5, 10, P)[0]
    graphs = CodeGraphs.build(construct_code(4, 5, 10, P, s, t))
    weight = round(15 * graphs.code.n / 610)
    for graph in (graphs.x, graphs.z):
        syn = syndrome(graph, graphs.code.n, weight, 256, cuda_device)
        before = min_sum_cuda.wide_launches
        compare_on_cuda(graph, syn, 20, 21)
        compare_on_cuda(graph, syn, 100, 10)
        assert min_sum_cuda.wide_launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [64, 2048])
@pytest.mark.parametrize("damped", [False, True], ids=["undamped", "damped"])
def test_wide_route_largest_lane_on_cuda(cuda_device, batch, damped):
    """The P=1051 Z graph, the largest lane of the K4 route's main path
    (its check state in the lane's global slab; damped, the damping too)."""
    s, t = find_code_params(4, 5, 10, 1051)[0]
    graphs = CodeGraphs.build(construct_code(4, 5, 10, 1051, s, t))
    weight = round(15 * graphs.code.n / 610)
    syn = syndrome(graphs.z, graphs.code.n, weight, batch, cuda_device)
    damping = gammas(graphs.z, batch, cuda_device) if damped else None
    before = min_sum_cuda.wide_launches
    compare_on_cuda(graphs.z, syn, 20, 21, damping)
    compare_on_cuda(graphs.z, syn, 100, 10, damping)
    assert min_sum_cuda.wide_launches == before + 2
