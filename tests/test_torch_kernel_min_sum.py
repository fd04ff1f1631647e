"""The min-sum kernel wrappers (kernels/min_sum_cuda.py): the K2 route
``min_sum_run`` and the large-P K4 route ``min_sum_run_wide``.

On a machine without a GPU the wrappers must import (no nvcc needed), send
CPU tensors to the plain version without counting a launch, hand
``P >= WIDE_MIN_P`` to the wide route, and reject bad input.  The kernel is
compared with the plain version bit for bit, damped and undamped, by the
``cuda``-marked tests, which run only where there is a card.
"""

import numpy as np
import pytest
import torch

from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.codes import find_code_params
from qec_ldpc_tpu_torch.decoder import min_sum
from qec_ldpc_tpu_torch.decoder.decode import CodeGraphs
from qec_ldpc_tpu_torch.decoder.layout import CirculantGraph
from qec_ldpc_tpu_torch.kernels import build, layered_cuda, min_sum_cuda
from qec_ldpc_tpu_torch.parallel.montecarlo import chunk_generator
from qec_ldpc_tpu_torch.sampling.errors import sample_weight_w_errors

LLR = min_sum.prior_llr(np.float32(2.0 / 3.0) * np.float32(0.01))

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


def compare_on_cuda(graph, syn, max_iters, check_every, damping=None):
    v, iters = min_sum_cuda.min_sum_run(graph, syn, LLR, max_iters,
                                        check_every, damping=damping)
    v_p, n_p = min_sum.min_sum_run(graph, syn, LLR, max_iters, check_every,
                                   damping=damping)
    torch.cuda.synchronize()
    assert_same(v, v_p)
    assert int(iters.max()) == int(n_p)


@pytest.mark.cuda
@pytest.mark.parametrize("code,weight,max_iters,check_every,damped", [
    ((4, 5, 10, 61, 9, 49), 15, 100, 10, False),
    ((4, 5, 10, 61, 9, 49), 15, 100, 101, False),
    ((4, 5, 10, 61, 9, 49), 40, 100, 10, True),
    ((3, 3, 6, 7, 2, 3), 3, 30, 31, False),
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
