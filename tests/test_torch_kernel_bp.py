"""The BP kernel wrapper (kernels/bp_cuda.py) and its build (kernels/build.py).

On a machine without a GPU the wrapper must import (no nvcc needed), send
CPU tensors to the plain version without counting a launch, and reject bad
input.  The kernel itself is compared with the plain version bit for bit by
the ``cuda``-marked tests, which run only where there is a card, and each
lane's ``iters`` with the plain count of that lane alone.
"""

import re

import numpy as np
import pytest
import torch

from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.codes import find_code_params
from qec_ldpc_tpu_torch.decoder import sum_product
from qec_ldpc_tpu_torch.decoder.decode import CodeGraphs
from qec_ldpc_tpu_torch.kernels import bp_cuda, build, placement
from qec_ldpc_tpu_torch.parallel.chunk import chunk_generator
from qec_ldpc_tpu_torch.sampling.errors import sample_weight_w_errors

PRIOR = np.float32(2.0 / 3.0) * np.float32(0.01)

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def g42():
    return CodeGraphs.build(construct_code(3, 3, 6, 7, 2, 3))


def syndrome(graph, n, weight, batch, device):
    xe, _ = sample_weight_w_errors(chunk_generator(3, 0, device), n, weight, batch)
    return graph.syndrome(xe.to(torch.int32))


def test_launcher_signature_matches_argtypes():
    src = (build.CSRC_DIR / "bp_sum_product.cu").read_text()
    sig = re.search(r'extern "C" int qec_bp_sum_product\(([^)]*)\)', src).group(1)
    assert len(sig.split(",")) == len(bp_cuda.ARGTYPES)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def test_wrapper_imports_without_nvcc(monkeypatch):
    """Importing and CPU use need no toolkit; a launch without one raises
    with a message naming nvcc."""
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.find_nvcc()
    assert callable(bp_cuda.bp_run)


@pytest.mark.parametrize("max_iters,check_every", [(30, 31), (100, 10)])
def test_cpu_tensor_takes_plain_path(g42, max_iters, check_every):
    syn = syndrome(g42.x, g42.code.n, 3, 64, "cpu")
    before = bp_cuda.launches
    v, iters = bp_cuda.bp_run(g42.x, syn, PRIOR, max_iters, check_every)
    assert bp_cuda.launches == before
    v_p, n_p = sum_product.bp_run(g42.x, syn, torch.tensor(PRIOR), max_iters,
                                  check_every)
    assert torch.equal(v.isnan(), v_p.isnan())
    assert torch.equal(v.nan_to_num(-1.0), v_p.nan_to_num(-1.0))
    assert iters.shape == (64,) and iters.dtype == torch.int32
    assert bool((iters == n_p).all())


def test_wrapper_rejects_bad_input(g42):
    syn = syndrome(g42.x, g42.code.n, 3, 8, "cpu")
    with pytest.raises(TypeError):
        bp_cuda.bp_run(g42.x, syn.to(torch.int64), PRIOR, 5)
    with pytest.raises(ValueError):
        bp_cuda.bp_run(g42.x, syn[:-1], PRIOR, 5)
    with pytest.raises(ValueError):
        bp_cuda.bp_run(g42.x, syn, PRIOR, 5, check_every=0)
    with pytest.raises(TypeError):
        bp_cuda.bp_run(g42, syn, PRIOR, 5)


def test_library_name_keys_on_sources_and_flags(monkeypatch):
    a = build.library_path("qec_bp", bp_cuda.SOURCES)
    assert a.parent == build.BUILD_DIR and a.name.startswith("libqec_bp-")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path("qec_bp", bp_cuda.SOURCES) != a


def test_build_flags_keep_ieee_numerics():
    flags = " ".join(build.NVCC_FLAGS)
    assert "--fmad=false" in flags and "sm_90a" in flags
    assert "fast_math" not in flags and "ftz=true" not in flags


def test_kernel_degree_limits_match_source():
    src = (build.CSRC_DIR / "bp_sum_product.cu").read_text()
    assert f"constexpr int kMaxB = {bp_cuda.MAX_VAR_DEGREE};" in src
    assert f"constexpr int kMaxL = {bp_cuda.MAX_CHECK_DEGREE};" in src


@pytest.mark.cuda
@pytest.mark.parametrize("code,weight,max_iters,check_every", [
    ((4, 5, 10, 61, 9, 49), 15, 100, 10),
    ((4, 5, 10, 61, 9, 49), 15, 100, 101),
    ((3, 3, 6, 7, 2, 3), 3, 30, 31),
    ((4, 5, 10, 521, 25, 1), 220, 30, 10),
])
def test_kernel_matches_plain_on_cuda(cuda_device, code, weight, max_iters,
                                      check_every):
    """Messages bit for bit, and each lane's ``iters`` the plain count of
    that lane alone (``bp_run_lanes``)."""
    graphs = CodeGraphs.build(construct_code(*code))
    for graph in (graphs.x, graphs.z):
        syn = syndrome(graph, graphs.code.n, weight, 1000, cuda_device)
        compare_on_cuda(graph, syn, max_iters, check_every)


def compare_on_cuda(graph, syn, max_iters, check_every):
    before = bp_cuda.launches
    v, iters = bp_cuda.bp_run(graph, syn, PRIOR, max_iters, check_every)
    assert bp_cuda.launches == before + 1
    v_p, lanes_p = sum_product.bp_run_lanes(
        graph, syn, torch.tensor(PRIOR, device=syn.device), max_iters,
        check_every)
    torch.cuda.synchronize()
    assert torch.equal(v.isnan(), v_p.isnan())
    finite = ~v.isnan()
    assert torch.equal(v.view(torch.int32)[finite], v_p.view(torch.int32)[finite])
    assert torch.equal(iters, lanes_p)


@pytest.mark.cuda
def test_slab_route_matches_plain_on_cuda(cuda_device):
    """P=1051: V in shared memory, E in the lane's global slab."""
    s, t = find_code_params(4, 5, 10, 1051)[0]
    graphs = CodeGraphs.build(construct_code(4, 5, 10, 1051, s, t))
    graph = graphs.z
    pl = placement.bp_plan(graph, placement.smem_optin(cuda_device.index))
    assert pl.v_shared and not pl.e_shared and pl.slab_floats > 0
    syn = syndrome(graph, graphs.code.n, 26, 128, cuda_device)
    compare_on_cuda(graph, syn, 10, 11)
