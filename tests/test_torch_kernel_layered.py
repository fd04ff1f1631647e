"""The layered min-sum kernel (csrc/layered_min_sum.cu) against its plain
version on the card, bit for bit, each lane's ``iters`` against the plain
count of that lane alone (``layered.layered_min_sum_run_lanes``).  These
tests need a GPU and skip without one; the wrapper's CPU path and argument
checks are tested in tests/test_torch_layered.py, the compressed state and
the plan in tests/test_torch_layered_state.py, and the launcher's C
signature here.
"""

import re

import numpy as np
import pytest
import torch

from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.codes import find_code_params
from qec_ldpc_tpu_torch.decoder import layered, min_sum
from qec_ldpc_tpu_torch.decoder.decode import CodeGraphs
from qec_ldpc_tpu_torch.kernels import build, layered_cuda
from qec_ldpc_tpu_torch.parallel.chunk import chunk_generator
from qec_ldpc_tpu_torch.sampling.errors import sample_weight_w_errors

LLR = min_sum.prior_llr(np.float32(2.0 / 3.0) * np.float32(0.01))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def test_launcher_signature_matches_argtypes():
    src = (build.CSRC_DIR / "layered_min_sum.cu").read_text()
    sig = re.search(r'extern "C" int qec_layered_min_sum\(([^)]*)\)', src).group(1)
    assert len(sig.split(",")) == len(layered_cuda.ARGTYPES)


def compare_on_cuda(graph, syn, max_iters, check_every, shape=None):
    before = layered_cuda.launches
    q, iters = layered_cuda.layered_run(graph, syn, LLR, max_iters,
                                        check_every, shape=shape)
    assert layered_cuda.launches == before + 1
    q_p, lanes_p = layered.layered_min_sum_run_lanes(graph, syn, LLR,
                                                     max_iters, check_every)
    torch.cuda.synchronize()
    assert torch.equal(q.isnan(), q_p.isnan())
    finite = ~q.isnan()
    assert torch.equal(q.view(torch.int32)[finite],
                       q_p.view(torch.int32)[finite])
    assert torch.equal(iters, lanes_p)
    return iters


def syndrome(graphs, graph, weight, batch, device, seed=5):
    xe, _ = sample_weight_w_errors(chunk_generator(seed, 0, device),
                                   graphs.code.n, weight, batch)
    return graph.syndrome(xe.to(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("code,weight,max_iters,check_every", [
    ((4, 5, 10, 61, 9, 49), 15, 100, 1),
    ((4, 5, 10, 61, 9, 49), 15, 100, 101),
    ((4, 5, 10, 61, 9, 49), 40, 60, 3),
    ((3, 3, 6, 7, 2, 3), 3, 30, 1),
    ((4, 5, 10, 521, 25, 1), 220, 30, 1),
])
def test_kernel_matches_plain_on_cuda(cuda_device, code, weight, max_iters,
                                      check_every):
    graphs = CodeGraphs.build(construct_code(*code))
    for graph in (graphs.x, graphs.z):
        syn = syndrome(graphs, graph, weight, 1000, cuda_device)
        iters = compare_on_cuda(graph, syn, max_iters, check_every)
        if check_every == 1 and weight == 15:
            assert len(set(iters.tolist())) > 1  # each lane stops on its own


@pytest.mark.cuda
def test_probe_and_slab_on_cuda(cuda_device):
    """The P=1051 probe on chip, and the P=521 and P=4201 codes with q and
    the state in the lane's slab (a plan for a smaller limit, and the
    H100's own plan at P=4201)."""
    for P in (1051, 4201):
        s, t = find_code_params(4, 5, 10, P)[0]
        graphs = CodeGraphs.build(construct_code(4, 5, 10, P, s, t))
        weight = round(15 * graphs.code.n / 610)
        for graph in (graphs.x, graphs.z):
            syn = syndrome(graphs, graph, weight, 128, cuda_device)
            compare_on_cuda(graph, syn, 10, 11)
    graphs = CodeGraphs.build(construct_code(4, 5, 10, 521, 25, 1))
    for limit in (4 * 1024, 24 * 1024):
        shape = layered_cuda.plan(graphs.z, limit)
        assert shape.slab_floats > 0
        syn = syndrome(graphs, graphs.z, 220, 256, cuda_device)
        compare_on_cuda(graphs.z, syn, 30, 1, shape=shape)
