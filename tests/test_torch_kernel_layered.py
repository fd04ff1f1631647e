"""The layered min-sum kernel (csrc/layered_min_sum.cu) against its plain
version on the card, bit for bit.  These tests need a GPU and skip without
one; the wrapper's CPU path and argument checks are tested in
tests/test_torch_layered.py.
"""

import numpy as np
import pytest
import torch

from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.decoder import layered, min_sum
from qec_ldpc_tpu_torch.decoder.decode import CodeGraphs
from qec_ldpc_tpu_torch.kernels import layered_cuda
from qec_ldpc_tpu_torch.parallel.montecarlo import chunk_generator
from qec_ldpc_tpu_torch.sampling.errors import sample_weight_w_errors

LLR = min_sum.prior_llr(np.float32(2.0 / 3.0) * np.float32(0.01))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("code,weight,max_iters,check_every", [
    ((4, 5, 10, 61, 9, 49), 15, 100, 1),
    ((4, 5, 10, 61, 9, 49), 15, 100, 101),
    ((4, 5, 10, 61, 9, 49), 40, 60, 3),
    ((3, 3, 6, 7, 2, 3), 3, 30, 1),
])
def test_kernel_matches_plain_on_cuda(cuda_device, code, weight, max_iters,
                                      check_every):
    graphs = CodeGraphs.build(construct_code(*code))
    for graph in (graphs.x, graphs.z):
        xe, _ = sample_weight_w_errors(chunk_generator(5, 0, cuda_device),
                                       graphs.code.n, weight, 1000)
        syn = graph.syndrome(xe.to(torch.int32))
        before = layered_cuda.launches
        q, iters = layered_cuda.layered_run(graph, syn, LLR, max_iters,
                                            check_every)
        assert layered_cuda.launches == before + 1
        q_p, n_p = layered.layered_min_sum_run(graph, syn, LLR, max_iters,
                                               check_every)
        torch.cuda.synchronize()
        assert torch.equal(q.isnan(), q_p.isnan())
        finite = ~q.isnan()
        assert torch.equal(q.view(torch.int32)[finite],
                           q_p.view(torch.int32)[finite])
        assert int(iters.max()) == int(n_p)
