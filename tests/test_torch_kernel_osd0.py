"""The OSD-0 kernel (csrc/osd0.cu, K7) against its plain version on the
card, bit for bit: corrections, solved flags, reduced syndromes, pivot rows
and pivot columns.  These tests need a GPU and skip without one; the plain
version is held against the JAX package in tests/test_torch_osd_device.py.
"""

import numpy as np
import pytest
import torch

from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.codes import known_bicycle_code
from qec_ldpc_tpu_torch.decoder import BPConfig, CodeGraphs, decode_batch
from qec_ldpc_tpu_torch.decoder.osd import OSDecoder
from qec_ldpc_tpu_torch.decoder.osd_device import DeviceOSD0, ranking
from qec_ldpc_tpu_torch.kernels import osd0_cuda
from qec_ldpc_tpu_torch.parallel.montecarlo import chunk_generator
from qec_ldpc_tpu_torch.sampling.errors import (
    sample_depolarizing_errors,
    sample_weight_w_errors,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def failed_lanes(graphs, device, weight=None, p=None, batch=2048):
    """Syndromes, min-sum soft outputs and the syndrome-failed lanes of one
    decode, per sector."""
    gen = chunk_generator(21, 0, device)
    if weight is not None:
        xe, ze = sample_weight_w_errors(gen, graphs.code.n, weight, batch)
    else:
        xe, ze = sample_depolarizing_errors(gen, graphs.code.n, p, batch)
    sx = graphs.x.syndrome(xe.to(torch.int32))
    sz = graphs.z.syndrome(ze.to(torch.int32))
    res = decode_batch(graphs, sx, sz, 0.02 if p is None else p,
                       BPConfig(max_iters=100, algorithm="min-sum",
                                return_soft=True))
    return ((graphs.code.pcm_x, sx, res.soft_x, (res.error_code & 1) != 0),
            (graphs.code.pcm_z, sz, res.soft_z, (res.error_code & 2) != 0))


def compare(h, syn, rel, device):
    dev = DeviceOSD0(h)
    order = ranking(rel)
    args = (dev.columns(device), syn.to(torch.int32).contiguous(), order,
            dev.m, dev.n, dev.rank)
    before = osd0_cuda.launches
    got = osd0_cuda.osd0_solve(*args)
    assert osd0_cuda.launches == before + 1
    want = osd0_cuda.osd0_solve_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("code", ["610", "gross", "756"])
def test_kernel_matches_plain_on_failed_lanes(cuda_device, code):
    if code == "610":
        graphs = CodeGraphs.build(construct_code(4, 5, 10, 61, 9, 49))
        sectors = failed_lanes(graphs, cuda_device, weight=40)
    else:
        name = "[[144,12,12]]" if code == "gross" else "[[756,16,34]]"
        graphs = known_bicycle_code(name).build_graphs()
        sectors = failed_lanes(graphs, cuda_device, p=0.05)
    for h, syn, soft, fail in sectors:
        idx = torch.nonzero(fail).flatten()
        assert idx.numel() > 0
        e, solved, *_ = compare(h, syn[:, idx], soft[:, idx], cuda_device)
        assert bool(solved.all())  # real errors: always decodable
        recode = (torch.as_tensor(np.asarray(h, np.float32), device=cuda_device)
                  @ e.float()) % 2
        assert torch.equal(recode.to(torch.int32), syn[:, idx].to(torch.int32))


@pytest.mark.cuda
def test_kernel_matches_plain_on_random_syndromes(cuda_device):
    graphs = CodeGraphs.build(construct_code(4, 5, 10, 61, 9, 49))
    g = torch.Generator(device=cuda_device).manual_seed(3)
    for h in (graphs.code.pcm_x, graphs.code.pcm_z):
        m, n = h.shape
        syn = torch.randint(0, 2, (m, 64), generator=g, device=cuda_device,
                            dtype=torch.int32)
        rel = torch.randn((n, 64), generator=g, device=cuda_device)
        compare(h, syn, rel, cuda_device)


@pytest.mark.cuda
def test_osdecoder_on_cuda_matches_host(cuda_device):
    graphs = CodeGraphs.build(construct_code(4, 5, 10, 61, 9, 49))
    for h, syn, soft, fail in failed_lanes(graphs, cuda_device, weight=40):
        idx = torch.nonzero(fail).flatten()
        e_d, ok_d = OSDecoder(h, lam=0).decode(syn[:, idx], soft[:, idx])
        e_h, ok_h = OSDecoder(h, lam=0, device="host").decode(syn[:, idx],
                                                              soft[:, idx])
        assert e_d.is_cuda and e_h.is_cuda
        assert torch.equal(e_d, e_h) and torch.equal(ok_d, ok_h)
