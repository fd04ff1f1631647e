"""The OSD-0 kernel (csrc/osd0.cu, K7) against its plain version on the
card, bit for bit: corrections, solved flags, reduced syndromes, pivot rows
and pivot columns, on real failed lanes, random syndromes and the panel
walk's corner cases (tests/osd0_cases.py).  These tests need a GPU and skip
without one; the plain version is held against the JAX package in
tests/test_torch_osd_device.py, the walk's model in
tests/test_torch_osd0_panels.py.  The CPU tests here check the plan and the
launcher's signature.
"""

import re

import numpy as np
import pytest
import torch

from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.codes import known_bicycle_code
from qec_ldpc_tpu_torch.decoder import BPConfig, CodeGraphs, decode_batch
from qec_ldpc_tpu_torch.decoder.osd import OSDecoder
from qec_ldpc_tpu_torch.decoder.osd_device import DeviceOSD0, ranking
from qec_ldpc_tpu_torch.kernels import build, osd0_cuda, placement
from qec_ldpc_tpu_torch.parallel.chunk import chunk_generator
from qec_ldpc_tpu_torch.sampling.errors import (
    sample_depolarizing_errors,
    sample_weight_w_errors,
)
from tests import osd0_cases

H100_SMEM = 232448


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


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(osd0_cases.CASES))
def test_kernel_matches_plain_on_panel_corner_cases(cuda_device, name):
    """n and m not multiples of 32, a rank-deficient H, columns with no
    candidate, pivots on both sides of a panel border, rank reached in
    mid-panel, zero syndromes, m > n, one row; and the build alone (rank
    0: no walk)."""
    h, syn, rel = osd0_cases.case(name)
    syn = torch.from_numpy(syn).to(cuda_device)
    rel = torch.from_numpy(rel).to(cuda_device)
    compare(h, syn, rel, cuda_device)
    dev = DeviceOSD0(h)
    args = (dev.columns(cuda_device), syn.contiguous(), ranking(rel), dev.m,
            dev.n, 0)
    got = osd0_cuda.osd0_solve(*args)
    want = osd0_cuda.osd0_solve_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_plan_follows_the_device_limit_on_cuda(cuda_device):
    """The plan reads the device's opt-in limit: [[610,61]] fits an H100's
    CTA, a system larger than the limit raises before any launch."""
    limit = placement.smem_optin(cuda_device.index)
    assert osd0_cuda.plan(305, 610, limit).smem_bytes <= limit
    with pytest.raises(ValueError, match="shared memory"):
        osd0_cuda.plan(1024, 32 * (limit // 4096), limit)


def test_plan_sizes_the_cta():
    """[[610,61]] (m = 305, n = 610): 21 planes of 305 rows, masks and
    pivot columns, a 20 x 8 x 16 table; 10 rows a lane of the walk warp
    (ceil(305/32), even), 256 threads.  The gross code's 72 rows: 4 a lane
    (3 rounded up to even), 96 threads.  Row and shared-memory limits
    raise."""
    pl = osd0_cuda.plan(305, 610, H100_SMEM)
    assert pl.smem_bytes == 4 * (21 * 305 + 2 * 305 + 128 * 20)
    assert (pl.threads, pl.rows_per_lane) == (256, 10)
    pl = osd0_cuda.plan(72, 144, H100_SMEM)
    assert (pl.threads, pl.rows_per_lane) == (96, 4)
    assert osd0_cuda.plan(1, 5, H100_SMEM).threads == 64
    assert osd0_cuda.plan(1024, 64, H100_SMEM).rows_per_lane == 32
    with pytest.raises(ValueError, match="rows"):
        osd0_cuda.plan(1025, 64, H100_SMEM)
    with pytest.raises(ValueError, match="shared memory"):
        osd0_cuda.plan(305, 610, 16 * 1024)


def test_signature_matches_argtypes():
    src = (build.CSRC_DIR / "osd0.cu").read_text()
    sig = re.search(r'extern "C" int qec_osd0\(([^)]*)\)', src).group(1)
    assert len(sig.split(",")) == len(osd0_cuda.ARGTYPES)
