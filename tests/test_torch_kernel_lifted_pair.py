"""Both sectors of a chunk in one K5 launch
(``kernels/lifted_min_sum_cuda.lifted_min_sum_pair_run``,
``csrc/lifted_min_sum.cu``'s ``qec_lifted_min_sum_pair``) and the decision
that takes it (``decoder/decode.paired_path``, ``run_decoders``).

On the CPU: the decision holds for the benchmark's lifted codes on a CUDA
device object and for nothing else (the CPU, circulant graphs, sum-product,
layered min-sum, damping, a slab plan, graphs of two degrees or plans), the
wrapper refuses what the decision refuses, the launcher's C signature
matches its argument types, and a CPU run counts ``decode.paired`` 0 a
chunk.  On the card (``cuda``-marked): the pair is bit for bit two
one-sector launches, messages and per-lane iterations, and a pair the
decision refuses makes two launches.
"""

import re

import numpy as np
import pytest
import torch

from qec_ldpc_tpu_torch import codes, construct_code, tracing
from qec_ldpc_tpu_torch.decoder import min_sum
from qec_ldpc_tpu_torch.decoder.decode import (
    CodeGraphs,
    decode_batch,
    paired_path,
    run_decoder,
    run_decoders,
)
from qec_ldpc_tpu_torch.decoder.sum_product import BPConfig
from qec_ldpc_tpu_torch.kernels import build, lifted_min_sum_cuda, placement
from qec_ldpc_tpu_torch.parallel.chunk import chunk_generator
from qec_ldpc_tpu_torch.parallel.montecarlo import (
    run_monte_carlo,
    run_monte_carlo_osd,
)
from qec_ldpc_tpu_torch.sampling.errors import sample_depolarizing_errors

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

#: an H100's opt-in shared memory a CTA, 227 KB
H100_SMEM = 232448
CUDA = torch.device("cuda", 0)
MIN_SUM = BPConfig(max_iters=100, algorithm="min-sum")


def bicycle(name: str) -> CodeGraphs:
    return codes.known_bicycle_code(name).build_graphs()


def mixed(z_graph) -> CodeGraphs:
    """The gross code's X graph beside another code's Z graph: a lifted
    pair whose sectors differ in Dv or in plan."""
    gross = bicycle("[[144,12,12]]")
    return CodeGraphs(code=gross.code, x=gross.x, z=z_graph)


PAIRS = {
    "gross": lambda: bicycle("[[144,12,12]]"),
    "bb756": lambda: bicycle("[[756,16,34]]"),
    "dv": lambda: mixed(codes.toric_code(6).build_graphs().z),      # Dv 2
    "plan": lambda: mixed(codes.hgp_code(
        7, 7, "1 + x + x3", "1 + y + y3").build_graphs().z),        # 294 edges
    "circulant": lambda: CodeGraphs.build(construct_code(3, 3, 6, 7, 2, 3)),
}


@pytest.fixture
def h100_limit(monkeypatch):
    """The device's shared-memory limit as an H100 reports it, so the
    decision can be asked on a machine without a card."""
    monkeypatch.setattr(placement, "smem_optin", lambda index: H100_SMEM)


@pytest.mark.parametrize("name,device,cfg,plain,want", [
    ("gross", CUDA, MIN_SUM, False, True),
    ("bb756", CUDA, MIN_SUM, False, True),
    ("gross", torch.device("cuda"), MIN_SUM, False, True),
    ("gross", CUDA, MIN_SUM, True, False),
    ("gross", torch.device("cpu"), MIN_SUM, False, False),
    ("bb756", torch.device("cpu"), MIN_SUM, False, False),
    ("circulant", CUDA, MIN_SUM, False, False),
    ("gross", CUDA, BPConfig(algorithm="sum-product"), False, False),
    ("gross", CUDA, BPConfig(algorithm="layered-min-sum"), False, False),
    ("dv", CUDA, MIN_SUM, False, False),
    ("plan", CUDA, MIN_SUM, False, False),
], ids=["gross", "bb756", "gross-current-device", "plain", "gross-cpu",
        "bb756-cpu", "circulant", "sum-product", "layered", "dv", "plan"])
def test_paired_path(h100_limit, monkeypatch, name, device, cfg, plain,
                     want):
    if device.index is None and device.type == "cuda":
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert paired_path(PAIRS[name](), cfg, device, plain) is want


@pytest.mark.parametrize("name", ["gross", "bb756"])
def test_pair_plan_refuses_damping_and_the_slab(monkeypatch, name):
    """The pair is undamped and keeps every array in shared memory: a
    limit that sends V to the lane's slab refuses it, as damping does."""
    graphs = PAIRS[name]()
    pair = (graphs.x, graphs.z)
    monkeypatch.setattr(placement, "smem_optin", lambda index: H100_SMEM)
    pl = lifted_min_sum_cuda.pair_plan(pair, False, CUDA)
    assert pl == placement.plan(graphs.x, False, H100_SMEM)
    assert pl.slab_floats == 0 and pl.v_shared and pl.state_shared
    assert lifted_min_sum_cuda.pair_plan(pair, True, CUDA) is None
    small = placement.plan(graphs.x, False, 1024)
    assert small.slab_floats > 0
    monkeypatch.setattr(placement, "smem_optin", lambda index: 1024)
    assert lifted_min_sum_cuda.pair_plan(pair, False, CUDA) is None


@pytest.mark.parametrize("name", ["dv", "plan", "circulant"])
def test_pair_wrapper_raises_where_the_plan_refuses(h100_limit, name):
    """What the decision refuses, the wrapper refuses too, before any
    library is loaded; CPU syndromes are refused as well."""
    graphs = PAIRS[name]()
    syn = [torch.zeros((g.num_checks, 8), dtype=torch.int32)
           for g in (graphs.x, graphs.z)]
    before = lifted_min_sum_cuda.launches
    with pytest.raises((TypeError, ValueError)):
        lifted_min_sum_cuda.lifted_min_sum_pair_run(
            (graphs.x, graphs.z), syn, 1.0, 10)
    assert lifted_min_sum_cuda.launches == before


def test_pair_signature_matches_argtypes():
    src = (build.CSRC_DIR / "lifted_min_sum.cu").read_text()
    sig = re.search(r'extern "C" int qec_lifted_min_sum_pair\(([^)]*)\)',
                    src).group(1)
    assert len(sig.split(",")) == len(lifted_min_sum_cuda.PAIR_ARGTYPES)


def test_kernel_keeps_its_name():
    """One kernel for one and two sectors, under the name the benchmark's
    ``roofline.k5`` reads."""
    src = (build.CSRC_DIR / "lifted_min_sum.cu").read_text()
    assert len(re.findall(r"__global__ void", src)) == 1
    assert re.search(r"\blifted_min_sum_kernel\(const Routing g0,", src)
    assert "const Routing g1" in src


@pytest.mark.parametrize("name", ["gross", "bb756"])
def test_cpu_run_decoders_is_two_plain_decodes(name):
    """On the CPU ``run_decoders`` is ``run_decoder`` once a graph."""
    graphs = PAIRS[name]()
    xe, ze = sample_depolarizing_errors(chunk_generator(3, 0, "cpu"),
                                        graphs.code.n, 0.05, 16)
    syn = (graphs.x.syndrome(xe.to(torch.int32)),
           graphs.z.syndrome(ze.to(torch.int32)))
    prior = np.float32(2.0 / 3.0) * np.float32(0.05)
    cfg = BPConfig(max_iters=12, algorithm="min-sum")
    got = run_decoders(graphs, syn, prior, cfg,
                       paired_path(graphs, cfg, syn[0].device))
    for (v, it), graph, s in zip(got, (graphs.x, graphs.z), syn):
        v_w, it_w = run_decoder(graph, s, prior, cfg)
        assert torch.equal(v, v_w) and torch.equal(it, it_w)


@pytest.mark.parametrize("osd", [False, True], ids=["counting", "quality"])
def test_cpu_run_counts_zero_paired(osd):
    """A CPU run on the gross code counts ``decode.paired`` 0 a chunk, in
    the counting path's group loop and in the quality mode's chunk loop,
    and launches nothing."""
    graphs = PAIRS["gross"]()
    cfg = BPConfig(max_iters=20, algorithm="min-sum")
    before = lifted_min_sum_cuda.launches
    with tracing.recording() as rec:
        if osd:
            run_monte_carlo_osd(graphs, 0, 3 * 32, 0.05, cfg, seed=4,
                                batch_size=32, lam=0,
                                error_model="depolarizing", device="cpu")
        else:
            run_monte_carlo(graphs, 0, 3 * 32, 0.05, cfg, seed=4,
                            batch_size=32, error_model="depolarizing",
                            device="cpu")
    assert {s[4] for s in rec.spans if s[0] == "mc.chunk"} == {0, 1, 2}
    assert rec.counters["decode.paired"] == 0
    assert lifted_min_sum_cuda.launches == before


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return CUDA


def syndromes(graphs, p, batch, device, seed):
    xe, ze = sample_depolarizing_errors(chunk_generator(seed, 0, device),
                                        graphs.code.n, p, batch)
    return (graphs.x.syndrome(xe.to(torch.int32)),
            graphs.z.syndrome(ze.to(torch.int32)))


def assert_same(v, v_p):
    assert torch.equal(v.isnan(), v_p.isnan())
    finite = ~v.isnan()
    assert torch.equal(v.view(torch.int32)[finite],
                       v_p.view(torch.int32)[finite])


@pytest.mark.cuda
@pytest.mark.parametrize("max_iters,check_every", [(100, 10), (100, 101)],
                         ids=["early-exit", "fixed"])
def test_pair_equals_two_launches_gross(cuda_device, max_iters, check_every):
    """gross144 at p = 0.01 and 2048 lanes (the counting cell's chunk): the
    pair's messages and per-lane iterations equal two one-sector launches
    bit for bit, in one launch against two."""
    graphs = PAIRS["gross"]()
    syn = syndromes(graphs, 0.01, 2048, cuda_device, seed=2**33 + 5)
    llr = min_sum.prior_llr(np.float32(2.0 / 3.0) * np.float32(0.01))
    before = lifted_min_sum_cuda.launches
    pair = lifted_min_sum_cuda.lifted_min_sum_pair_run(
        (graphs.x, graphs.z), syn, llr, max_iters, check_every)
    assert lifted_min_sum_cuda.launches == before + 1
    for (v, it), graph, s in zip(pair, (graphs.x, graphs.z), syn):
        v_1, it_1 = lifted_min_sum_cuda.lifted_min_sum_run(
            graph, s, llr, max_iters, check_every)
        torch.cuda.synchronize()
        assert_same(v, v_1)
        assert torch.equal(it, it_1)
    assert lifted_min_sum_cuda.launches == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("sort", [False, True], ids=["given", "sorted"])
def test_decode_batch_pair_equals_two_launches_bb756(cuda_device,
                                                    monkeypatch, sort):
    """bb756 at p = 0.10 and 1000 lanes through ``decode_batch`` with soft
    outputs: the paired decode (one launch) equals the one-sector decodes
    (two launches) bit for bit: decisions, error codes, iteration counts
    and soft outputs, with the lanes sorted or not."""
    graphs = PAIRS["bb756"]()
    sx, sz = syndromes(graphs, 0.10, 1000, cuda_device, seed=2**35 + 1)
    cfg = BPConfig(max_iters=100, algorithm="min-sum", return_soft=True,
                   kernel_sort_lanes=sort)
    assert paired_path(graphs, cfg, cuda_device)
    before = lifted_min_sum_cuda.launches
    paired = decode_batch(graphs, sx, sz, 0.10, cfg)
    assert lifted_min_sum_cuda.launches == before + 1
    monkeypatch.setattr(lifted_min_sum_cuda, "pair_plan", lambda *a: None)
    assert not paired_path(graphs, cfg, cuda_device)
    single = decode_batch(graphs, sx, sz, 0.10, cfg)
    assert lifted_min_sum_cuda.launches == before + 3
    torch.cuda.synchronize()
    for field in ("decisions_x", "decisions_z", "error_code", "iters_x",
                  "iters_z", "iter_samples_x", "iter_samples_z"):
        assert torch.equal(getattr(paired, field), getattr(single, field))
    assert_same(paired.soft_x, single.soft_x)
    assert_same(paired.soft_z, single.soft_z)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dv", "plan"])
def test_fallback_makes_two_launches(cuda_device, name):
    """A lifted pair whose sectors differ in Dv or in plan decodes one
    sector a launch, each as ``run_decoder`` alone."""
    graphs = PAIRS[name]()
    syn = [(torch.rand((g.num_checks, 512), device=cuda_device) < 0.05)
           .to(torch.int32) for g in (graphs.x, graphs.z)]
    prior = np.float32(2.0 / 3.0) * np.float32(0.05)
    paired = paired_path(graphs, MIN_SUM, cuda_device)
    assert not paired
    before = lifted_min_sum_cuda.launches
    got = run_decoders(graphs, syn, prior, MIN_SUM, paired)
    assert lifted_min_sum_cuda.launches == before + 2
    for (v, it), graph, s in zip(got, (graphs.x, graphs.z), syn):
        v_1, it_1 = run_decoder(graph, s, prior, MIN_SUM)
        torch.cuda.synchronize()
        assert_same(v, v_1)
        assert torch.equal(it, it_1)


@pytest.mark.cuda
def test_quality_mode_counts_paired_chunks(cuda_device):
    """The quality mode on bb756 pairs every chunk's decode: one K5 launch
    and 1 in ``decode.paired`` a chunk."""
    graphs = PAIRS["bb756"]()
    cfg = BPConfig(max_iters=100, algorithm="min-sum")
    before = lifted_min_sum_cuda.launches
    with tracing.recording() as rec:
        run_monte_carlo_osd(graphs, 0, 2 * 1024, 0.10, cfg, seed=2**36 + 3,
                            batch_size=1024, lam=0,
                            error_model="depolarizing", device=cuda_device)
    assert rec.counters["decode.paired"] == 2
    assert lifted_min_sum_cuda.launches == before + 2
