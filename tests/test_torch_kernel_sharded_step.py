"""The K8 wrapper (kernels/sharded_step_cuda.py), the graph-sharded min-sum
step.

On a machine without a GPU the wrapper must import (no nvcc needed), send
CPU tensors to the plain version without counting a launch, and reject bad
input.  The ``cuda``-marked tests hold the kernel to the plain version bit
for bit on the card, with planted +-0.0, NaN and +-inf, half the lanes done
and ``last`` 0 and 1, on every shard position of the [[42]] X graph at G=2
and 3 and of the [[610,61]] and [[5210,521]] X graphs at G=2, and on every
launch shape the plan can choose (lanes per CTA, the partials' route, the
check state on chip or in the global slab).  The plain
version is held to the JAX package in ``test_torch_sharded_step.py``.
"""

import math
import re

import pytest
import torch

from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.decoder.decode import CodeGraphs
from qec_ldpc_tpu_torch.kernels import build, placement, sharded_step_cuda
from qec_ldpc_tpu_torch.parallel.graph_sharded import ShardRouter

CODES = {"42": (3, 3, 6, 7, 2, 3), "610": (4, 5, 10, 61, 9, 49),
         "5210": (4, 5, 10, 521, 25, 1)}
SHARDS = [("42", 2), ("42", 3), ("610", 2), ("5210", 2)]
CASES = [(c, G, g) for c, G in SHARDS for g in range(G)]
ALPHA = 0.75
LLR = 4.59

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


def assert_same(got, want):
    assert torch.equal(got.isnan(), want.isnan())
    finite = ~got.isnan()
    assert torch.equal(got.view(torch.int32)[finite],
                       want.view(torch.int32)[finite])


def planted(gen, shape, nonneg=False):
    """Normal draws with about 3% each of +0.0, -0.0, NaN, +inf, -inf."""
    a = torch.randn(shape, generator=gen) * 4
    if nonneg:
        a = a.abs() + 0.5
    pick = torch.rand(shape, generator=gen)
    for i, value in enumerate((0.0, -0.0, math.nan, math.inf, -math.inf)):
        a[(pick >= 0.03 * i) & (pick < 0.03 * (i + 1))] = value
    return a


def inputs(router, batch, seed):
    """(syn_sign, other, done, v) in the row layout, on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    checks = router.B * router.P
    v = planted(gen, (router.Lc * checks, batch))
    other = torch.cat([planted(gen, (checks, batch), nonneg=True),
                       torch.where(torch.rand((checks, batch), generator=gen)
                                   < 0.5, -1.0, 1.0)])
    syn = torch.where(torch.rand((checks, batch), generator=gen) < 0.3,
                      -1.0, 1.0)
    done = torch.rand(batch, generator=gen) < 0.5
    return syn, other, done, v


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: f"{c[0]}-G{c[1]}-g{c[2]}")
def router(request):
    code_name, G, g = request.param
    return ShardRouter(CodeGraphs.build(construct_code(*CODES[code_name])).x,
                       G, g)


@pytest.mark.parametrize("last", [0, 1])
@pytest.mark.parametrize("shard", [c for c in CASES if c[0] != "5210"],
                         ids=lambda c: f"{c[0]}-G{c[1]}-g{c[2]}")
def test_cpu_tensor_takes_plain_path(shard, last):
    code_name, G, g = shard
    router = ShardRouter(CodeGraphs.build(construct_code(*CODES[code_name])).x,
                         G, g)
    args = inputs(router, 16, 7)
    before = sharded_step_cuda.launches
    got = sharded_step_cuda.sharded_min_sum_step(router, LLR, last, *args,
                                                 ALPHA)
    want = sharded_step_cuda.sharded_min_sum_step_plain(router, LLR, last,
                                                        *args, ALPHA)
    for a, b in zip(got, want):
        assert_same(a, b)
    assert sharded_step_cuda.launches == before
    v_new, part = got
    done, v = args[2], args[3]
    assert_same(v_new[:, done], v[:, done])
    assert_same(part, sharded_step_cuda.local_partials(v_new, router.Lc))


def test_wrapper_rejects_bad_arguments():
    router = ShardRouter(CodeGraphs.build(construct_code(*CODES["42"])).x,
                         2, 0)
    syn, other, done, v = inputs(router, 8, 3)
    step = sharded_step_cuda.sharded_min_sum_step
    checks = router.B * router.P
    with pytest.raises(ValueError):
        step(router, LLR, 0, syn, other[:checks], done, v, ALPHA)
    with pytest.raises(TypeError):
        step(router, LLR, 0, syn.double(), other, done, v, ALPHA)
    with pytest.raises(ValueError):
        step(router, LLR, 0, syn, other, done.int(), v, ALPHA)
    with pytest.raises(ValueError):
        step(router, LLR, 0, syn, other, done[:4], v, ALPHA)
    with pytest.raises(ValueError):
        step(router, LLR, 0, syn, other, done, v[:, :4], ALPHA)


def test_shard_router_needs_a_dividing_axis():
    graph = CodeGraphs.build(construct_code(*CODES["610"])).x
    with pytest.raises(ValueError, match="must divide"):
        ShardRouter(graph, 3, 0)


def test_launcher_signature_matches_argtypes():
    src = (build.CSRC_DIR / "sharded_min_sum_step.cu").read_text()
    sig = re.search(r'extern "C" int qec_sharded_min_sum_step\(([^)]*)\)', src).group(1)
    assert len(sig.split(",")) == len(sharded_step_cuda.ARGTYPES)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("last", [0, 1])
def test_kernel_bit_exact_vs_plain(router, last, cuda_device):
    args = [a.to(cuda_device) for a in inputs(router, 64, 11)]
    before = sharded_step_cuda.launches
    got = sharded_step_cuda.sharded_min_sum_step(router, LLR, last, *args,
                                                 ALPHA)
    want = sharded_step_cuda.sharded_min_sum_step_plain(router, LLR, last,
                                                        *args, ALPHA)
    torch.cuda.synchronize()
    assert sharded_step_cuda.launches == before + 1
    for a, b in zip(got, want):
        assert_same(a.cpu(), b.cpu())
    assert got[0].isnan().any() and got[0].isinf().any()


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,fold", [(1, False), (2, True), (4, False),
                                        (4, True), (8, False), (16, False),
                                        (16, True), (32, False)])
@pytest.mark.parametrize("shard", [("5210", 2, 1), ("42", 3, 2)],
                         ids=lambda c: f"{c[0]}-G{c[1]}-g{c[2]}")
def test_every_launch_shape_bit_exact(shard, lanes, fold, cuda_device):
    """Every lanes-per-CTA and partials route the plan can choose (16 and
    32 lanes put [[5210,521]]'s state in the global slab), at a batch that
    is no multiple of the lanes."""
    code_name, G, g = shard
    router = ShardRouter(CodeGraphs.build(construct_code(*CODES[code_name])).x,
                         G, g)
    shape = sharded_step_cuda.plan(
        router, placement.smem_optin(cuda_device.index), lanes, fold)
    args = [a.to(cuda_device) for a in inputs(router, 100, 13)]
    for last in (0, 1):
        got = sharded_step_cuda.sharded_min_sum_step(router, LLR, last, *args,
                                                     ALPHA, shape)
        want = sharded_step_cuda.sharded_min_sum_step_plain(router, LLR, last,
                                                            *args, ALPHA)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert_same(a.cpu(), b.cpu())
