"""What the sum-product kernel (csrc/bp_sum_product.cu) rests on, checked
on the CPU against the JAX package.

* ``sum_product.bp_run_lanes``, the per-lane iteration reference the card
  tests hold the kernel's ``iters`` to: its messages are JAX ``bp_run``'s on
  the batch, bit for bit, and each lane's count is JAX ``bp_run``'s count
  for that lane decoded alone, early exit and fixed work, on [[42]] and a
  small [[610,61]] batch.  The same NumPy syndromes feed both packages.
* ``placement.bp_plan``, the owner of a lane's placement: V and E in shared
  memory while they fit in the device's limit, the rest in the lane's slab.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qec_ldpc_tpu.codes import construct_code as jax_construct_code
from qec_ldpc_tpu.decoder import CodeGraphs as JaxCodeGraphs
from qec_ldpc_tpu.decoder import bp_run as jax_bp_run
from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.codes import find_code_params
from qec_ldpc_tpu_torch.convert import graph_from_jax
from qec_ldpc_tpu_torch.decoder import sum_product
from qec_ldpc_tpu_torch.decoder.decode import CodeGraphs
from qec_ldpc_tpu_torch.kernels import placement

CODES = {"42": ((3, 3, 6, 7, 2, 3), 3, 24), "610": ((4, 5, 10, 61, 9, 49), 48, 16)}
PRIOR = np.float32(2.0 / 3.0) * np.float32(0.01)
LANES_ALONE = 6
H100_SMEM = 232448

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


def np_syndrome(jg, n, weight, batch, seed):
    """Syndromes of weight-``weight`` bit errors (weights 1..weight, so the
    lanes converge at different tests), from NumPy draws."""
    rng = np.random.default_rng(seed)
    e = np.zeros((n, batch), np.int32)
    for lane in range(batch):
        w = 1 + lane % weight
        e[rng.choice(n, w, replace=False), lane] = 1
    return np.array(jax.jit(jg.syndrome)(jnp.asarray(e)))


def assert_bits_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    np.testing.assert_array_equal(nan_g, nan_w)
    np.testing.assert_array_equal(got[~nan_g].view(np.int32),
                                  want[~nan_w].view(np.int32))


@pytest.fixture(scope="module", params=[(c, s) for c in CODES for s in "xz"],
                ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    code_name, side = request.param
    params, weight, batch = CODES[code_name]
    code = jax_construct_code(*params)
    jg = getattr(JaxCodeGraphs.build(code), side)
    return jg, graph_from_jax(jg), np_syndrome(jg, code.n, weight, batch, 5)


@pytest.mark.parametrize("max_iters,check_every", [(100, 10), (40, 1), (7, 8)],
                         ids=["early-exit", "early-exit-1", "fixed-7"])
def test_lane_iters_equal_jax_on_each_lane_alone(case, max_iters, check_every):
    jg, tg, syn = case
    v_l, lanes = sum_product.bp_run_lanes(tg, torch.from_numpy(syn),
                                          torch.tensor(PRIOR), max_iters,
                                          check_every)
    v_j, n_j = jax_bp_run(jg, jnp.asarray(syn), jnp.float32(PRIOR),
                          max_iters=max_iters, check_every=check_every)
    assert_bits_equal(v_l.numpy(), v_j)
    assert lanes.dtype == torch.int32 and lanes.shape == (syn.shape[1],)
    assert int(lanes.max()) == int(n_j)
    for i in range(LANES_ALONE):
        lane = (i * syn.shape[1]) // LANES_ALONE
        _, n_alone = jax_bp_run(jg, jnp.asarray(syn[:, lane:lane + 1]),
                                jnp.float32(PRIOR), max_iters=max_iters,
                                check_every=check_every)
        assert int(lanes[lane]) == int(n_alone)
    if check_every == 1:
        assert len(set(lanes.tolist())) > 1  # the lanes really differ
    if check_every > max_iters:  # only the test at n = 0 can stop a lane
        assert set(lanes.tolist()) <= {1, max_iters}


def test_bp_run_counts_the_batch():
    """``bp_run`` and ``bp_run_lanes`` share one loop: the same messages,
    and the batch count is the lanes' maximum."""
    g = CodeGraphs.build(construct_code(*CODES["42"][0])).x
    syn = (torch.rand((g.num_checks, 32), generator=torch.Generator()
                      .manual_seed(3)) < 0.2).to(torch.int32)
    v, n = sum_product.bp_run(g, syn, torch.tensor(PRIOR), 60, 4)
    v_l, lanes = sum_product.bp_run_lanes(g, syn, torch.tensor(PRIOR), 60, 4)
    assert_bits_equal(v.numpy(), v_l.numpy())
    assert int(n) == int(lanes.max())


def aligned(n):
    return (n + 15) // 16 * 16


def test_plan_keeps_the_main_path_on_chip():
    """[[610,61]] (the headline) and the P=521 codes hold V and E in an
    H100's shared memory; P=1051 puts E in the slab and keeps V; P=4201
    puts both in the slab.  Every plan fits a CTA's shared memory."""
    g610 = CodeGraphs.build(construct_code(4, 5, 10, 61, 9, 49))
    g521 = CodeGraphs.build(construct_code(4, 5, 10, 521, 25, 1))
    for graph in (g610.x, g610.z, g521.x, g521.z):
        pl = placement.bp_plan(graph, H100_SMEM)
        assert (pl.v_shared, pl.e_shared, pl.slab_floats) == (True, True, 0)
        assert pl.smem_bytes == aligned(graph.num_checks) + 2 * aligned(4 * graph.num_edges)
    assert placement.bp_plan(g610.x, H100_SMEM).threads == 320
    assert placement.bp_plan(g521.z, H100_SMEM).threads == 1024
    probes = {}
    for P in (1051, 4201):
        s, t = find_code_params(4, 5, 10, P)[0]
        probes[P] = CodeGraphs.build(construct_code(4, 5, 10, P, s, t))
    for graph in (probes[1051].x, probes[1051].z):
        pl = placement.bp_plan(graph, H100_SMEM)
        assert pl.v_shared and not pl.e_shared
        assert pl.slab_floats == aligned(4 * graph.num_edges) // 4
    p4 = placement.bp_plan(probes[4201].z, H100_SMEM)
    assert not p4.v_shared and not p4.e_shared
    assert p4.slab_floats == 2 * aligned(4 * probes[4201].z.num_edges) // 4
    for graph in (probes[1051].x, probes[1051].z, probes[4201].x,
                  probes[4201].z, g610.x):
        pl = placement.bp_plan(graph, H100_SMEM)
        assert pl.smem_bytes <= H100_SMEM
        assert pl.threads % 32 == 0 and 128 <= pl.threads <= 1024


@pytest.mark.parametrize("limit", [8 * 1024, 24 * 1024, 48 * 1024, H100_SMEM])
def test_plan_follows_the_device_limit(limit):
    """A device that lets a CTA take less shared memory gets the same kernel
    with more of the lane in its slab: everything on chip, E in the slab, or
    both in the slab, in order while they fit."""
    graph = CodeGraphs.build(construct_code(4, 5, 10, 61, 9, 49)).z
    syn_bytes = aligned(graph.num_checks)
    msg = aligned(4 * graph.num_edges)
    pl = placement.bp_plan(graph, limit)
    assert pl.smem_bytes <= limit
    assert pl.v_shared == (syn_bytes + msg <= limit)
    assert pl.e_shared == (syn_bytes + msg * (1 + pl.v_shared) <= limit)
    assert pl.slab_floats * 4 == msg * ((not pl.v_shared) + (not pl.e_shared))
    assert pl.smem_bytes == syn_bytes + msg * (pl.v_shared + pl.e_shared)
