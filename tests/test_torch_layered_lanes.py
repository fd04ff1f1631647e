"""The per-lane sweep reference of the layered kernel (csrc/layered_min_sum.cu),
checked on the CPU against the JAX package.

``layered.layered_min_sum_run_lanes`` is what the card tests hold the
kernel's ``iters`` to: its posteriors are JAX ``layered_min_sum_run``'s on
the batch, bit for bit; the lanes' maximum is JAX's sweep count; and each
lane's count is JAX's count for that lane decoded alone, over several
``(max_iters, check_every)`` pairs, on [[42]] and a small [[610,61]] batch.
The same NumPy syndromes feed both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qec_ldpc_tpu.codes import construct_code as jax_construct_code
from qec_ldpc_tpu.decoder import CodeGraphs as JaxCodeGraphs
from qec_ldpc_tpu.decoder.layered import layered_min_sum_run as jax_layered_run
from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.convert import graph_from_jax, prior_llr_from_jax
from qec_ldpc_tpu_torch.decoder import layered
from qec_ldpc_tpu_torch.decoder.decode import CodeGraphs

# code -> (construct_code parameters, largest error weight, batch)
CODES = {"42": ((3, 3, 6, 7, 2, 3), 4, 24), "610": ((4, 5, 10, 61, 9, 49), 40, 16)}
PRIOR = np.float32(2.0 / 3.0) * np.float32(0.01)
LANES_ALONE = 6

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


def np_syndrome(jg, n, weight, batch, seed):
    """Syndromes of bit errors of weights spread over 1..weight (so the
    lanes converge at different sweeps, or not at all), from NumPy draws."""
    rng = np.random.default_rng(seed)
    e = np.zeros((n, batch), np.int32)
    for lane in range(batch):
        w = 1 + (lane * weight) // batch
        e[rng.choice(n, w, replace=False), lane] = 1
    return np.array(jax.jit(jg.syndrome)(jnp.asarray(e)))


def assert_bits_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    np.testing.assert_array_equal(nan_g, nan_w)
    np.testing.assert_array_equal(got[~nan_g].view(np.int32),
                                  want[~nan_w].view(np.int32))


@pytest.fixture(scope="module")
def llr():
    p = jnp.float32(PRIOR)
    return prior_llr_from_jax(jax.jit(lambda p: jnp.log1p(-p) - jnp.log(p))(p))


@pytest.fixture(scope="module", params=[(c, s) for c in CODES for s in "xz"],
                ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    code_name, side = request.param
    params, weight, batch = CODES[code_name]
    code = jax_construct_code(*params)
    jg = getattr(JaxCodeGraphs.build(code), side)
    return jg, graph_from_jax(jg), np_syndrome(jg, code.n, weight, batch, 5)


@pytest.mark.parametrize("max_iters,check_every", [(100, 1), (40, 3), (30, 2),
                                                   (7, 8)],
                         ids=["early-exit-1", "every-3", "every-2", "fixed-7"])
def test_lane_sweeps_equal_jax_on_each_lane_alone(case, llr, max_iters,
                                                  check_every):
    jg, tg, syn = case
    q_l, lanes = layered.layered_min_sum_run_lanes(
        tg, torch.from_numpy(syn), llr, max_iters, check_every)
    q_j, n_j = jax_layered_run(jg, jnp.asarray(syn), jnp.float32(PRIOR),
                               max_iters=max_iters, check_every=check_every)
    assert_bits_equal(q_l.numpy(), q_j)
    assert lanes.dtype == torch.int32 and lanes.shape == (syn.shape[1],)
    assert int(lanes.max()) == int(n_j)
    for i in range(LANES_ALONE):
        lane = (i * syn.shape[1]) // LANES_ALONE
        q_a, n_alone = jax_layered_run(
            jg, jnp.asarray(syn[:, lane:lane + 1]), jnp.float32(PRIOR),
            max_iters=max_iters, check_every=check_every)
        assert int(lanes[lane]) == int(n_alone)
        assert_bits_equal(q_l.numpy()[:, lane:lane + 1], q_a)
    # a lane stops only at a test (n % k == k - 1) or at the cap
    assert all(n % check_every == 0 or n == max_iters for n in lanes.tolist())
    if check_every < max_iters:
        assert len(set(lanes.tolist())) > 1  # the lanes really differ
    else:
        assert set(lanes.tolist()) == {max_iters}


def test_layered_run_counts_the_batch():
    """``layered_min_sum_run`` and ``layered_min_sum_run_lanes`` share one
    loop: the same posteriors, and the batch count is the lanes'
    maximum."""
    g = CodeGraphs.build(construct_code(*CODES["42"][0])).z
    syn = (torch.rand((g.num_checks, 32), generator=torch.Generator()
                      .manual_seed(3)) < 0.2).to(torch.int32)
    llr = 4.5
    q, n = layered.layered_min_sum_run(g, syn, llr, 60, 2)
    q_l, lanes = layered.layered_min_sum_run_lanes(g, syn, llr, 60, 2)
    assert_bits_equal(q.numpy(), q_l.numpy())
    assert int(n) == int(lanes.max())
    alone = [int(layered.layered_min_sum_run(g, syn[:, i:i + 1], llr, 60, 2)[1])
             for i in range(32)]
    assert lanes.tolist() == alone
