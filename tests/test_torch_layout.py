"""The port's CirculantGraph routes exactly as the JAX class does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qec_ldpc_tpu.codes import construct_code
from qec_ldpc_tpu.decoder import CodeGraphs as JaxCodeGraphs
from qec_ldpc_tpu_torch.convert import graph_from_jax

CODES = {"42": (3, 3, 6, 7, 2, 3), "610": (4, 5, 10, 61, 9, 49)}
BATCH = 16

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[(c, s) for c in CODES for s in "xz"],
                ids=lambda p: f"{p[0]}-{p[1]}")
def graphs(request):
    code, side = request.param
    jg = getattr(JaxCodeGraphs.build(construct_code(*CODES[code])), side)
    return jg, graph_from_jax(jg)


def test_sizes(graphs):
    jg, tg = graphs
    for name in ("B", "L", "P", "check_degree", "var_degree", "num_checks",
                 "num_vars", "num_edges"):
        assert getattr(tg, name) == getattr(jg, name), name
    np.testing.assert_array_equal(tg.table, jg.table)


@pytest.mark.parametrize("op", ["to_var", "to_check"])
def test_routing_exact(graphs, op):
    jg, tg = graphs
    x = np.random.default_rng(1).random((jg.num_edges, BATCH), dtype=np.float32)
    want = np.asarray(jax.jit(getattr(jg, op))(jnp.asarray(x)))
    got = getattr(tg, op)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_routing_round_trip(graphs):
    _, tg = graphs
    x = torch.arange(tg.num_edges * 3, dtype=torch.float32).reshape(-1, 3)
    assert torch.equal(tg.to_check(tg.to_var(x)), x)


def test_syndrome_exact(graphs):
    jg, tg = graphs
    e = np.random.default_rng(2).integers(0, 2, (jg.num_vars, BATCH), dtype=np.int32)
    want = np.asarray(jax.jit(jg.syndrome)(jnp.asarray(e)))
    got = tg.syndrome(torch.from_numpy(e))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_expand_checks_exact(graphs):
    jg, tg = graphs
    s = np.random.default_rng(3).random((jg.num_checks, BATCH), dtype=np.float32)
    want = np.asarray(jax.jit(jg.expand_checks)(jnp.asarray(s)))
    np.testing.assert_array_equal(tg.expand_checks(torch.from_numpy(s)).numpy(), want)


def test_expand_vars_exact(graphs):
    jg, tg = graphs
    g = np.random.default_rng(4).random((jg.num_vars, BATCH), dtype=np.float32)
    want = np.asarray(jax.jit(jg.expand_vars)(jnp.asarray(g)))
    np.testing.assert_array_equal(tg.expand_vars(torch.from_numpy(g)).numpy(), want)


def test_views_match(graphs):
    jg, tg = graphs
    x = np.arange(jg.num_edges * 2, dtype=np.float32).reshape(-1, 2)
    np.testing.assert_array_equal(tg.cn_view(torch.from_numpy(x)).numpy(),
                                  np.asarray(jg.cn_view(jnp.asarray(x))))
    np.testing.assert_array_equal(tg.vn_view(torch.from_numpy(x)).numpy(),
                                  np.asarray(jg.vn_view(jnp.asarray(x))))


def test_index_cached_per_device(graphs):
    _, tg = graphs
    a = tg.index("to_var", "cpu")
    assert tg.index("to_var", torch.device("cpu")) is a
    with pytest.raises(ValueError):
        tg.index("sideways", "cpu")
