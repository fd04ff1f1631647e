"""The port's LiftedGraph (decoder/lifted.py) against the JAX package's.

The same random NumPy tensors go through both packages' routing
(``to_var``, ``to_check``), the syndrome, ``expand_checks`` and
``expand_vars``; the results must be equal exactly (they are data movement
and integer sums).  Cases: the gross code [[144,12,12]], [[90,8,10]] (a B
polynomial with a constant term), the d=4 toric code and an HGP code (whose
shifts are negative before normalisation), on both the X and Z graphs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qec_ldpc_tpu import codes as jax_codes
from qec_ldpc_tpu.codes import construct_code as jax_construct_code
from qec_ldpc_tpu.decoder.lifted import LiftedGraph as JaxLiftedGraph
from qec_ldpc_tpu_torch import codes
from qec_ldpc_tpu_torch.convert import graph_from_jax
from qec_ldpc_tpu_torch.decoder.decode import CodeGraphs
from qec_ldpc_tpu_torch.decoder.lifted import LiftedGraph

CODES = {
    "gross": lambda c: c.known_bicycle_code("[[144,12,12]]"),
    "bb90": lambda c: c.known_bicycle_code("[[90,8,10]]"),
    "toric4": lambda c: c.toric_code(4),
    "hgp7": lambda c: c.hgp_code(7, 7, "1 + x + x3", "1 + y + y3"),
}
BATCH = 5

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


@pytest.fixture(scope="module",
                params=[(c, s) for c in CODES for s in "xz"],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    name, side = request.param
    port = getattr(CODES[name](codes).build_graphs(), side)
    ref = getattr(CODES[name](jax_codes).build_graphs(), side)
    return port, ref


def test_fields_and_rank_tables_match_jax(pair):
    tg, jg = pair
    for field in ("group", "num_check_blocks", "num_var_blocks",
                  "check_blocks", "var_blocks", "shifts", "check_degree",
                  "var_degree", "_var_rank_edges", "_var_pos"):
        assert getattr(tg, field) == getattr(jg, field), field
    for field in ("P", "num_checks", "num_vars", "num_edges", "num_edge_blocks"):
        assert getattr(tg, field) == getattr(jg, field), field
    converted = graph_from_jax(jg)
    assert converted._var_rank_edges == jg._var_rank_edges
    assert converted._var_pos == jg._var_pos
    assert converted.shifts == jg.shifts


def test_dense_pcm_matches_jax(pair):
    tg, jg = pair
    np.testing.assert_array_equal(tg.dense_pcm(), jg.dense_pcm())


@pytest.mark.parametrize("op", ["to_var", "to_check"])
def test_routing_matches_jax(pair, op):
    tg, jg = pair
    x = np.random.default_rng(1).standard_normal(
        (tg.num_edges, BATCH)).astype(np.float32)
    got = getattr(tg, op)(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(getattr(jg, op))(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    back = {"to_var": tg.to_check, "to_check": tg.to_var}[op]
    np.testing.assert_array_equal(back(torch.from_numpy(got)).numpy(), x)


def test_syndrome_matches_jax_and_dense(pair):
    tg, jg = pair
    err = (np.random.default_rng(2).random((tg.num_vars, BATCH)) < 0.2
           ).astype(np.int32)
    got = tg.syndrome(torch.from_numpy(err))
    want = np.asarray(jax.jit(jg.syndrome)(jnp.asarray(err)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    dense = tg.dense_pcm().astype(np.int64) @ err % 2
    np.testing.assert_array_equal(got.numpy(), dense)


def test_expand_checks_and_vars_match_jax(pair):
    tg, jg = pair
    rng = np.random.default_rng(3)
    s = rng.standard_normal((tg.num_checks, BATCH)).astype(np.float32)
    g = rng.standard_normal((tg.num_vars, BATCH)).astype(np.float32)
    np.testing.assert_array_equal(
        tg.expand_checks(torch.from_numpy(s)).numpy(),
        np.asarray(jg.expand_checks(jnp.asarray(s))))
    np.testing.assert_array_equal(
        tg.expand_vars(torch.from_numpy(g)).numpy(),
        np.asarray(jax.jit(jg.expand_vars)(jnp.asarray(g))))


def test_views_match_jax(pair):
    tg, jg = pair
    x = np.arange(tg.num_edges * BATCH, dtype=np.float32).reshape(-1, BATCH)
    np.testing.assert_array_equal(tg.cn_view(torch.from_numpy(x)).numpy(),
                                  np.asarray(jg.cn_view(jnp.asarray(x))))
    np.testing.assert_array_equal(tg.vn_view(torch.from_numpy(x)).numpy(),
                                  np.asarray(jg.vn_view(jnp.asarray(x))))


@pytest.mark.parametrize("side", ["x", "z"])
def test_from_circulant_equals_circulant_graph(side):
    """On [[42]], the 1-D lifted graph routes exactly as the circulant one."""
    params = (3, 3, 6, 7, 2, 3)
    code = codes.construct_code(*params)
    cg = getattr(CodeGraphs.build(code), side)
    lg = LiftedGraph.from_circulant(cg.table, cg.P)
    jl = JaxLiftedGraph.from_circulant(
        getattr(jax_construct_code(*params), "hc" if side == "x" else "hd"), 7)
    assert lg._var_rank_edges == jl._var_rank_edges
    assert (lg.check_degree, lg.var_degree) == (cg.check_degree, cg.var_degree)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((cg.num_edges, 3)).astype(np.float32))
    e = torch.from_numpy((rng.random((cg.num_vars, 3)) < 0.3).astype(np.int32))
    for op in ("to_var", "to_check"):
        assert torch.equal(getattr(lg, op)(x), getattr(cg, op)(x))
    assert torch.equal(lg.syndrome(e), cg.syndrome(e))
    assert torch.equal(lg.expand_vars(e), cg.expand_vars(e))
    np.testing.assert_array_equal(
        lg.dense_pcm(), code.pcm_x if side == "x" else code.pcm_z)


@pytest.mark.parametrize("edges,match", [
    ([(0, 0, 1), (0, 1, 2), (1, 0, 3)], "non-uniform check degrees"),
    ([(0, 0, 1), (0, 0, 2), (1, 0, 3), (1, 1, 4)], "non-uniform var degrees"),
])
def test_non_uniform_degrees_raise(edges, match):
    with pytest.raises(ValueError, match=match):
        LiftedGraph.build(2, 2, 5, edges)
    with pytest.raises(ValueError, match=match):
        JaxLiftedGraph.build(2, 2, 5, edges)


def test_index_is_cached_per_device():
    g = codes.toric_code(3).build_graphs().x
    assert g.index("to_var", "cpu") is g.index("to_var", "cpu")
    with pytest.raises(ValueError, match="unknown routing index"):
        g.index("sideways", "cpu")
