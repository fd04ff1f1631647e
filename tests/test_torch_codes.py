"""The port's own code layer (qec_ldpc_tpu_torch/codes) against the JAX
package's, exactly.

Every family the two packages build — the Hagiwara–Imai QC-CSS codes, the
bivariate bicycle codes of ``KNOWN_CODES``, toric and hypergraph-product
codes — must give the same stabilizer matrices, exponent tables, ``k`` and
logical-test matrices (``i_minus_p``), bit for bit.  Tolerance: none; these
are integer matrices.
"""

import numpy as np
import pytest

from qec_ldpc_tpu import codes as jax_codes
from qec_ldpc_tpu.codes import bicycle as jax_bicycle
from qec_ldpc_tpu.codes import hypergraph as jax_hypergraph
from qec_ldpc_tpu_torch import codes
from qec_ldpc_tpu_torch.codes import bicycle, hypergraph
from qec_ldpc_tpu_torch.convert import code_from_jax

QC_CODES = {"[[42]]": (3, 3, 6, 7, 2, 3), "[[610,61]]": (4, 5, 10, 61, 9, 49)}


def test_exports_match_jax():
    assert sorted(codes.__all__) == sorted(jax_codes.__all__)
    assert bicycle.KNOWN_CODES == jax_bicycle.KNOWN_CODES


@pytest.mark.parametrize("name", sorted(jax_bicycle.KNOWN_CODES))
def test_known_bicycle_codes_match_jax(name):
    got = codes.known_bicycle_code(name)
    want = jax_codes.known_bicycle_code(name)
    assert (got.l, got.m, got.a_terms, got.b_terms) == (
        want.l, want.m, want.a_terms, want.b_terms)
    np.testing.assert_array_equal(got.hx_stab, want.hx_stab)
    np.testing.assert_array_equal(got.hz_stab, want.hz_stab)
    assert got.k_logical == want.k_logical
    np.testing.assert_array_equal(got.i_minus_p, want.i_minus_p)
    assert str(got) == str(want)


def hgp_cases():
    return [("toric", (d,)) for d in (2, 3, 4, 6)] + [
        ("hgp", (7, 7, "1 + x + x3", "1 + y + y3")),
        ("hgp", (9, 9, "1 + x2 + x5", "1 + y + y4")),
    ]


@pytest.mark.parametrize("family,args", hgp_cases(),
                         ids=lambda c: str(c).replace(" ", ""))
def test_hypergraph_codes_match_jax(family, args):
    build = {"toric": (codes.toric_code, jax_codes.toric_code),
             "hgp": (codes.hgp_code, jax_codes.hgp_code)}[family]
    got, want = build[0](*args), build[1](*args)
    assert (got.n1, got.n2, got.h1_terms, got.h2_terms) == (
        want.n1, want.n2, want.h1_terms, want.h2_terms)
    np.testing.assert_array_equal(got.hx_stab, want.hx_stab)
    np.testing.assert_array_equal(got.hz_stab, want.hz_stab)
    assert got.k_logical == want.k_logical
    np.testing.assert_array_equal(got.i_minus_p, want.i_minus_p)
    gg, gw = got.build_graphs(), want.build_graphs()
    for side in "xz":
        np.testing.assert_array_equal(getattr(gg, side).dense_pcm(),
                                      getattr(gw, side).dense_pcm())


@pytest.mark.parametrize("name", sorted(QC_CODES))
def test_construct_code_matches_jax(name):
    params = QC_CODES[name]
    got, want = codes.construct_code(*params), jax_codes.construct_code(*params)
    np.testing.assert_array_equal(got.hc, want.hc)
    np.testing.assert_array_equal(got.hd, want.hd)
    np.testing.assert_array_equal(got.pcm_x, want.pcm_x)
    np.testing.assert_array_equal(got.pcm_z, want.pcm_z)
    np.testing.assert_array_equal(got.i_minus_p, want.i_minus_p)
    np.testing.assert_array_equal(got.i_minus_p_physical,
                                  want.i_minus_p_physical)
    assert got.k_logical == want.k_logical
    assert str(got) == str(want)


@pytest.mark.parametrize("shape,density", [((37, 101), 0.1), ((64, 64), 0.5),
                                           ((130, 70), 0.03), ((1, 5), 0.5),
                                           ((12, 200), 0.0)])
def test_gf2_rref_matches_jax(shape, density):
    """The port's bit-packed elimination gives JAX's rows and pivots (the
    RREF is unique), across word boundaries and for zero matrices."""
    m = (np.random.default_rng(shape[0]).random(shape) < density).astype(np.int8)
    got, piv = codes.gf2_rref(m)
    want, piv_j = jax_codes.gf2_rref(m)
    assert piv == piv_j
    np.testing.assert_array_equal(got, np.asarray(want, np.uint8))
    assert got.dtype == np.uint8 and got.shape == (len(piv), shape[1])


def test_find_code_params_matches_jax():
    for args in ((4, 5, 10, 61), (4, 5, 10, 131)):
        assert codes.find_code_params(*args, count=3) == \
            jax_codes.find_code_params(*args, count=3)
    assert codes.find_code_params(3, 3, 6, 7, count=4, require_girth6=True) \
        == jax_codes.find_code_params(3, 3, 6, 7, count=4, require_girth6=True)


def test_find_bicycle_codes_and_4cycles_match_jax():
    got = codes.find_bicycle_codes(6, 6, count=200, min_k=12)
    want = jax_codes.find_bicycle_codes(6, 6, count=200, min_k=12)
    assert [(c.a_terms, c.b_terms) for c in got] == [
        (c.a_terms, c.b_terms) for c in want]
    pub = codes.known_bicycle_code("[[72,12,6]]")
    assert any(h.a_terms == pub.a_terms and h.b_terms == pub.b_terms
               for h in got)
    for a, b in (("x1 + x2 + y1", "y2 + x3 + x4"), ("x3 + y + y2", "y3 + x + x2")):
        g = codes.bicycle_code(6, 6, a, b).build_graphs().z
        w = jax_codes.bicycle_code(6, 6, a, b).build_graphs().z
        assert codes.lifted_has_4cycles(g) == jax_codes.lifted_has_4cycles(w)


@pytest.mark.parametrize("a,b,match", [
    ("x3 + y + z2", "y3 + x + x2", "bad monomial"),
    ("x3 + y + y2z", "y3 + x + x2", "bad character"),
    ("x3 + y +", "y3 + x + x2", "bad monomial"),
    ("x3 + y + y", "y3 + x + x2", "duplicate"),
])
def test_bicycle_parser_is_strict(a, b, match):
    with pytest.raises(ValueError, match=match):
        bicycle.bicycle_code(12, 6, a, b)
    with pytest.raises(ValueError, match=match):
        jax_bicycle.bicycle_code(12, 6, a, b)


@pytest.mark.parametrize("h1,h2,match", [
    ("1 + z2", "1 + y", "bad term"),
    ("1 + x5", "1 + y", "duplicate"),
    ("1 + x", "1 + y + y2", "uniform var degrees"),
])
def test_hgp_parser_is_strict(h1, h2, match):
    with pytest.raises(ValueError, match=match):
        hypergraph.hgp_code(5, 5, h1, h2)
    with pytest.raises(ValueError, match=match):
        jax_hypergraph.hgp_code(5, 5, h1, h2)


def test_code_file_round_trip_matches_jax(tmp_path):
    code = codes.construct_code(*QC_CODES["[[42]]"])
    path = str(tmp_path / "code42.txt")
    codes.save_code_file(code, path)
    got, want = codes.load_code_file(path), jax_codes.load_code_file(path)
    for field in ("hc", "hd", "pcm_x", "pcm_z", "i_minus_p"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert (got.J, got.K, got.L, got.P) == (want.J, want.K, want.L, want.P)


@pytest.mark.parametrize("build", [
    lambda c: c.construct_code(*QC_CODES["[[42]]"]),
    lambda c: c.known_bicycle_code("[[144,12,12]]"),
    lambda c: c.toric_code(4),
], ids=["qc", "bicycle", "toric"])
def test_code_from_jax_rebuilds_the_port_type(build):
    want = build(codes)
    got = code_from_jax(build(jax_codes))
    assert type(got) is type(want)
    assert not type(got).__module__.startswith("qec_ldpc_tpu.")
    np.testing.assert_array_equal(got.i_minus_p, want.i_minus_p)
    assert got.k_logical == want.k_logical
