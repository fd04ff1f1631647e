"""Host OSD in the port against the JAX package on the CPU: the native
solver (the port's own build of gf2.cpp), both single-lane plain versions,
``OSDecoder.decode`` and ``CSSPostprocessor.apply``; and the build raising
instead of falling back."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qec_ldpc_tpu import native as jax_native
from qec_ldpc_tpu.codes import construct_code
from qec_ldpc_tpu.codes import known_bicycle_code as jax_known_bicycle_code
from qec_ldpc_tpu.decoder import BPConfig as JaxBPConfig
from qec_ldpc_tpu.decoder import CodeGraphs as JaxCodeGraphs
from qec_ldpc_tpu.decoder import CSSPostprocessor as JaxCSSPostprocessor
from qec_ldpc_tpu.decoder import OSDecoder as JaxOSDecoder
from qec_ldpc_tpu.decoder import decode_batch as jax_decode_batch
from qec_ldpc_tpu.decoder.osd import _osd_one_np as jax_osd_one_np
from qec_ldpc_tpu_torch import native
from qec_ldpc_tpu_torch.convert import graphs_from_jax
from qec_ldpc_tpu_torch.decoder import (
    SYNDROME_FAIL_X,
    SYNDROME_FAIL_Z,
    CSSPostprocessor,
    DecodeResult,
    OSDecoder,
)
from qec_ldpc_tpu_torch.decoder.osd import _osd_one_np

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

CODES = {"42": lambda: construct_code(3, 3, 6, 7, 2, 3),
         "610": lambda: construct_code(4, 5, 10, 61, 9, 49),
         "gross": lambda: jax_known_bicycle_code("[[144,12,12]]")}


def matrix(code: str, side: str) -> np.ndarray:
    c = CODES[code]()
    return np.asarray(c.pcm_x if side == "x" else c.pcm_z, dtype=np.uint8) % 2


@pytest.mark.parametrize("lam", [0, 1, 6, 60])
@pytest.mark.parametrize("code,side", [(c, s) for c in CODES for s in "xz"])
def test_native_osd_batch_matches_jax(code, side, lam):
    """The port's osd_batch equals JAX's native osd_batch and both
    single-lane plain versions on decodable and random syndromes."""
    h = matrix(code, side)
    m, n = h.shape
    rng = np.random.default_rng(lam + 7 * len(code) + ord(side))
    lanes = 12
    e_true = (rng.random((n, lanes)) < 0.05).astype(np.uint8)
    syn = (h.astype(np.int64) @ e_true % 2).astype(np.uint8)
    syn[:, -4:] = rng.integers(0, 2, (m, 4))
    rel = rng.standard_normal((n, lanes)).astype(np.float32)
    order = np.argsort(rel, axis=0, kind="stable").T.astype(np.int32)
    packed_cols, _ = native.pack_rows(h.T)
    packed_syn, _ = native.pack_rows(syn.T)
    e, ok = native.osd_batch(packed_cols, m, order, packed_syn, lam)
    assert ok[:-4].all()
    want = jax_native.osd_batch(jax_native.pack_rows(h.T)[0], m, order,
                                jax_native.pack_rows(syn.T)[0], lam)
    if want is not None:  # None: the JAX package's library did not build
        np.testing.assert_array_equal(e, want[0])
        np.testing.assert_array_equal(ok, want[1])
    # the single-lane plain versions are slow in Python: a few lanes each
    cols_bits = np.ascontiguousarray(h.T)
    for b in (0, 1, lanes - 1):
        for one in (_osd_one_np, jax_osd_one_np):
            e1, ok1 = one(cols_bits, syn[:, b], order[b], lam)
            assert bool(ok[b]) == ok1
            np.testing.assert_array_equal(e[b], e1)


def test_pack_rows_round_trip():
    rng = np.random.default_rng(2)
    m = rng.integers(0, 2, (9, 131)).astype(np.uint8)
    packed, words = native.pack_rows(m)
    assert words == 3 and packed.dtype == np.uint64
    np.testing.assert_array_equal(packed, jax_native.pack_rows(m)[0])
    np.testing.assert_array_equal(native.unpack_rows(packed, 131), m)


@pytest.mark.parametrize("lam", [0, 3, 60])
def test_osdecoder_decode_matches_jax_host(lam):
    h = matrix("610", "z")
    m, n = h.shape
    rng = np.random.default_rng(lam)
    e_true = (rng.random((n, 9)) < 0.04).astype(np.int64)
    syn = (h @ e_true) % 2
    rel = rng.standard_normal((n, 9)).astype(np.float32)
    rel[rng.random((n, 9)) < 0.1] = 0.0  # ties
    e_j, ok_j = JaxOSDecoder(h, lam=lam, device="host").decode(syn, rel)
    for device in ("auto", "host"):
        e, ok = OSDecoder(h, lam=lam, device=device).decode(syn, rel)
        np.testing.assert_array_equal(e.numpy(), e_j)
        np.testing.assert_array_equal(ok.numpy(), ok_j)


def test_osdecoder_routes():
    h = matrix("42", "x")
    assert OSDecoder(h, lam=0)._dev is not None
    assert OSDecoder(h, lam=0, device="host")._dev is None
    assert OSDecoder(h, lam=2)._dev is None
    for bad in ("device", "tpu"):
        with pytest.raises(ValueError):
            OSDecoder(h, device=bad)


@pytest.mark.parametrize("lam", [0, 4])
@pytest.mark.parametrize("algorithm", ["min-sum", "layered-min-sum"])
def test_css_postprocessor_matches_jax(algorithm, lam):
    """apply() on shared syndromes and soft outputs gives JAX's spliced
    decisions and error codes; every repaired lane re-encodes to its
    syndrome."""
    jg = JaxCodeGraphs.build(construct_code(3, 3, 6, 7, 2, 3))
    tg = graphs_from_jax(jg)
    rng = np.random.default_rng(4)
    n, batch = jg.code.n, 64
    xe = (rng.random((n, batch)) < 0.12).astype(np.int32)
    ze = (rng.random((n, batch)) < 0.12).astype(np.int32)
    sx = np.asarray(jg.x.syndrome(jnp.asarray(xe)))
    sz = np.asarray(jg.z.syndrome(jnp.asarray(ze)))
    cfg = JaxBPConfig(max_iters=15, algorithm=algorithm, kernel="xla",
                      return_soft=True)
    res = jax_decode_batch(jg, jnp.asarray(sx), jnp.asarray(sz), 0.02, cfg)
    ec0 = np.asarray(res.error_code)
    assert ((ec0 & SYNDROME_FAIL_X) != 0).any(), "no BP failures; raise p"
    want = JaxCSSPostprocessor(jg, lam=lam, device="host").apply(sx, sz, res)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    tres = DecodeResult(decisions_x=t(res.decisions_x),
                        decisions_z=t(res.decisions_z),
                        error_code=t(res.error_code), iters_x=None,
                        iters_z=None, iter_samples_x=None, iter_samples_z=None,
                        soft_x=t(res.soft_x), soft_z=t(res.soft_z))
    got = CSSPostprocessor(tg, lam=lam).apply(t(sx), t(sz), tres)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    dx, dz, ec = got
    assert ((ec & (SYNDROME_FAIL_X | SYNDROME_FAIL_Z)) == 0).all()
    assert torch.equal(tg.x.syndrome(dx.to(torch.int32)), t(sx))
    assert torch.equal(tg.z.syndrome(dz.to(torch.int32)), t(sz))


def test_apply_needs_soft_outputs():
    tg = graphs_from_jax(JaxCodeGraphs.build(construct_code(3, 3, 6, 7, 2, 3)))
    z = torch.zeros((42, 2), dtype=torch.int8)
    res = DecodeResult(decisions_x=z, decisions_z=z,
                       error_code=torch.zeros(2, dtype=torch.int32),
                       iters_x=None, iters_z=None, iter_samples_x=None,
                       iter_samples_z=None)
    s = torch.zeros((21, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="return_soft"):
        CSSPostprocessor(tg).apply(s, s, res)


def test_library_build_raises_without_compiler(tmp_path):
    """No fallback: a compiler that cannot run raises."""
    missing = str(tmp_path / "no-such-g++")
    with pytest.raises(RuntimeError, match="cannot build"):
        native.library(tmp_path, missing)


def test_host_osd_raises_when_library_cannot_build(tmp_path, monkeypatch):
    """The host route raises instead of solving some other way."""
    monkeypatch.setattr(native, "library", functools.partial(
        native.library.__wrapped__, tmp_path, str(tmp_path / "no-such-g++")))
    h = matrix("42", "x")
    with pytest.raises(RuntimeError):
        OSDecoder(h, lam=2).decode(np.zeros((h.shape[0], 3), np.uint8),
                                   np.zeros((h.shape[1], 3), np.float32))


def test_library_name_keys_on_host_and_source():
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert native.host_tag() in path.name and path.suffix == ".so"
