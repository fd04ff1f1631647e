"""The port's decode sanitizer (decoder/validate.py): the five cases of the
JAX package's tests/test_validate.py on the port's plain decode, and the
port's and JAX's ``validate_decode_result`` giving the same problem lists
on the same syndromes."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qec_ldpc_tpu.codes import construct_code as jax_construct_code
from qec_ldpc_tpu.decoder import BPConfig as JaxBPConfig
from qec_ldpc_tpu.decoder.decode import (
    CodeGraphs as JaxCodeGraphs,
    decode_batch as jax_decode_batch,
)
from qec_ldpc_tpu.decoder.validate import (
    validate_decode_result as jax_validate_decode_result,
)
from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.decoder import BPConfig, CodeGraphs, decode_batch
from qec_ldpc_tpu_torch.decoder.validate import (
    FloatCheckError,
    checked_decode_batch,
    validate_decode_result,
)
from qec_ldpc_tpu_torch.sampling import sample_weight_w_errors

torch.set_num_threads(1)

PARAMS = (3, 3, 6, 7, 2, 3)


@pytest.fixture(scope="module")
def graphs():
    return CodeGraphs.build(construct_code(*PARAMS))


@pytest.fixture(scope="module")
def syndromes(graphs):
    xe, ze = sample_weight_w_errors(torch.Generator().manual_seed(0),
                                    graphs.code.n, 3, 16)
    return (graphs.x.syndrome(xe.to(torch.int32)),
            graphs.z.syndrome(ze.to(torch.int32)))


def test_healthy_short_decode_passes_float_checks(graphs, syndromes):
    """Before message saturation (~8 iterations on easy syndromes) a
    healthy decode is float-clean end to end."""
    sx, sz = syndromes
    err, res = checked_decode_batch(graphs, sx, sz, 0.02,
                                    BPConfig(max_iters=5))
    err.throw()
    assert err.get() is None
    assert res.decisions_x.shape == (graphs.code.n, 16)


def test_saturation_signature_on_long_runs(graphs, syndromes):
    """Long healthy runs trip the known-benign signature, a division by
    zero in the (masked) VN posterior once messages saturate, while the
    outputs stay structurally valid."""
    sx, sz = syndromes
    err, _ = checked_decode_batch(graphs, sx, sz, 0.02, BPConfig(max_iters=20))
    assert err.get() is not None and "division" in err.get()
    res = decode_batch(graphs, sx, sz, 0.02,
                       BPConfig(max_iters=20, return_soft=True))
    assert validate_decode_result(graphs, sx, sz, res) == []


def test_degenerate_prior_is_caught_before_saturation(graphs, syndromes):
    """prior = 1.0 (error_probability = 1.5 with the 2/3 factor) breaks the
    decode within the first iterations, at a max_iters where a healthy
    decode is float-clean."""
    sx, sz = syndromes
    err, _ = checked_decode_batch(graphs, sx, sz, 1.5, BPConfig(max_iters=5))
    with pytest.raises(FloatCheckError, match="nan|inf|division"):
        err.throw()


def test_validate_decode_result_clean(graphs, syndromes):
    sx, sz = syndromes
    res = decode_batch(graphs, sx, sz, 0.02,
                       BPConfig(max_iters=20, return_soft=True))
    assert validate_decode_result(graphs, sx, sz, res) == []


def test_validate_decode_result_detects_tampering(graphs, syndromes):
    sx, sz = syndromes
    res = decode_batch(graphs, sx, sz, 0.02,
                       BPConfig(max_iters=20, return_soft=True))
    # one flipped decision bit: the re-encoded syndrome no longer matches
    # the SYNDROME_FAIL flag of that lane
    dx = res.decisions_x.clone()
    dx[0, 0] ^= 1
    probs = validate_decode_result(graphs, sx, sz,
                                   dataclasses.replace(res, decisions_x=dx))
    assert any("SYNDROME_FAIL_X" in p for p in probs)
    soft = res.soft_z.clone()
    soft[3, 3] = float("nan")
    probs = validate_decode_result(graphs, sx, sz,
                                   dataclasses.replace(res, soft_z=soft))
    assert any("soft_z" in p for p in probs)


@pytest.mark.parametrize("algorithm,max_iters", [
    ("sum-product", 5), ("min-sum", 20), ("layered-min-sum", 20)])
def test_checked_decode_equals_plain_decode(graphs, syndromes, algorithm,
                                            max_iters):
    """The checks observe the decode and change nothing: the checked
    result equals ``decode_batch``'s, and the LLR decoders stay clean."""
    sx, sz = syndromes
    cfg = BPConfig(max_iters=max_iters, algorithm=algorithm, return_soft=True)
    err, got = checked_decode_batch(graphs, sx, sz, 0.02, cfg)
    want = decode_batch(graphs, sx, sz, 0.02, cfg)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert torch.equal(a, b), f.name
    if algorithm != "sum-product":
        assert err.get() is None


def _tamper(res, kind, replace, clone, flip):
    if kind == "flip":
        return replace(res, decisions_x=flip(res.decisions_x))
    if kind == "nan":
        soft = clone(res.soft_z)
        soft[3, 3] = np.nan
        return replace(res, soft_z=soft)
    return res


@pytest.mark.parametrize("kind", ["clean", "flip", "nan"])
def test_problem_lists_match_jax(kind):
    """The same syndromes decoded by both packages (bit-equal on the CPU)
    and tampered the same way give the same problem lists."""
    rng = np.random.default_rng(7)
    ours = CodeGraphs.build(construct_code(*PARAMS))
    theirs = JaxCodeGraphs.build(jax_construct_code(*PARAMS))
    e = rng.integers(0, 2, (ours.code.n, 32)) * (rng.random((ours.code.n, 32)) < 0.06)
    sx = ours.x.syndrome(torch.from_numpy(e.astype(np.int32)))
    sz = ours.z.syndrome(torch.from_numpy(np.roll(e, 1, axis=0).astype(np.int32)))
    res = decode_batch(ours, sx, sz, 0.02,
                       BPConfig(max_iters=20, algorithm="min-sum",
                                return_soft=True))
    jsx, jsz = jnp.asarray(sx.numpy()), jnp.asarray(sz.numpy())
    jres = jax_decode_batch(theirs, jsx, jsz, 0.02,
                            JaxBPConfig(max_iters=20, algorithm="min-sum",
                                        kernel="xla", return_soft=True))
    np.testing.assert_array_equal(res.error_code.numpy(),
                                  np.asarray(jres.error_code))

    def flip_t(d):
        d = d.clone()
        d[0, :3] ^= 1
        return d

    def flip_j(d):
        d = np.asarray(d).copy()
        d[0, :3] ^= 1
        return jnp.asarray(d)

    res = _tamper(res, kind, dataclasses.replace, torch.clone, flip_t)
    jres = _tamper(jres, kind, dataclasses.replace,
                   lambda a: np.asarray(a).copy(), flip_j)
    if kind == "nan":
        jres = dataclasses.replace(jres, soft_z=jnp.asarray(jres.soft_z))
    got = validate_decode_result(ours, sx, sz, res)
    assert got == jax_validate_decode_result(theirs, jsx, jsz, jres)
    assert (got == []) == (kind == "clean")
