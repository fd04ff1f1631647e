"""The port's samplers (statistically) and classifier (exactly) against the
JAX package and the closed-form distributions."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qec_ldpc_tpu.codes import construct_code
from qec_ldpc_tpu.sampling.classify import classify_batch as jax_classify_batch
from qec_ldpc_tpu.sampling.classify import classify_batch_np
from qec_ldpc_tpu.sampling.classify import make_rank_basis_test as jax_rank_basis_test
from qec_ldpc_tpu.sampling.errors import _accumulate_hits as jax_accumulate_hits
from qec_ldpc_tpu_torch.convert import rank_basis_test_from_numpy
from qec_ldpc_tpu_torch.parallel.chunk import chunk_generator
from qec_ldpc_tpu_torch.sampling import (
    NUM_COUNTERS,
    classify_batch,
    make_rank_basis_test,
    sample_depolarizing_errors,
    sample_weight_w_errors,
)
from qec_ldpc_tpu_torch.sampling.errors import _accumulate_hits

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


def z_score(count, trials, p):
    return (count - trials * p) / math.sqrt(trials * p * (1 - p))


@pytest.mark.parametrize("n,weight,batch", [(7, 6, 64), (42, 3, 128), (610, 15, 32)])
def test_accumulate_hits_exact_vs_jax(n, weight, batch):
    """Shared draws, collisions included (n=7, W=6 collides in most lanes)."""
    rng = np.random.default_rng(n)
    idx = rng.integers(0, n, (weight, batch)).astype(np.int32)
    typ = rng.integers(0, 3, (weight, batch)).astype(np.int32)
    jx, jz = jax_accumulate_hits(jnp.asarray(idx), jnp.asarray(typ), n)
    tx, tz = _accumulate_hits(torch.from_numpy(idx), torch.from_numpy(typ), n)
    assert tx.dtype == torch.int8 and tx.shape == (n, batch)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))


def test_collision_never_clears_a_bit():
    idx = torch.tensor([[0], [0], [0]])
    typ = torch.tensor([[0], [2], [0]])  # X, then Z, then X on qubit 0
    x, z = _accumulate_hits(idx, typ, 2)
    assert x[:, 0].tolist() == [1, 0] and z[:, 0].tolist() == [1, 0]


@pytest.mark.parametrize("n,weight", [(7, 5), (42, 3)])
def test_weight_w_marginals(n, weight):
    """Per (qubit, lane) cell, k ~ Binomial(W, 1/n) draws hit it; the cell
    is X-only iff every hit is x, Z-only iff every hit is z: P(X only) =
    (1 - 1/n + 1/(3n))^W - (1 - 1/n)^W, P(any) = 1 - (1 - 1/n)^W."""
    batch = 20000
    x, z = sample_weight_w_errors(chunk_generator(9, n, "cpu"), n, weight, batch)
    x, z = x.bool(), z.bool()
    cells = n * batch
    miss = (1 - 1 / n) ** weight
    p_x_only = (1 - 1 / n + 1 / (3 * n)) ** weight - miss
    p_any = 1 - miss
    for count, p in ((int((x & ~z).sum()), p_x_only),
                     (int((z & ~x).sum()), p_x_only),
                     (int((x & z).sum()), p_any - 2 * p_x_only),
                     (int((x | z).sum()), p_any)):
        # cells within a lane are negatively correlated, so the binomial
        # variance is an upper bound and |z| < 4 is conservative
        assert abs(z_score(count, cells, p)) < 4, (count, cells, p)
    assert int((x | z).sum(dim=0).max()) <= weight


def test_depolarizing_marginals():
    n, batch, p = 42, 5000, 0.05
    x, z = sample_depolarizing_errors(chunk_generator(10, 0, "cpu"), n, p, batch)
    x, z = x.bool(), z.bool()
    cells = n * batch
    for count, q in ((int((x & ~z).sum()), p / 3), (int((z & ~x).sum()), p / 3),
                     (int((x & z).sum()), p / 3)):
        assert abs(z_score(count, cells, q)) < 4, (count, q)


def test_generator_streams_are_deterministic():
    a = sample_weight_w_errors(chunk_generator(1, 5, "cpu"), 42, 3, 16)
    b = sample_weight_w_errors(chunk_generator(1, 5, "cpu"), 42, 3, 16)
    c = sample_weight_w_errors(chunk_generator(1, 6, "cpu"), 42, 3, 16)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not (torch.equal(a[0], c[0]) and torch.equal(a[1], c[1]))


@pytest.fixture(scope="module", params=[(3, 3, 6, 7, 2, 3), (4, 5, 10, 61, 9, 49)],
                ids=["42", "610"])
def classify_inputs(request):
    code = construct_code(*request.param)
    rng = np.random.default_rng(31)
    n, batch = code.n, 256
    xe = (rng.random((n, batch)) < 0.02).astype(np.int32)
    ze = (rng.random((n, batch)) < 0.02).astype(np.int32)
    xe[:, :8] = 0  # a few error-free lanes for the tested counters
    # decisions: the true error, with a few lanes off by a random flip
    xd = xe ^ (rng.random((n, batch)) < 0.004).astype(np.int32)
    zd = ze ^ (rng.random((n, batch)) < 0.004).astype(np.int32)
    ec = rng.integers(0, 16, batch).astype(np.int32)
    ec[rng.random(batch) < 0.6] = 0
    valid = rng.random(batch) < 0.7
    return code, (xe, ze, xd, zd, ec), valid


@pytest.mark.parametrize("test_kind", ["rank-basis", "dense"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "valid"])
def test_classify_exact_vs_jax(classify_inputs, test_kind, masked):
    code, arrays, valid = classify_inputs
    jtest = jax_rank_basis_test(code)
    if test_kind == "rank-basis":
        j_imp = jtest
        t_imp = rank_basis_test_from_numpy(
            jax.tree_util.tree_map(np.asarray, jtest), "cpu")
    else:
        j_imp = jnp.asarray(code.i_minus_p)
        t_imp = torch.from_numpy(np.asarray(code.i_minus_p))
    jv = jnp.asarray(valid) if masked else None
    want = np.asarray(jax_classify_batch(j_imp, *map(jnp.asarray, arrays), valid=jv))
    tv = torch.from_numpy(valid) if masked else None
    got = classify_batch(t_imp, *map(torch.from_numpy, arrays), valid=tv)
    assert got.dtype == torch.int32 and got.shape == (NUM_COUNTERS,)
    np.testing.assert_array_equal(got.numpy(), want)
    if not masked:
        np.testing.assert_array_equal(got.numpy(), classify_batch_np(j_imp, *arrays))


def test_make_rank_basis_test_matches_jax(classify_inputs):
    code, _, _ = classify_inputs
    for kind in ("reference", "physical"):
        j = jax_rank_basis_test(code, kind)
        t = make_rank_basis_test(code, "cpu", kind)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        make_rank_basis_test(code, "cpu", "sideways")
