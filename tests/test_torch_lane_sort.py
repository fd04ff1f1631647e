"""Lane sorting by syndrome weight (``BPConfig.kernel_sort_lanes``).

The port's permutation equals the JAX package's ``_lane_sort`` on the same
NumPy syndromes, and a decode with sorting is bit-identical to one without:
the kernel decodes the lanes in sorted order, and its outputs go back to the
original order before anything reads them.  On the CPU the wrappers run
their plain versions, which must see the sorted syndromes.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qec_ldpc_tpu.decoder.decode import _lane_sort as jax_lane_sort
from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.codes import known_bicycle_code
from qec_ldpc_tpu_torch.decoder import decode as decode_mod
from qec_ldpc_tpu_torch.decoder.decode import (
    BPConfig,
    CodeGraphs,
    decode_batch,
    lane_sort,
)

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

BATCH = 96


@pytest.fixture(scope="module")
def g42():
    return CodeGraphs.build(construct_code(3, 3, 6, 7, 2, 3))


def assert_same_bits(a, b):
    """NaN masks equal, every other entry bit for bit."""
    assert torch.equal(a.isnan(), b.isnan())
    assert torch.equal(a.view(torch.int32)[~a.isnan()],
                       b.view(torch.int32)[~b.isnan()])


def np_syndromes(graphs, weight, batch, seed):
    """Syndromes of weight-``weight`` X and Z errors drawn with NumPy (ties
    in syndrome weight are common, which the stable sort must keep)."""
    rng = np.random.default_rng(seed)
    n = graphs.code.n
    xe = np.zeros((n, batch), np.int32)
    ze = np.zeros((n, batch), np.int32)
    for lane in range(batch):
        w = rng.integers(0, weight + 1)
        xe[rng.choice(n, w, replace=False), lane] = 1
        ze[rng.choice(n, w, replace=False), lane] = 1
    return (graphs.x.syndrome(torch.from_numpy(xe)),
            graphs.z.syndrome(torch.from_numpy(ze)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_permutation_matches_jax(g42, seed):
    for syn in np_syndromes(g42, 4, BATCH, seed):
        perm, inv = lane_sort(syn)
        jperm, jinv = jax_lane_sort(jnp.asarray(syn.numpy()))
        np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
        np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
        assert torch.equal(perm[inv], torch.arange(BATCH))


def test_zero_and_equal_weights_keep_their_order():
    syn = torch.tensor([[1, 0, 1, 0, 1], [0, 0, 1, 0, 1]], dtype=torch.int32)
    perm, inv = lane_sort(syn)
    assert perm.tolist() == [1, 3, 0, 2, 4]
    assert torch.equal(inv[perm], torch.arange(5))


ALGORITHMS = {
    "sum-product": dict(max_iters=40, check_every=5),
    "min-sum": dict(max_iters=40, check_every=5, algorithm="min-sum"),
    "layered": dict(max_iters=20, algorithm="layered-min-sum"),
}


@pytest.mark.parametrize("algorithm", sorted(ALGORITHMS))
def test_sorted_decode_is_bit_identical(g42, algorithm):
    """Decisions, error codes and soft outputs equal the unsorted decode's
    bit for bit; the iteration counts too on the plain path."""
    sx, sz = np_syndromes(g42, 5, BATCH, 7)
    cfg = BPConfig(**ALGORITHMS[algorithm], return_soft=True)
    base = decode_batch(g42, sx, sz, 0.03, cfg)
    got = decode_batch(g42, sx, sz, 0.03,
                       dataclasses.replace(cfg, kernel_sort_lanes=True))
    for field in ("decisions_x", "decisions_z", "error_code", "iters_x",
                  "iters_z", "iter_samples_x", "iter_samples_z"):
        assert torch.equal(getattr(got, field), getattr(base, field)), field
    for field in ("soft_x", "soft_z"):
        assert_same_bits(getattr(got, field), getattr(base, field))
    assert int((base.error_code != 0).sum()) > 0  # some lanes fail


@pytest.mark.parametrize("algorithm", sorted(ALGORITHMS))
def test_kernel_sees_sorted_lanes(g42, algorithm, monkeypatch):
    """The field is not a no-op: the kernel wrapper receives the syndromes
    in lane_sort order, then the unsorted order without the field."""
    seen = []
    wrappers = ((decode_mod.bp_cuda, "bp_run"),
                (decode_mod.min_sum_cuda, "min_sum_run"),
                (decode_mod.layered_cuda, "layered_run"))
    for owner, name in wrappers:
        real = getattr(owner, name)
        monkeypatch.setattr(owner, name, lambda g, s, *a, _real=real, **k:
                            seen.append(s.clone()) or _real(g, s, *a, **k))
    sx, sz = np_syndromes(g42, 5, BATCH, 8)
    cfg = BPConfig(**ALGORITHMS[algorithm])
    decode_batch(g42, sx, sz, 0.03,
                 dataclasses.replace(cfg, kernel_sort_lanes=True))
    decode_batch(g42, sx, sz, 0.03, cfg)
    assert len(seen) == 4
    for got, syn in zip(seen[:2], (sx, sz)):
        assert torch.equal(got, syn[:, lane_sort(syn)[0]])
        weights = got.sum(dim=0)
        assert bool((weights[1:] >= weights[:-1]).all())
        assert not torch.equal(got, syn)
    for got, syn in zip(seen[2:], (sx, sz)):
        assert torch.equal(got, syn)


def test_lifted_decode_sorts_too():
    """K5/K6's branch (lifted graphs) sorts and inverts like the others."""
    graphs = known_bicycle_code("[[72,12,6]]").build_graphs()
    rng = np.random.default_rng(3)
    xe = torch.from_numpy((rng.random((graphs.code.n, 32)) < 0.04).astype(np.int32))
    ze = torch.from_numpy((rng.random((graphs.code.n, 32)) < 0.04).astype(np.int32))
    sx, sz = graphs.x.syndrome(xe), graphs.z.syndrome(ze)
    for algorithm in ("sum-product", "min-sum"):
        cfg = BPConfig(max_iters=20, check_every=5, algorithm=algorithm,
                       return_soft=True)
        base = decode_batch(graphs, sx, sz, 0.03, cfg)
        got = decode_batch(graphs, sx, sz, 0.03,
                           dataclasses.replace(cfg, kernel_sort_lanes=True))
        for field in ("decisions_x", "decisions_z", "error_code"):
            assert torch.equal(getattr(got, field), getattr(base, field))
        for field in ("soft_x", "soft_z"):
            assert_same_bits(getattr(got, field), getattr(base, field))


def test_mxu_still_raises(g42):
    s = torch.zeros((g42.x.num_checks, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        decode_batch(g42, s, s, 0.01,
                     BPConfig(kernel_roll_impl="mxu", kernel_sort_lanes=True))
