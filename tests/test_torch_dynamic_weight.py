"""The dynamic-weight sampler (sampling/errors.py) and
``run_monte_carlo(weight_cap=)`` against the JAX package's: shared draws
give the same error bits, the sampler equals the static one at
``weight == w_max``, the effective weights and the Monte-Carlo counters
agree in distribution (|z| < 4), and at ``weight == weight_cap`` a run's
counters equal the static run's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qec_ldpc_tpu.codes import construct_code as jax_construct_code
from qec_ldpc_tpu.decoder import BPConfig as JaxBPConfig, CodeGraphs as JaxCodeGraphs
from qec_ldpc_tpu.parallel.montecarlo import run_monte_carlo as jax_run_monte_carlo
from qec_ldpc_tpu.sampling import errors as jax_errors
from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.decoder import BPConfig, CodeGraphs
from qec_ldpc_tpu_torch.parallel.montecarlo import run_monte_carlo
from qec_ldpc_tpu_torch.sampling import (
    C_CORRECTED,
    C_TESTED,
    sample_weight_w_errors,
    sample_weight_w_errors_dynamic,
)
from qec_ldpc_tpu_torch.sampling import errors

torch.set_num_threads(1)

PARAMS = (3, 3, 6, 7, 2, 3)
N = 42
CAP = 8
MC_COUNT, MC_BATCH, MC_ITERS, MC_P = 4096, 512, 20, 0.02


def two_proportion_z(k1, n1, k2, n2) -> float:
    p = (k1 + k2) / (n1 + n2)
    se = (p * (1 - p) * (1 / n1 + 1 / n2)) ** 0.5
    return 0.0 if se == 0 else (k1 / n1 - k2 / n2) / se


@pytest.mark.parametrize("w,n,batch,active_to", [
    (8, 42, 256, 5), (8, 42, 256, 8), (8, 42, 256, 0), (30, 7, 64, 17),
    # past the JAX package's one-shot size: its radix count-matmul path
    (64, 610, 512, 40)])
def test_accumulate_hits_bit_equal(w, n, batch, active_to):
    """The same draws give the same error bits, colliding indices (n=7
    with 30 draws collides on every lane) and inactive draws included."""
    rng = np.random.default_rng(w * 1000 + n)
    idx = rng.integers(0, n, (w, batch), dtype=np.int32)
    typ = rng.integers(0, 3, (w, batch), dtype=np.int32)
    active = np.arange(w) < active_to
    xo, zo = errors._accumulate_hits(torch.from_numpy(idx),
                                     torch.from_numpy(typ), n,
                                     torch.from_numpy(active))
    xj, zj = jax_errors._accumulate_hits(jnp.asarray(idx), jnp.asarray(typ),
                                         n, jnp.asarray(active))
    np.testing.assert_array_equal(xo.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(zo.numpy(), np.asarray(zj))
    assert xo.dtype == torch.int8
    if active_to == 0:
        assert not xo.any() and not zo.any()


@pytest.mark.parametrize("w", [1, 5, 8])
def test_dynamic_equals_static_at_w_max(w):
    a = sample_weight_w_errors(torch.Generator().manual_seed(11), N, w, 300)
    b = sample_weight_w_errors_dynamic(torch.Generator().manual_seed(11), N,
                                       w, w, 300)
    for s, d in zip(a, b):
        assert torch.equal(s, d)


def test_dynamic_rejects_weight_above_cap():
    with pytest.raises(ValueError, match="w_max"):
        sample_weight_w_errors_dynamic(torch.Generator(), N, 9, 8, 4)


def effective_weights(x, z) -> np.ndarray:
    return (np.asarray(x).astype(bool) | np.asarray(z).astype(bool)).sum(axis=0)


@pytest.mark.parametrize("w", [1, 3, 6])
def test_effective_weight_histograms_agree(w):
    """Collisions make the effective weight < w at times; its histogram
    agrees with the JAX package's dynamic sampler bin by bin (|z| < 4)."""
    batch = 20000
    ours = effective_weights(*sample_weight_w_errors_dynamic(
        torch.Generator().manual_seed(w), N, w, CAP, batch))
    theirs = effective_weights(*jax_errors.sample_weight_w_errors_dynamic(
        jax.random.PRNGKey(w), N, w, CAP, batch))
    assert ours.max() <= w and theirs.max() <= w
    for k in range(1, w + 1):
        z = two_proportion_z(int((ours == k).sum()), batch,
                             int((theirs == k).sum()), batch)
        assert abs(z) < 4, (k, z)


@pytest.fixture(scope="module")
def graphs():
    return (CodeGraphs.build(construct_code(*PARAMS)),
            JaxCodeGraphs.build(jax_construct_code(*PARAMS)))


@pytest.mark.parametrize("algorithm", ["sum-product", "min-sum"])
@pytest.mark.parametrize("w", [1, 2, 3])
def test_weight_cap_run_agrees_with_jax(graphs, algorithm, w):
    ours, theirs = graphs
    cnt, _ = run_monte_carlo(ours, w, MC_COUNT, MC_P,
                             BPConfig(max_iters=MC_ITERS, algorithm=algorithm),
                             seed=3, batch_size=MC_BATCH, steps_per_call=4,
                             weight_cap=CAP, device="cpu")
    jcnt, _ = jax_run_monte_carlo(
        theirs, w, MC_COUNT, MC_P,
        JaxBPConfig(max_iters=MC_ITERS, algorithm=algorithm, kernel="xla"),
        seed=3, batch_size=MC_BATCH, steps_per_call=4, weight_cap=CAP)
    jcnt = np.asarray(jcnt)
    assert cnt[C_TESTED] == jcnt[C_TESTED] == MC_COUNT
    z = two_proportion_z(int(cnt[C_CORRECTED]), MC_COUNT,
                         int(jcnt[C_CORRECTED]), MC_COUNT)
    assert abs(z) < 4, (cnt, jcnt, z)


def test_weight_cap_at_the_cap_equals_static(graphs):
    ours, _ = graphs
    cfg = BPConfig(max_iters=MC_ITERS, algorithm="min-sum")
    kw = dict(seed=9, batch_size=MC_BATCH, steps_per_call=2, device="cpu")
    static = run_monte_carlo(ours, CAP, 2048, MC_P, cfg, **kw)
    dynamic = run_monte_carlo(ours, CAP, 2048, MC_P, cfg, weight_cap=CAP, **kw)
    np.testing.assert_array_equal(static[0], dynamic[0])
    assert static[1] == dynamic[1]
    below = run_monte_carlo(ours, CAP - 1, 2048, MC_P, cfg, weight_cap=CAP,
                            **kw)
    assert not np.array_equal(below[0], static[0])
