"""The slice as a whole: sample -> syndromes -> decode [-> relay] ->
classify -> counters -> CodeStatistics, in the port against the JAX
package, for every decode algorithm."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qec_ldpc_tpu.codes import construct_code
from qec_ldpc_tpu.decoder import BPConfig as JaxBPConfig
from qec_ldpc_tpu.decoder import CodeGraphs as JaxCodeGraphs
from qec_ldpc_tpu.decoder import decode_batch as jax_decode_batch
from qec_ldpc_tpu.decoder import syndromes_from_errors as jax_syndromes
from qec_ldpc_tpu.harness import stats as jax_stats
from qec_ldpc_tpu.parallel.montecarlo import run_monte_carlo as jax_run_monte_carlo
from qec_ldpc_tpu.sampling.classify import classify_batch as jax_classify_batch
from qec_ldpc_tpu.sampling.classify import make_rank_basis_test as jax_rank_basis_test
from qec_ldpc_tpu_torch.convert import (
    bpconfig_from_jax,
    graphs_from_jax,
    rank_basis_test_from_numpy,
)
from qec_ldpc_tpu_torch.decoder import BPConfig, CodeGraphs, decode_batch
from qec_ldpc_tpu_torch.harness import stats
from qec_ldpc_tpu_torch.parallel.chunk import (
    RELAY_STREAM,
    chunk_generator,
    relay_draws,
)
from qec_ldpc_tpu_torch.parallel.montecarlo import (
    effective_steps_per_call,
    run_monte_carlo,
)
from qec_ldpc_tpu_torch.sampling import (
    C_CONV_X,
    C_CONV_Z,
    C_CORRECTED,
    C_SYN_X,
    C_SYN_Z,
    C_TESTED,
    C_X_TESTED,
    C_Z_TESTED,
    classify_batch,
)

CODES = {"42": ((3, 3, 6, 7, 2, 3), 3), "610": ((4, 5, 10, 61, 9, 49), 15)}

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


def np_errors(rng, n, weight, batch):
    idx = rng.integers(0, n, (weight, batch))
    typ = rng.integers(0, 3, (weight, batch))
    cols = np.broadcast_to(np.arange(batch), idx.shape)
    xe = np.zeros((n, batch), np.int32)
    ze = np.zeros((n, batch), np.int32)
    xe[idx[typ <= 1], cols[typ <= 1]] = 1
    ze[idx[typ >= 1], cols[typ >= 1]] = 1
    return xe, ze


@pytest.fixture(scope="module")
def g42():
    return CodeGraphs.build(construct_code(*CODES["42"][0]))


@pytest.mark.parametrize("code_name", sorted(CODES))
def test_slice_counters_identical(code_name):
    """Shared errors through both pipelines give identical counters."""
    params, weight = CODES[code_name]
    jg = JaxCodeGraphs.build(construct_code(*params))
    tg = graphs_from_jax(jg)
    jtest = jax_rank_basis_test(jg.code)
    ttest = rank_basis_test_from_numpy(jax.tree_util.tree_map(np.asarray, jtest), "cpu")
    cfg = JaxBPConfig(max_iters=100, check_every=10)
    xe, ze = np_errors(np.random.default_rng(41), jg.code.n, weight, 256)

    @jax.jit
    def jax_pipeline(xe, ze):
        sx, sz = jax_syndromes(jg, xe, ze)
        res = jax_decode_batch(jg, sx, sz, 0.01, cfg)
        return jax_classify_batch(jtest, xe, ze, res.decisions_x.astype(jnp.int32),
                                  res.decisions_z.astype(jnp.int32), res.error_code)

    want = np.asarray(jax_pipeline(jnp.asarray(xe), jnp.asarray(ze)))
    txe, tze = torch.from_numpy(xe), torch.from_numpy(ze)
    res = decode_batch(tg, tg.x.syndrome(txe), tg.z.syndrome(tze), 0.01,
                       bpconfig_from_jax(cfg))
    got = classify_batch(ttest, txe, tze, res.decisions_x.to(torch.int32),
                         res.decisions_z.to(torch.int32), res.error_code)
    np.testing.assert_array_equal(got.numpy(), want)


def test_deterministic_in_seed_and_grouping(g42):
    cfg = BPConfig(max_iters=100)
    runs = [run_monte_carlo(g42, 3, 6 * 128, 0.02, cfg, seed=5, batch_size=128,
                            steps_per_call=spc, device="cpu")
            for spc in (1, 2, 4, 6)]
    for counters, iters in runs[1:]:
        np.testing.assert_array_equal(counters, runs[0][0])
        assert iters == runs[0][1]
    other, _ = run_monte_carlo(g42, 3, 6 * 128, 0.02, cfg, seed=6,
                               batch_size=128, device="cpu")
    assert not np.array_equal(other, runs[0][0])
    assert runs[0][0][C_TESTED] == 6 * 128


def test_resume_and_progress(g42):
    cfg = BPConfig(max_iters=100)
    seen = []
    full, full_iters = run_monte_carlo(
        g42, 3, 4 * 64, 0.02, cfg, seed=7, batch_size=64, steps_per_call=2,
        progress=lambda g, ng, c, it: seen.append((g, ng, c.copy(), it)),
        device="cpu")
    assert [s[:2] for s in seen] == [(0, 2), (1, 2)]
    rest, rest_iters = run_monte_carlo(
        g42, 3, 4 * 64, 0.02, cfg, seed=7, batch_size=64, steps_per_call=2,
        start_chunk=1, init_counters=seen[0][2], device="cpu")
    np.testing.assert_array_equal(rest, full)
    assert rest_iters + seen[0][3] == full_iters
    assert effective_steps_per_call(4 * 64, 64, 3) == 2


def test_corrected_fraction_agrees_with_jax(g42):
    """Different random streams, same distribution: two-sample z-test."""
    count, weight = 8192, 2
    cfg = BPConfig(max_iters=100)
    t, _ = run_monte_carlo(g42, weight, count, 0.02, cfg, seed=11,
                           batch_size=1024, steps_per_call=8, device="cpu")
    jg = JaxCodeGraphs.build(g42.code)
    j, _ = jax_run_monte_carlo(jg, weight, count, 0.02, JaxBPConfig(max_iters=100),
                               seed=11, batch_size=1024, steps_per_call=8)
    p1, p2 = t[C_CORRECTED] / t[C_TESTED], j[C_CORRECTED] / j[C_TESTED]
    pool = (t[C_CORRECTED] + j[C_CORRECTED]) / (t[C_TESTED] + j[C_TESTED])
    z = (p1 - p2) / math.sqrt(pool * (1 - pool) * (1 / t[C_TESTED] + 1 / j[C_TESTED]))
    assert abs(z) < 4, (p1, p2, z)


@pytest.mark.parametrize("algorithm,weight,count,relay_retries", [
    ("min-sum", 2, 8192, 0),
    ("layered-min-sum", 2, 8192, 0),
    ("min-sum", 4, 2048, 8),
], ids=["min-sum", "layered-min-sum", "relay"])
def test_algorithm_corrected_fraction_agrees_with_jax(g42, algorithm, weight,
                                                      count, relay_retries):
    """Min-sum, layered min-sum and relay-repaired min-sum through both
    packages: different random streams, same distribution (two-sample
    z-test on the corrected fraction)."""
    jcfg = JaxBPConfig(max_iters=100, algorithm=algorithm)
    t, t_iters = run_monte_carlo(g42, weight, count, 0.02,
                                 bpconfig_from_jax(jcfg), seed=12,
                                 batch_size=1024, steps_per_call=8,
                                 relay_retries=relay_retries, device="cpu")
    jg = JaxCodeGraphs.build(g42.code)
    j, _ = jax_run_monte_carlo(jg, weight, count, 0.02, jcfg, seed=12,
                               batch_size=1024, steps_per_call=8,
                               relay_retries=relay_retries)
    assert t[C_TESTED] == j[C_TESTED] == count and t_iters > 0
    p1, p2 = t[C_CORRECTED] / t[C_TESTED], j[C_CORRECTED] / j[C_TESTED]
    pool = (t[C_CORRECTED] + j[C_CORRECTED]) / (t[C_TESTED] + j[C_TESTED])
    z = (p1 - p2) / math.sqrt(pool * (1 - pool) * (1 / t[C_TESTED] + 1 / j[C_TESTED]))
    assert abs(z) < 4, (p1, p2, z)


def test_relay_deterministic_in_seed_and_grouping(g42):
    """The relay stream is a function of (seed, chunk) alone: grouping does
    not change the counters or the work count, and relay changes only what
    the primary decode failed."""
    cfg = BPConfig(max_iters=100, algorithm="min-sum")
    runs = [run_monte_carlo(g42, 4, 4 * 128, 0.02, cfg, seed=5, batch_size=128,
                            steps_per_call=spc, relay_retries=4, device="cpu")
            for spc in (1, 2, 4)]
    for counters, iters in runs[1:]:
        np.testing.assert_array_equal(counters, runs[0][0])
        assert iters == runs[0][1]
    base, base_iters = run_monte_carlo(g42, 4, 4 * 128, 0.02, cfg, seed=5,
                                       batch_size=128, device="cpu")
    relayed = runs[0][0]
    assert relayed[C_CORRECTED] > base[C_CORRECTED]
    assert runs[0][1] > base_iters
    for c in (C_TESTED, C_X_TESTED, C_Z_TESTED, C_CONV_X, C_CONV_Z):
        assert relayed[c] == base[c]
    assert relayed[C_SYN_X] < base[C_SYN_X] and relayed[C_SYN_Z] < base[C_SYN_Z]


def test_relay_generator_is_its_own_stream():
    """Each retry of each graph draws from a generator of its own, apart
    from the error stream; the same arguments give the same draws."""
    x = relay_draws(5, 3, "cpu").gammas(0, 7, 4)
    again = relay_draws(5, 3, "cpu").gammas(0, 7, 4)
    z = relay_draws(5, 3, "cpu").gammas(1, 7, 4)
    errors = torch.rand((7, 4), generator=chunk_generator(5, 3, "cpu"))
    assert torch.equal(x(0), again(0)) and torch.equal(x(1), again(1))
    assert not torch.equal(x(0), x(1)) and not torch.equal(x(0), z(0))
    assert not torch.equal(x(0), errors * 0.95 + 0.05)
    assert RELAY_STREAM == 0x52454C41


def test_dense_logical_test_matches_rank_basis(g42):
    cfg = BPConfig(max_iters=100)
    a, _ = run_monte_carlo(g42, 3, 256, 0.02, cfg, seed=3, batch_size=128,
                           device="cpu")
    b, _ = run_monte_carlo(g42, 3, 256, 0.02, cfg, seed=3, batch_size=128,
                           i_minus_p=g42.code.i_minus_p, device="cpu")
    np.testing.assert_array_equal(a, b)


# weight_cap is ported; a cap below the weight is refused
@pytest.mark.parametrize("kwargs", [{"mesh": object()}, {"weight_cap": 0},
                                    {"error_model": "sideways"}])
def test_unported_run_options_raise(g42, kwargs):
    with pytest.raises((NotImplementedError, ValueError)):
        run_monte_carlo(g42, 1, 64, 0.02, BPConfig(), seed=1, batch_size=64,
                        device="cpu", **kwargs)


def test_depolarizing_model_runs(g42):
    counters, _ = run_monte_carlo(g42, 0, 256, 0.01, BPConfig(), seed=2,
                                  batch_size=128, error_model="depolarizing",
                                  device="cpu")
    assert counters[C_TESTED] == 256 and counters[C_CORRECTED] > 128


def test_code_statistics_text_identical(g42):
    counters = np.array([1000, 990, 985, 960, 12, 15, 13, 3, 4], dtype=np.int64)
    kw = dict(total_bp_iterations=123456, num_devices=1)
    t = stats.CodeStatistics.from_counters(g42.code, 42, 3, counters, 98765, **kw)
    j = jax_stats.CodeStatistics.from_counters(g42.code, 42, 3, counters, 98765, **kw)
    assert t.to_reference_text() == j.to_reference_text()
    assert t.to_dict() == j.to_dict()
    assert t.samples_per_second == j.samples_per_second
    text = t.to_reference_text() + "\n" + t.to_reference_text()
    assert stats.parse_reference_text(text) == jax_stats.parse_reference_text(text)
    old = "Code: code: J=2,K=3,L=6,P=7,sigma=2,tau=3 [[n=42,k=7]]\nLogical Errors X: 3\nLogical Errors Z: 4\n"
    # the port marks the derived X+Z sum; every key JAX's parser gives is
    # the port's, with the same value
    (ported,), (jax_rec,) = (stats.parse_reference_text(old),
                             jax_stats.parse_reference_text(old))
    assert ported == {**jax_rec, "Logical Errors derived": "X+Z"}
    for s in (t.code_str, old, "no code here"):
        assert stats.parse_code_params(s) == jax_stats.parse_code_params(s)
