"""``benchmarks_torch/jax_stream.py`` draws ``jax.random``'s stream bit for
bit, and the port's corpus loop on it (``common.run_chunks(...,
stream="jax")``) gives exactly the counters of the JAX scripts' own body
(``tests/golden_jax_cpu.py``: XLA on the CPU), on [[42,0]] (also above the
JAX sampler's cap, which it draws as the cap), the J=2 [[42,7]] code and
[[610,61]], on the CPU."""

import jax
import numpy as np
import pytest
import torch

from benchmarks_torch import common, jax_stream
from qec_ldpc_tpu.sampling import (
    sample_weight_w_errors_dynamic as jax_sample_dynamic,
)
from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.decoder import BPConfig, CodeGraphs
from qec_ldpc_tpu_torch.sampling import make_rank_basis_test
from tests import golden_jax_cpu

torch.set_num_threads(1)

KEYS = [(0, 0), (1000, 4), (7015, 511), (2**32 - 1, 2**32 - 1)]


def key_of(k) -> tuple:
    return tuple(int(x) for x in np.asarray(k))


@pytest.mark.parametrize("seed,chunk", KEYS)
def test_keys_are_jax_random_s(seed, chunk):
    jk = jax.random.PRNGKey(seed)
    assert key_of(jk) == jax_stream.prng_key(seed)
    fk = jax.random.fold_in(jk, chunk)
    tk = jax_stream.fold_in(jax_stream.prng_key(seed), chunk)
    assert key_of(fk) == tk
    assert [key_of(k) for k in jax.random.split(fk)] == jax_stream.split(tk)


@pytest.mark.parametrize("seed,chunk", KEYS)
def test_randint_is_jax_random_s(seed, chunk):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), chunk)
    tk = jax_stream.fold_in(jax_stream.prng_key(seed), chunk)
    for high in (3, 42, 610, 5210):
        np.testing.assert_array_equal(
            jax_stream.randint(tk, (7, 33), high, "cpu").numpy(),
            np.asarray(jax.random.randint(jk, (7, 33), 0, high)))


@pytest.mark.parametrize("n,weight,w_max", [(610, 20, 64), (42, 5, 48),
                                            (42, 40, 32), (42, 0, 24)])
def test_sampler_is_the_jax_packages(n, weight, w_max):
    jk = jax.random.fold_in(jax.random.PRNGKey(4200 + weight), 3)
    tk = jax_stream.fold_in(jax_stream.prng_key(4200 + weight), 3)
    want = jax_sample_dynamic(jk, n, weight, w_max, 128)
    got = jax_stream.sample_weight_w_errors_dynamic(tk, n, weight, w_max, 128,
                                                    "cpu")
    for g, w in zip(got, want):
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


J2 = (2, 3, 6, 7, 2, 3)
STREAM_CASES = [  # (code, W, MAX, prior, seed, sampler cap, chunks)
    (common.CODE42, 5, 100, 0.02, 5208, 48, 3),   # golden_dated's archive
    (common.CODE42, 35, 100, 0.02, 4200 + 35 + 101 * 100, 32, 2),
    (J2, 3, 1000, 0.02, 5300 + 1000 + 3, 24, 2),  # golden_dated's max_sweep
    (common.FLAGSHIP, 40, 100, 0.01, 1040, 64, 1)]  # golden_sweep's
STREAM_BATCH = 256


@pytest.mark.parametrize("case", STREAM_CASES, ids=str)
def test_run_chunks_on_the_jax_stream_is_the_jax_scripts(case):
    params, weight, cap, prior, seed, w_cap, chunks = case
    want = golden_jax_cpu.run_point(params, weight, cap, prior, seed, w_cap,
                                    chunks, batch=STREAM_BATCH)
    code = construct_code(*params)
    got, its = common.run_chunks(
        CodeGraphs.build(code), make_rank_basis_test(code, "cpu"),
        BPConfig(max_iters=cap), seed=seed, weight=weight,
        error_probability=prior, batch=STREAM_BATCH, chunks=chunks,
        device=torch.device("cpu"), weight_cap=w_cap, stream="jax")
    np.testing.assert_array_equal(got, want)
    assert its.shape == (chunks, 2) and its.dtype == np.int64


def test_unknown_stream_refused():
    code = construct_code(*common.CODE42)
    with pytest.raises(ValueError):
        common.run_chunks(CodeGraphs.build(code), None, BPConfig(), seed=1,
                          weight=1, error_probability=0.02, batch=8,
                          chunks=1, device=torch.device("cpu"),
                          stream="threefry")


def test_jax_cpu_runs_are_held_exactly():
    """A JAX-stream point that JAX_CPU_RUNS holds must equal it: the same
    counters pass, one count off raises, another depth or batch is not
    compared."""
    key = ("golden_sweep", 40, 0.01, 100)
    want = common.JAX_CPU_RUNS[key]
    common.gate_jax_cpu(key, want, 2048)
    off = list(want)
    off[3] += 1
    with pytest.raises(AssertionError):
        common.gate_jax_cpu(key, off, 2048)
    common.gate_jax_cpu(key, off, 1024)
    common.gate_jax_cpu(key, [64] + off[1:], 2048)
