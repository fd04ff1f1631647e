"""The port's decode_batch against the JAX package's, exactly.

Same syndromes (NumPy draws) through both, for every decode algorithm
(sum-product, min-sum, layered min-sum); decisions, error codes, the max
iteration counts and, on the plain path, the executed lane-iterations must
be equal.
"""

import dataclasses

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
from qec_ldpc_tpu_torch.convert import bpconfig_from_jax, graphs_from_jax
from qec_ldpc_tpu_torch.decoder import (
    BPConfig,
    decode_batch,
    syndromes_from_errors,
)

CODES = {"42": ((3, 3, 6, 7, 2, 3), 3), "610": ((4, 5, 10, 61, 9, 49), 15)}
BATCH = 256

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


@pytest.fixture(scope="module", params=sorted(CODES))
def case(request):
    params, weight = CODES[request.param]
    jg = JaxCodeGraphs.build(construct_code(*params))
    xe, ze = np_errors(np.random.default_rng(21), jg.code.n, weight, BATCH)
    return jg, graphs_from_jax(jg), xe, ze


def test_syndromes_match(case):
    jg, tg, xe, ze = case
    jsx, jsz = jax.jit(lambda a, b: jax_syndromes(jg, a, b))(xe, ze)
    tsx, tsz = syndromes_from_errors(tg, torch.from_numpy(xe), torch.from_numpy(ze))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))
    np.testing.assert_array_equal(tsz.numpy(), np.asarray(jsz))


@pytest.mark.parametrize("cfg", [
    JaxBPConfig(max_iters=100, check_every=10),
    JaxBPConfig(max_iters=25, check_every=26),
    JaxBPConfig(max_iters=40, check_every=7, conv_low=0.05, conv_high=0.9),
    JaxBPConfig(max_iters=100, check_every=10, algorithm="min-sum"),
    JaxBPConfig(max_iters=25, check_every=26, algorithm="min-sum"),
    JaxBPConfig(max_iters=40, check_every=7, conv_low=0.05,
                algorithm="min-sum"),
    JaxBPConfig(max_iters=100, algorithm="layered-min-sum"),
    JaxBPConfig(max_iters=25, layered_check_every=26,
                algorithm="layered-min-sum"),
    JaxBPConfig(max_iters=40, layered_check_every=4,
                algorithm="layered-min-sum"),
], ids=["early-exit", "fixed-25", "band", "min-sum-early-exit",
        "min-sum-fixed-25", "min-sum-band", "layered-early-exit",
        "layered-fixed-25", "layered-every-4"])
def test_decode_batch_exact_vs_jax(case, cfg):
    """Every algorithm: decisions, error codes and iteration counts equal
    JAX's; on the plain path ``iter_samples`` is iterations x batch, as in
    JAX."""
    jg, tg, xe, ze = case
    sx, sz = (np.array(s) for s in jax.jit(
        lambda a, b: jax_syndromes(jg, a, b))(xe, ze))
    want = jax_decode_batch(jg, jnp.asarray(sx), jnp.asarray(sz), 0.01, cfg)
    got = decode_batch(tg, torch.from_numpy(sx), torch.from_numpy(sz), 0.01,
                       bpconfig_from_jax(cfg))
    np.testing.assert_array_equal(got.decisions_x.numpy(), np.asarray(want.decisions_x))
    np.testing.assert_array_equal(got.decisions_z.numpy(), np.asarray(want.decisions_z))
    np.testing.assert_array_equal(got.error_code.numpy(), np.asarray(want.error_code))
    assert got.decisions_x.dtype == torch.int8
    assert got.error_code.dtype == torch.int32
    assert int(got.iters_x) == int(want.iters_x)
    assert int(got.iters_z) == int(want.iters_z)
    assert int(got.iter_samples_x) == int(got.iters_x) * BATCH
    assert int(got.iter_samples_z) == int(want.iter_samples_z)


@pytest.mark.parametrize("change", [
    {"kernel_roll_impl": "mxu"},
])
def test_unported_options_raise(case, change):
    _, tg, xe, ze = case
    s = torch.zeros((tg.x.num_checks, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        decode_batch(tg, s, s, 0.01, dataclasses.replace(BPConfig(), **change))


def test_unknown_algorithm_raises(case):
    _, tg, _, _ = case
    s = torch.zeros((tg.x.num_checks, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown algorithm"):
        decode_batch(tg, s, s, 0.01, BPConfig(algorithm="bit-flip"))
