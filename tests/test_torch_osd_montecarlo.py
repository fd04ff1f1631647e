"""The quality mode (run_monte_carlo_osd) in the port against the JAX
package on the CPU: the chunk tail on shared tensors, counter for counter,
the invariants of the JAX package's own tests, and a two-proportion test
of the corrected count against JAX's run (the sample streams differ:
Philox against threefry)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qec_ldpc_tpu.codes import construct_code
from qec_ldpc_tpu.decoder import BPConfig as JaxBPConfig
from qec_ldpc_tpu.decoder import CodeGraphs as JaxCodeGraphs
from qec_ldpc_tpu.decoder.osd import CSSPostprocessor as JaxCSSPostprocessor
from qec_ldpc_tpu.parallel import montecarlo as jax_mc
from qec_ldpc_tpu.sampling.classify import make_rank_basis_test as jax_rank_basis_test
from qec_ldpc_tpu_torch.codes import toric_code
from qec_ldpc_tpu_torch.convert import graphs_from_jax, rank_basis_test_from_numpy
from qec_ldpc_tpu_torch.decoder import BPConfig, DecodeResult
from qec_ldpc_tpu_torch.decoder.osd import CSSPostprocessor
from qec_ldpc_tpu_torch.parallel import montecarlo
from qec_ldpc_tpu_torch.parallel.chunk import _classify_and_compact
from qec_ldpc_tpu_torch.parallel.mesh import DATA_AXIS, GRAPH_AXIS, Mesh
from qec_ldpc_tpu_torch.parallel.montecarlo import (
    run_monte_carlo,
    run_monte_carlo_osd,
)
from qec_ldpc_tpu_torch.sampling import (
    C_CONV_X,
    C_CONV_Z,
    C_CORRECTED,
    C_LOGICAL,
    C_SYN_X,
    C_SYN_Z,
    C_TESTED,
)

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jg42():
    return JaxCodeGraphs.build(construct_code(3, 3, 6, 7, 2, 3))


@pytest.fixture(scope="module")
def g42(jg42):
    return graphs_from_jax(jg42)


def jax_chunk(jg, weight, batch, key, cfg):
    """One chunk of the JAX package's quality mode up to the tail: the
    sampled errors, syndromes and decode result, as JAX makes them."""
    return jax_mc._sample_and_decode(jg, jax.random.PRNGKey(key), weight,
                                     jnp.float32(0.02), cfg, batch, "weight")


def port_tail(tg, ttest, post, xe, ze, sx, sz, res):
    """The port's compact + repair + classify on JAX's arrays."""
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    tres = DecodeResult(decisions_x=t(res.decisions_x),
                        decisions_z=t(res.decisions_z),
                        error_code=t(res.error_code), iters_x=None,
                        iters_z=None, iter_samples_x=None, iter_samples_z=None,
                        soft_x=t(res.soft_x), soft_z=t(res.soft_z))
    counters_ok, counts, bundle = _classify_and_compact(
        ttest, t(xe), t(ze), t(sx), t(sz), tres)
    failed = montecarlo._repair_and_classify(post, ttest, counts.numpy(), bundle)
    return counters_ok, counts, failed


@pytest.mark.parametrize("algorithm", ["min-sum", "layered-min-sum"])
@pytest.mark.parametrize("lam", [0, 4])
def test_tail_matches_jax(jg42, g42, algorithm, lam):
    """Shared (xe, ze, sx, sz, res) of one chunk: the port's counters equal
    JAX's _classify_and_compact + _repair_and_classify_np (host OSD, lam=4)
    and + _device_repair_classify (device OSD-0, lam=0)."""
    cfg = JaxBPConfig(max_iters=10, algorithm=algorithm, kernel="xla",
                      return_soft=True)
    jtest = jax_rank_basis_test(jg42.code)
    ttest = rank_basis_test_from_numpy(jax.tree_util.tree_map(np.asarray, jtest),
                                       "cpu")
    xe, ze, sx, sz, res = jax_chunk(jg42, 5, 128, 3, cfg)
    counters_ok, nfail, bundle = jax_mc._classify_and_compact(jtest, xe, ze, sx,
                                                              sz, res)
    k = int(nfail)
    assert k > 0, "no BP failures; raise the weight"
    if lam == 0:
        post = JaxCSSPostprocessor(jg42, lam=0, device="device")
        want_failed = jax_mc._device_repair_classify(post, jtest, nfail[None],
                                                     bundle)
    else:
        post = JaxCSSPostprocessor(jg42, lam=lam, device="host")
        fetched = tuple(np.asarray(a)[..., :k] for a in bundle)
        want_failed = jax_mc._repair_and_classify_np(post, jtest, fetched)
    want = np.asarray(counters_ok, dtype=np.int64) + want_failed
    got_ok, counts, got_failed = port_tail(g42, ttest,
                                           CSSPostprocessor(g42, lam=lam),
                                           xe, ze, sx, sz, res)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(counters_ok))
    assert int(counts[0]) == k
    np.testing.assert_array_equal((got_ok + got_failed).numpy(), want)
    assert want[C_SYN_X] == 0 and want[C_SYN_Z] == 0


def test_tail_without_osd_classifies_failed_lanes_as_they_are(jg42, g42):
    """lam = -1 (no OSD): counters_ok + the unrepaired failed lanes equal
    classifying the whole chunk at once."""
    cfg = JaxBPConfig(max_iters=10, algorithm="min-sum", kernel="xla",
                      return_soft=True)
    jtest = jax_rank_basis_test(jg42.code)
    ttest = rank_basis_test_from_numpy(jax.tree_util.tree_map(np.asarray, jtest),
                                       "cpu")
    xe, ze, sx, sz, res = jax_chunk(jg42, 5, 128, 4, cfg)
    got_ok, _, got_failed = port_tail(g42, ttest, None, xe, ze, sx, sz, res)
    from qec_ldpc_tpu.sampling.classify import classify_batch

    full = classify_batch(jtest, xe, ze, res.decisions_x.astype(jnp.int32),
                          res.decisions_z.astype(jnp.int32), res.error_code)
    np.testing.assert_array_equal((got_ok + got_failed).numpy(),
                                  np.asarray(full))


@pytest.mark.parametrize("lam", [0, 4])
@pytest.mark.parametrize("algorithm", ["sum-product", "min-sum",
                                       "layered-min-sum"])
def test_invariants(g42, algorithm, lam):
    """As the JAX package's test_run_monte_carlo_osd_improves_on_base: the
    same draws as run_monte_carlo, every failure repaired into a
    syndrome-valid correction, convergence counters untouched."""
    cfg = BPConfig(max_iters=20, algorithm=algorithm)
    base, base_iters = run_monte_carlo(g42, 4, 512, 0.02, cfg, seed=7,
                                       batch_size=128, device="cpu")
    osd, iters = run_monte_carlo_osd(g42, 4, 512, 0.02, cfg, seed=7,
                                     batch_size=128, lam=lam, device="cpu")
    assert osd[C_TESTED] == base[C_TESTED] == 512
    assert osd[C_SYN_X] == 0 and osd[C_SYN_Z] == 0
    assert osd[C_CORRECTED] + osd[C_LOGICAL] == osd[C_TESTED]
    assert osd[C_CORRECTED] >= base[C_CORRECTED]
    assert osd[C_CONV_X] == base[C_CONV_X] and osd[C_CONV_Z] == base[C_CONV_Z]
    assert iters == base_iters


def test_without_osd_equals_run_monte_carlo_with_relay(g42):
    """lam = -1 leaves relay alone: the counters are run_monte_carlo's."""
    cfg = BPConfig(max_iters=15, algorithm="min-sum")
    a, ia = run_monte_carlo(g42, 5, 256, 0.02, cfg, seed=3, batch_size=128,
                            relay_retries=2, device="cpu")
    b, ib = run_monte_carlo_osd(g42, 5, 256, 0.02, cfg, seed=3,
                                batch_size=128, lam=-1, relay_retries=2,
                                device="cpu")
    np.testing.assert_array_equal(a, b)
    assert ia == ib


def test_relay_then_osd(g42):
    cfg = BPConfig(max_iters=15, algorithm="min-sum")
    kw = dict(batch_size=64, lam=1, relay_retries=2, device="cpu")
    a, _ = run_monte_carlo_osd(g42, 5, 128, 0.02, cfg, seed=3, **kw)
    b, _ = run_monte_carlo_osd(g42, 5, 128, 0.02, cfg, seed=3, **kw)
    np.testing.assert_array_equal(a, b)
    assert a[C_TESTED] == 128 and a[C_SYN_X] == 0 and a[C_SYN_Z] == 0


def test_resume_is_chunk_exact(g42):
    cfg = BPConfig(max_iters=15, algorithm="min-sum")
    kw = dict(batch_size=64, lam=0, device="cpu")
    full, _ = run_monte_carlo_osd(g42, 4, 192, 0.02, cfg, seed=3, **kw)
    per_chunk = []
    run_monte_carlo_osd(g42, 4, 192, 0.02, cfg, seed=3,
                        progress=lambda c, n, cnt, it: per_chunk.append((c, n, cnt)),
                        **kw)
    assert [(c, n) for c, n, _ in per_chunk] == [(0, 3), (1, 3), (2, 3)]
    np.testing.assert_array_equal(sum(cnt for _, _, cnt in per_chunk), full)
    resumed, _ = run_monte_carlo_osd(g42, 4, 192, 0.02, cfg, seed=3,
                                     start_chunk=1,
                                     init_counters=per_chunk[0][2], **kw)
    np.testing.assert_array_equal(full, resumed)


def test_device_and_host_routes_agree(g42, monkeypatch):
    """lam = 0 gives identical counters whether OSD-0 runs as DeviceOSD0
    (the kernel's plain version here) or on the host solver."""
    cfg = BPConfig(max_iters=30, algorithm="min-sum")
    counters = {}
    for route in ("auto", "host"):
        monkeypatch.setattr(montecarlo, "CSSPostprocessor",
                            lambda graphs, lam=0, r=route:
                            CSSPostprocessor(graphs, lam=lam, device=r))
        counters[route], _ = run_monte_carlo_osd(
            g42, 4, 512, 0.02, cfg, seed=9, batch_size=256, lam=0,
            device="cpu")
    np.testing.assert_array_equal(counters["auto"], counters["host"])
    assert counters["host"][C_SYN_X] == 0 and counters["host"][C_SYN_Z] == 0


def test_corrected_count_agrees_with_jax(jg42, g42):
    """Two-proportion test (|z| < 4) of the corrected count against JAX's
    run_monte_carlo_osd at the same settings."""
    kw = dict(batch_size=512, lam=0)
    count = 2048
    want, _ = jax_mc.run_monte_carlo_osd(
        jg42, 5, count, 0.02, JaxBPConfig(max_iters=20, algorithm="min-sum",
                                          kernel="xla"), seed=11, **kw)
    got, _ = run_monte_carlo_osd(g42, 5, count, 0.02,
                                 BPConfig(max_iters=20, algorithm="min-sum"),
                                 seed=11, device="cpu", **kw)
    k1, k2 = int(got[C_CORRECTED]), int(want[C_CORRECTED])
    pool = (k1 + k2) / (2 * count)
    z = (k1 - k2) / count / math.sqrt(pool * (1 - pool) * 2 / count)
    assert abs(z) < 4, (k1, k2, z)
    assert got[C_SYN_X] == got[C_SYN_Z] == 0 == want[C_SYN_X] == want[C_SYN_Z]


def graph_mesh_shape() -> Mesh:
    """A stand-in for a (data=1 x graph=2) mesh: the quality mode reads its
    shape and refuses before any collective."""
    mesh = Mesh.__new__(Mesh)
    mesh.shape = {DATA_AXIS: 1, GRAPH_AXIS: 2}
    return mesh


# a lifted code on a graph mesh: the graph-sharded quality chunks serve
# circulant codes alone, as JAX's do (the lifted engine has no soft outputs)
@pytest.mark.parametrize("kwargs", [{"mesh": graph_mesh_shape()}])
def test_unported_options_raise(kwargs):
    toric = toric_code(3).build_graphs()
    with pytest.raises(ValueError, match="circulant"):
        run_monte_carlo_osd(toric, 1, 64, 0.02,
                            BPConfig(algorithm="min-sum"), seed=1,
                            batch_size=64, device="cpu", **kwargs)
