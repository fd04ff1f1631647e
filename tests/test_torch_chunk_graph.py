"""The counting path's CUDA graph (parallel/montecarlo.py ``_ChunkGraph``):
when ``run_monte_carlo`` captures and replays a chunk, that a reseeded
generator draws what the chunk's fresh one draws, and, on a card, that
replayed chunks count what the eager chunks and the plain decoders count,
bit for bit.

Imports neither JAX nor the JAX package, so the ``cuda`` cases also run on
a machine with a card:
``python -m pytest --noconftest -m cuda tests/test_torch_chunk_graph.py -q``.
"""

import numpy as np
import pytest
import torch

from qec_ldpc_tpu_torch import construct_code, tracing
from qec_ldpc_tpu_torch.codes import bicycle_code
from qec_ldpc_tpu_torch.decoder import BPConfig, CodeGraphs
from qec_ldpc_tpu_torch.decoder.decode import decode_batch
from qec_ldpc_tpu_torch.parallel import montecarlo
from qec_ldpc_tpu_torch.parallel.chunk import chunk_generator, sample_syndromes
from qec_ldpc_tpu_torch.parallel.mesh import spawn
from qec_ldpc_tpu_torch.parallel.montecarlo import (
    graph_path,
    mc_chunk,
    run_monte_carlo,
)
from qec_ldpc_tpu_torch.sampling import classify_batch, make_rank_basis_test
from qec_ldpc_tpu_torch.sampling.errors import generator_seed, seeded_generator
from tests import torch_mesh_workers

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

PARAMS = (3, 3, 6, 7, 2, 3)
SEED, P_ERR, BATCH = 13, 0.02, 64
CUDA = torch.device("cuda", 0)


@pytest.mark.parametrize("device,mesh,relay,engages", [
    (CUDA, None, 0, True),
    (torch.device("cpu"), None, 0, False),
    (CUDA, None, 4, False),
    (CUDA, object(), 0, False),
])
def test_graph_path_engages_on_one_card_without_relay(device, mesh, relay,
                                                      engages):
    assert graph_path(device, mesh, relay) is engages


@pytest.fixture(scope="module")
def g42():
    code = construct_code(*PARAMS)
    return CodeGraphs.build(code), make_rank_basis_test(code, "cpu")


@pytest.mark.parametrize("error_model,weight_cap", [
    ("weight", None), ("weight", 5), ("depolarizing", None)])
@pytest.mark.parametrize("entropy", [(SEED, 0), (2**63 + 5, 511)])
def test_reseeded_generator_draws_what_a_fresh_one_draws(g42, entropy,
                                                         error_model,
                                                         weight_cap):
    """A replay reseeds one generator that has drawn before: seeded by
    ``generator_seed`` it draws the chunk's errors and syndromes as the
    chunk's own fresh generator (``seeded_generator``) does."""
    graphs, _ = g42
    reused = seeded_generator([1, 2], "cpu")
    for _ in range(2):
        sample_syndromes(graphs, reused, 3, P_ERR, BATCH, error_model,
                         weight_cap)
        reused.manual_seed(generator_seed(entropy))
        got = sample_syndromes(graphs, reused, 3, P_ERR, BATCH, error_model,
                               weight_cap)
        want = sample_syndromes(
            graphs, seeded_generator(entropy, "cpu"), 3, P_ERR, BATCH,
            error_model, weight_cap)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def eager_sum(graphs, test, chunks, cfg, relay=0, shard=(), device="cpu",
              seed=SEED, weight=3, p=P_ERR, batch=BATCH, **kw):
    """The eager chunks' counters and lane-iterations summed: ``mc_chunk``'s
    without a mesh, the chunk body with data shard ``shard``'s generators
    on one."""
    counters, iters = np.zeros(9, np.int64), 0
    for c in chunks:
        if shard:
            cnt, its = montecarlo._chunk_body(
                graphs, test, chunk_generator(seed, c, device, *shard),
                weight, p, cfg, batch, "weight")
        else:
            cnt, its = mc_chunk(graphs, test, seed, c, weight, p, cfg, batch,
                                relay_retries=relay, device=device, **kw)
        counters += cnt.cpu().numpy()
        iters += int(its.sum())
    return counters, iters


@pytest.mark.parametrize("path", ["cpu", "cpu-relay", "mesh"])
def test_eager_paths_replay_nothing(g42, path):
    """A CPU run, a relay run and a mesh run (one gloo rank) count what
    the eager chunks count, record no capture and count 0 replays."""
    graphs, test = g42
    cfg = BPConfig(max_iters=20, algorithm="min-sum")
    relay = 3 if path == "cpu-relay" else 0
    if path == "mesh":
        ((counters, iters), recorded), = spawn(
            torch_mesh_workers.recorded_run, 1, device_type="cpu",
            args=(PARAMS, SEED, P_ERR, 4 * BATCH, BATCH), timeout=300)
        want = eager_sum(graphs, test, range(4), cfg, shard=(0,))
    else:
        with tracing.recording() as rec:
            counters, iters = run_monte_carlo(
                graphs, 3, 4 * BATCH, P_ERR, cfg, SEED, batch_size=BATCH,
                steps_per_call=2, relay_retries=relay, i_minus_p=test,
                device="cpu")
        recorded = rec.counters
        want = eager_sum(graphs, test, range(4), cfg, relay)
    np.testing.assert_array_equal(counters, want[0])
    assert iters == want[1]
    assert recorded["mc.graph_replays"] == 0
    assert "mc.graph_captures" not in recorded


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    return CUDA


def _cell(name: str, device):
    """(graphs, logical test, run_monte_carlo arguments) of the benchmark's
    counting cells' shapes, [[610,61]] sum-product at weight 15 and the
    gross code's min-sum under depolarizing noise, and of the other
    counting decoders: the dynamic sampler's 20 candidates, min-sum (K2)
    and layered min-sum (K3) on [[610,61]], sum-product on the gross code
    (K6)."""
    code_name, algorithm = name.split("-")[:2]
    algorithm = {"sp": "sum-product", "ms": "min-sum",
                 "layered": "layered-min-sum"}[algorithm]
    cfg = BPConfig(max_iters=100, algorithm=algorithm)
    if code_name == "gross":
        code = bicycle_code(12, 6, "x3 + y + y2", "y3 + x + x2")
        graphs = code.build_graphs()
        kw = dict(weight=0, error_model="depolarizing", cfg=cfg)
    else:
        code = construct_code(4, 5, 10, 61, 9, 49)
        graphs = CodeGraphs.build(code)
        kw = dict(weight=15, error_model="weight", cfg=cfg)
        if name.endswith("cap20"):
            kw["weight_cap"] = 20
    return graphs, make_rank_basis_test(code, device), kw


def plain_counters(graphs, test, chunks, cfg, seed, weight, p, batch,
                   error_model, device, weight_cap=None) -> np.ndarray:
    """The counters of chunks ``chunks`` on their own draws, decoded by the
    plain PyTorch decoders (``decode_batch(plain=True)``).  The plain path
    counts whole iterations for every lane, so its lane-iterations are not
    the kernels' and are not compared."""
    counters = np.zeros(9, np.int64)
    for c in chunks:
        xe, ze, sx, sz = sample_syndromes(
            graphs, chunk_generator(seed, c, device), weight, p, batch,
            error_model, weight_cap)
        res = decode_batch(graphs, sx, sz, p, cfg, plain=True)
        counters += classify_batch(test, xe, ze,
                                   res.decisions_x.to(torch.int32),
                                   res.decisions_z.to(torch.int32),
                                   res.error_code).cpu().numpy()
    return counters


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["hi610-sp-w15", "hi610-sp-w15-cap20",
                                  "hi610-ms-w15", "hi610-layered-w15",
                                  "gross-ms-p01", "gross-sp-p01"])
def test_replayed_chunks_count_what_eager_chunks_count(cuda_device, cell):
    """Counters, lane-iterations and each group's ``progress`` equal the
    eager chunks' (``mc_chunk``) bit for bit, and each group's counters
    those of the plain decoders on the same draws: every call captures
    after its first chunk and replays the rest, at two seeds and at
    another p."""
    graphs, test, kw = _cell(cell, cuda_device)
    batch, chunks = 2048, 4
    extra = {"weight_cap": kw["weight_cap"]} if "weight_cap" in kw else {}
    for seed, p in ((2**40 + 7, 0.01), (5, 0.01), (2**40 + 7, 0.02)):
        groups = []
        with tracing.recording() as rec:
            counters, iters = run_monte_carlo(
                graphs, count=chunks * batch, error_probability=p, seed=seed,
                batch_size=batch, steps_per_call=2, i_minus_p=test,
                progress=lambda g, ng, c, it: groups.append((c.copy(), it)),
                device=cuda_device, **kw)
        assert rec.counters["mc.graph_captures"] == 1
        assert rec.counters["mc.graph_replays"] == chunks - 1
        for g, (got, got_iters) in enumerate(groups):
            ids = range(2 * g, 2 * g + 2)
            want = eager_sum(graphs, test, ids, kw["cfg"], device=cuda_device,
                             seed=seed, weight=kw["weight"], p=p, batch=batch,
                             error_model=kw["error_model"], **extra)
            np.testing.assert_array_equal(got, want[0])
            assert got_iters == want[1]
            np.testing.assert_array_equal(got, plain_counters(
                graphs, test, ids, kw["cfg"], seed, kw["weight"], p, batch,
                kw["error_model"], cuda_device, **extra))
        assert counters[0] == chunks * batch
        np.testing.assert_array_equal(counters, sum(c for c, _ in groups))
        assert iters == sum(it for _, it in groups)
