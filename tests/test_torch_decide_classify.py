"""The fused decide -> classify of the counting chunk
(kernels/classify_cuda.py, csrc/decide_classify.cu) and its dispatch in
``parallel/montecarlo.py::_chunk_body``.

On the CPU: the plain route is today's composition (``decode_batch`` and
``classify_batch``) counter for counter; a NumPy model of the kernel's
algorithm, reading :func:`classify_cuda.prepare`'s tables as the kernel
does, counts what the plain route counts, on planted NaN, zeros and
threshold values and with a sector of rank 0; the dispatch predicate.  On
a card (``cuda``): the kernel against the plain route bit for bit at the
counting cells' shapes, ``run_monte_carlo``'s graph path against the eager
chunks, and the launch and engagement counts.

Imports neither JAX nor the JAX package, so the ``cuda`` cases also run on
a machine with a card:
``python -m pytest --noconftest -m cuda tests/test_torch_decide_classify.py -q``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from qec_ldpc_tpu_torch import construct_code, tracing
from qec_ldpc_tpu_torch.codes import bicycle_code
from qec_ldpc_tpu_torch.decoder import BPConfig, CodeGraphs
from qec_ldpc_tpu_torch.decoder.decode import decode_batch, run_decoder
from qec_ldpc_tpu_torch.decoder.min_sum import np_log_band
from qec_ldpc_tpu_torch.kernels import classify_cuda
from qec_ldpc_tpu_torch.parallel import montecarlo
from qec_ldpc_tpu_torch.parallel.chunk import (
    accumulators,
    chunk_generator,
    chunk_group,
    sample_syndromes,
)
from qec_ldpc_tpu_torch.parallel.montecarlo import fused_path, run_monte_carlo
from qec_ldpc_tpu_torch.sampling import (
    RankBasisTest,
    classify_batch,
    make_rank_basis_test,
)

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

SEED, BATCH = 13, 64
ALGORITHMS = ("sum-product", "min-sum")
CUDA = torch.device("cuda", 0)


def _code(name: str):
    """(code, graphs, weight, p, error model) of a small circulant code, the
    [[610,61]] code, the gross code or [[756,16,34]]."""
    if name == "c42":
        code = construct_code(3, 3, 6, 7, 2, 3)
        return code, CodeGraphs.build(code), 3, 0.02, "weight"
    if name == "hi610":
        code = construct_code(4, 5, 10, 61, 9, 49)
        return code, CodeGraphs.build(code), 15, 0.01, "weight"
    if name == "gross":
        code = bicycle_code(12, 6, "x3 + y + y2", "y3 + x + x2")
        return code, code.build_graphs(), 0, 0.03, "depolarizing"
    code = bicycle_code(21, 18, "x3 + y10 + y17", "y5 + x3 + x19")
    return code, code.build_graphs(), 0, 0.10, "depolarizing"


@pytest.fixture(scope="module", params=["c42", "gross"])
def small(request):
    code, graphs, weight, p, model = _code(request.param)
    return graphs, make_rank_basis_test(code, "cpu"), weight, p, model


def chunk_inputs(graphs, cfg, weight, p, model, batch, device, chunk=0,
                 max_iters=None):
    """One chunk's (messages, syndromes, errors, lane_iters) pairs, decoded
    by ``cfg.algorithm``'s kernel wrapper (its plain loop on the CPU)."""
    if max_iters is not None:
        cfg = dataclasses.replace(cfg, max_iters=max_iters)
    xe, ze, sx, sz = sample_syndromes(
        graphs, chunk_generator(SEED, chunk, device), weight, p, batch, model)
    prior = np.float32(cfg.prior_factor) * np.float32(p)
    (vx, itx), (vz, itz) = (run_decoder(g, s, prior, cfg)
                            for g, s in ((graphs.x, sx), (graphs.z, sz)))
    return (vx, vz), (sx, sz), (xe, ze), (itx, itz)


def fresh(device, start: bool = False):
    """Accumulators, zero or (``start``) already holding counts."""
    if start:
        return (torch.arange(9, dtype=torch.int64, device=device) * 1000 + 7,
                torch.tensor([5, 11], dtype=torch.int64, device=device))
    return (torch.zeros(9, dtype=torch.int64, device=device),
            torch.zeros(2, dtype=torch.int64, device=device))


def kernel_model(tables, cfg, messages, syndromes, errors, lane_iters):
    """csrc/decide_classify.cu's algorithm in NumPy, on the tables as the
    kernel reads them: each variable's edges through ``to_var`` rows, each
    check's variables through ``var_of_edge`` at (c / P * Dc + k) * P +
    c % P, the residual packed into words and tested against the packed
    basis rows that ``row_of`` selects.  Returns (counters (9,), iters
    (2,)) int64."""
    n = tables.graphs.code.n
    words = -(-n // 32)
    thr, low, high, band = (np.float32(x) for x in (
        cfg.hard_threshold, cfg.conv_low, cfg.conv_high,
        np_log_band(cfg.conv_low)))
    flags = {}
    residual = []
    for side, g, v, s, e, to_var, voe in zip(
            "xz", (tables.graphs.x, tables.graphs.z), messages, syndromes,
            errors, tables.to_var, tables.var_of_edge):
        v, s, e = v.numpy(), s.numpy(), e.numpy()
        x = v[to_var.numpy().reshape(g.var_degree, n)]  # (dv, n, batch)
        with np.errstate(invalid="ignore"):
            if cfg.algorithm == "min-sum":
                bit = (x <= 0).any(axis=0)
                conv = (np.abs(x) < band).any(axis=(0, 1))
            else:
                bit = (x >= thr).any(axis=0)
                conv = ((x != 0) & (x > low) & (x < high)).any(axis=(0, 1))
        c = np.arange(g.num_checks)
        base = (c // g.P) * g.check_degree * g.P + c % g.P
        rows = base[:, None] + np.arange(g.check_degree)[None, :] * g.P
        parity = np.bitwise_xor.reduce(
            bit[voe.numpy()[rows]].astype(np.int32), axis=1)
        flags["syn_" + side] = (parity != s).any(axis=0)
        flags["conv_" + side] = conv
        flags["tested_" + side] = (e != 0).any(axis=0)
        residual.append(bit ^ ((e & 1) != 0))
    undetected = ~(flags["syn_x"] | flags["syn_z"])
    logical = np.zeros_like(undetected)
    for r, basis, row_of in zip(residual, tables.basis, tables.row_of):
        basis = basis.numpy().view(np.uint32)
        row_of = row_of.numpy()
        padded = np.zeros((32 * words, r.shape[1]), dtype=np.uint8)
        padded[:n] = r
        packed = np.ascontiguousarray(np.packbits(
            padded.T, axis=1, bitorder="little")).view("<u4")
        for b in np.flatnonzero(undetected):
            acc = np.zeros(words, dtype=np.uint32)
            for p in np.flatnonzero(r[:, b]):
                if row_of[p] >= 0:
                    acc ^= basis[row_of[p]]
            logical[b] |= bool((acc != packed[b]).any())
    counters = np.array([
        r.shape[1], flags["tested_x"].sum(), flags["tested_z"].sum(),
        (undetected & ~logical).sum(), flags["syn_x"].sum(),
        flags["syn_z"].sum(), (undetected & logical).sum(),
        flags["conv_x"].sum(), flags["conv_z"].sum()], dtype=np.int64)
    return counters, np.array([int(it.sum()) for it in lane_iters])


def planted(messages, cfg, seed: int):
    """The messages with a quarter of the lanes' edges set, at random, to
    NaN, +-0, the decision threshold and its float32 neighbours, the
    convergence bounds, the min-sum band and their neighbours."""
    thr, low, high, band = (np.float32(x) for x in (
        cfg.hard_threshold, cfg.conv_low, cfg.conv_high,
        np_log_band(cfg.conv_low)))
    values = [np.nan, 0.0, -0.0, thr, low, high, band, -band]
    values += [np.nextafter(x, np.float32(d)) for x in (thr, low, high, band)
               for d in (-np.inf, np.inf)]
    values = np.array(values, dtype=np.float32)
    rng = np.random.default_rng(seed)
    out = []
    for v in messages:
        a = v.cpu().numpy().copy()
        hit = (rng.random(a.shape) < 0.05) & (rng.random(a.shape[1]) < 0.25)
        a[hit] = rng.choice(values, size=int(hit.sum()))
        out.append(torch.as_tensor(a, device=v.device))
    return tuple(out)


# -- CPU ----------------------------------------------------------------------

@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("chunk", [0, 1])
def test_plain_route_is_decode_batch_and_classify_batch(small, algorithm,
                                                        chunk):
    """The plain version counts what ``decode_batch`` and ``classify_batch``
    count and sums ``decode_batch``'s lane-iterations, chunk by chunk."""
    graphs, test, weight, p, model = small
    cfg = BPConfig(max_iters=20, algorithm=algorithm)
    tables = classify_cuda.prepare(graphs, test)
    msgs, syns, errs, its = chunk_inputs(graphs, cfg, weight, p, model,
                                         BATCH, "cpu", chunk=chunk)
    counters, iters = classify_cuda.decide_classify_plain(tables, cfg, msgs,
                                                          syns, errs, its)
    res = decode_batch(graphs, *syns, p, cfg)
    want_c = classify_batch(test, *errs, res.decisions_x.to(torch.int32),
                            res.decisions_z.to(torch.int32), res.error_code)
    want_i = torch.stack([res.iter_samples_x, res.iter_samples_z])
    torch.testing.assert_close(counters, want_c, rtol=0, atol=0)
    torch.testing.assert_close(iters, want_i.to(iters.dtype), rtol=0, atol=0)
    assert int(counters[0]) == BATCH


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_cpu_tensors_are_refused(small, algorithm):
    """The kernel's wrapper has no CPU route: CPU tensors raise, launch
    nothing and leave the accumulators as they were."""
    graphs, test, weight, p, model = small
    cfg = BPConfig(max_iters=20, algorithm=algorithm)
    tables = classify_cuda.prepare(graphs, test)
    msgs, syns, errs, its = chunk_inputs(graphs, cfg, weight, p, model,
                                         BATCH, "cpu")
    counters, iters = fresh("cpu", start=True)
    want_c, want_i = (t.clone() for t in (counters, iters))
    launches = classify_cuda.launches
    with pytest.raises(ValueError, match="unsupported device cpu"):
        classify_cuda.decide_classify(tables, cfg, msgs, syns, errs, its,
                                      counters, iters)
    assert classify_cuda.launches == launches
    assert counters.tolist() == want_c.tolist()
    assert iters.tolist() == want_i.tolist()


@pytest.mark.parametrize("same", ["graphs-and-test", "other-test"])
def test_prepare_keeps_the_last_tables(small, same):
    """``prepare`` returns its last tables again for the same graphs and
    test object, and makes new ones for another test."""
    graphs, test, _, _, _ = small
    first = classify_cuda.prepare(graphs, test)
    if same == "graphs-and-test":
        assert classify_cuda.prepare(graphs, test) is first
        return
    other = RankBasisTest(*(t.clone() for t in test))
    again = classify_cuda.prepare(graphs, other)
    assert again is not first and again.test is other
    for a, b in zip((*first.basis, *first.row_of),
                    (*again.basis, *again.row_of)):
        assert a is not b and torch.equal(a, b)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("inputs", ["decoded", "planted", "short"])
def test_kernel_model_counts_what_the_plain_route_counts(small, algorithm,
                                                         inputs):
    """The kernel's algorithm on the prepared tables counts what the plain
    route counts: on decoded messages, on messages with planted NaN, +-0 and
    values on and beside the thresholds, and after 3 iterations, where most
    lanes fail their syndromes and fail to converge."""
    graphs, test, weight, p, model = small
    cfg = BPConfig(max_iters=20, algorithm=algorithm)
    tables = classify_cuda.prepare(graphs, test)
    msgs, syns, errs, its = chunk_inputs(
        graphs, cfg, weight, 4 * p if model == "depolarizing" else p, model,
        BATCH, "cpu", max_iters=3 if inputs == "short" else None)
    if inputs == "planted":
        msgs = planted(msgs, cfg, seed=5)
    want_c, want_i = classify_cuda.decide_classify_plain(tables, cfg, msgs,
                                                         syns, errs, its)
    got_c, got_i = kernel_model(tables, cfg, msgs, syns, errs, its)
    np.testing.assert_array_equal(got_c, want_c.numpy())
    np.testing.assert_array_equal(got_i, want_i.numpy())
    # some lanes reach the logical test
    assert want_c[3] + want_c[6] > 0 or inputs == "short"


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("empty", ["x", "z"])
def test_sector_of_rank_zero(small, algorithm, empty):
    """A sector whose harmless space is {0}: every nonzero residual there
    is logical, in the kernel's model as in ``classify_batch``."""
    graphs, test, weight, p, model = small
    n = graphs.code.n
    none = (torch.zeros((0, n), dtype=torch.int8),
            torch.zeros((0,), dtype=torch.int64))
    test = RankBasisTest(*(none if empty == "x" else test[:2]),
                         *(none if empty == "z" else test[2:]))
    cfg = BPConfig(max_iters=20, algorithm=algorithm)
    tables = classify_cuda.prepare(graphs, test)
    assert tables.basis[0 if empty == "x" else 1].shape == (0, -(-n // 32))
    msgs, syns, errs, its = chunk_inputs(graphs, cfg, weight, 2 * p, model,
                                         4 * BATCH, "cpu")
    want_c, _ = classify_cuda.decide_classify_plain(tables, cfg, msgs, syns,
                                                    errs, its)
    got_c, _ = kernel_model(tables, cfg, msgs, syns, errs, its)
    np.testing.assert_array_equal(got_c, want_c.numpy())
    assert want_c[6] > 0  # nonzero residuals of the empty sector count


@pytest.mark.parametrize("n", [1, 31, 32, 33, 144, 610])
def test_pack_rows_round_trip(n):
    """Packed rows unpack to the rows: bit j of row t at bit j % 32 of word
    j // 32, bit 31 included (the int32 word then negative)."""
    rng = np.random.default_rng(n)
    rows = rng.integers(0, 2, size=(7, n), dtype=np.int8)
    rows[0] = 1
    packed = classify_cuda.pack_rows(torch.as_tensor(rows))
    assert packed.dtype == torch.int32 and packed.shape == (7, -(-n // 32))
    bits = np.unpackbits(packed.numpy().view(np.uint8), axis=1,
                         bitorder="little")[:, :n]
    np.testing.assert_array_equal(bits, rows)
    if n >= 32:
        assert packed[0, 0] == -1


def _dense(n=4):
    return torch.zeros((2 * n, 2 * n), dtype=torch.int8)


@pytest.mark.parametrize("device,relay,algorithm,roll,test,fused", [
    (CUDA, 0, "sum-product", "shift", "basis", True),
    (CUDA, 0, "min-sum", "shift", "basis", True),
    (CUDA, 0, "layered-min-sum", "shift", "basis", False),
    (CUDA, 4, "min-sum", "shift", "basis", False),
    (CUDA, 0, "min-sum", "shift", "dense", False),
    (CUDA, 0, "sum-product", "mxu", "basis", False),
    (torch.device("cpu"), 0, "sum-product", "shift", "basis", False),
    (torch.device("cpu"), 0, "min-sum", "shift", "basis", False),
])
def test_dispatch_predicate(device, relay, algorithm, roll, test, fused):
    """The fused path needs a CUDA device, no relay, sum-product or
    min-sum and a rank-basis test; layered min-sum, relay, a dense
    ``i_minus_p``, the TPU's "mxu" routing and the CPU take the other."""
    logical = (RankBasisTest(*(torch.zeros(0),) * 4) if test == "basis"
               else _dense())
    cfg = BPConfig(algorithm=algorithm, kernel_roll_impl=roll)
    assert fused_path(device, relay, cfg, logical) is fused


@pytest.mark.parametrize("algorithm,relay", [("sum-product", 0),
                                             ("min-sum", 0),
                                             ("layered-min-sum", 0),
                                             ("min-sum", 3)])
def test_cpu_chunks_count_zero_fused(algorithm, relay):
    """On the CPU every chunk takes the other path: ``classify.fused``
    counts 0 a chunk, so its reader reads 0, and no kernel launches."""
    code, graphs, weight, p, model = _code("c42")
    test = make_rank_basis_test(code, "cpu")
    cfg = BPConfig(max_iters=20, algorithm=algorithm)
    launches = classify_cuda.launches
    with tracing.recording() as rec:
        run_monte_carlo(graphs, weight, 3 * BATCH, p, cfg, SEED,
                        batch_size=BATCH, relay_retries=relay,
                        i_minus_p=test, error_model=model, device="cpu")
    assert rec.counters["classify.fused"] == 0
    assert classify_cuda.launches == launches


# -- on a card ------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA kernel has no CPU mode)")
    return CUDA


@pytest.fixture(scope="module")
def cards():
    """Each code's (graphs, weight, p, error model, code) by name."""
    return {}


def _on_card(cards, name, device):
    if name not in cards:
        code, graphs, weight, p, model = _code(name)
        cards[name] = (graphs, make_rank_basis_test(code, device), weight, p,
                       model)
    return cards[name]


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [2048, 16384, 1000])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("name", ["hi610", "gross", "bb756"])
def test_kernel_equals_plain_on_the_card(cuda_device, cards, name,
                                         algorithm, batch):
    """Counters and lane-iteration sums of the kernel equal the plain
    route's on the card bit for bit, on decoded messages and on messages
    with planted special values, into non-zero accumulators."""
    graphs, test, weight, p, model = _on_card(cards, name, cuda_device)
    cfg = BPConfig(max_iters=100, algorithm=algorithm)
    tables = classify_cuda.prepare(graphs, test)
    msgs, syns, errs, its = chunk_inputs(graphs, cfg, weight, p, model,
                                         batch, cuda_device)
    for case in ("decoded", "planted"):
        if case == "planted":
            msgs = planted(msgs, cfg, seed=batch)
        counters, iters = fresh(cuda_device, start=True)
        want_c, want_i = (t.clone() for t in (counters, iters))
        launches = classify_cuda.launches
        classify_cuda.decide_classify(tables, cfg, msgs, syns, errs, its,
                                      counters, iters)
        assert classify_cuda.launches == launches + 1
        cnt, itr = classify_cuda.decide_classify_plain(tables, cfg, msgs,
                                                       syns, errs, its)
        want_c += cnt
        want_i += itr
        torch.cuda.synchronize()
        assert counters.tolist() == want_c.tolist(), case
        assert iters.tolist() == want_i.tolist(), case
        assert counters[0] - 7 == batch


@pytest.mark.cuda
@pytest.mark.parametrize("name,algorithm", [("hi610", "sum-product"),
                                            ("gross", "min-sum")])
def test_graph_path_counts_what_eager_chunks_count(cuda_device, cards, name,
                                                   algorithm):
    """``run_monte_carlo`` on the graph path (fused kernel captured and
    replayed) counts, group by group, what eager chunks count through the
    group loop (``chunk_group``) on the same seed, counters and lane-iterations, and what the unfused
    composition (``decode_batch`` + ``classify_batch``) counts; every chunk
    adds 1 to ``classify.fused``, and on the gross code 1 to
    ``decode.paired``."""
    graphs, test, weight, p, model = _on_card(cards, name, cuda_device)
    cfg = BPConfig(max_iters=100, algorithm=algorithm)
    batch, chunks, seed = 2048, 6, 2**40 + 9
    groups = []
    launches = classify_cuda.launches
    with tracing.recording() as rec:
        run_monte_carlo(graphs, weight, chunks * batch, p, cfg, seed,
                        batch_size=batch, steps_per_call=3, i_minus_p=test,
                        error_model=model, device=cuda_device,
                        progress=lambda g, ng, c, it: groups.append((c, it)))
    assert rec.counters["mc.graph_replays"] == chunks - 1
    assert rec.counters["classify.fused"] == chunks
    # the gross code's two graphs decode in one K5 launch a chunk
    assert rec.counters["decode.paired"] == chunks * (name == "gross")
    assert classify_cuda.launches == launches + 2  # eager chunk, capture
    fused = fused_path(cuda_device, 0, cfg, test)
    eager = montecarlo._chunk_runner(graphs, test, seed, weight, p, cfg,
                                     batch, model, 0, None, fused,
                                     cuda_device)
    for g, (got, got_iters) in enumerate(groups):
        ids = range(3 * g, 3 * g + 3)
        counters, iters = chunk_group(eager, ids, accumulators(cuda_device),
                                      fused)
        assert got.tolist() == counters.tolist()
        assert got_iters == int(iters.sum())
        unfused = np.zeros(9, np.int64)
        for c in ids:
            xe, ze, sx, sz = sample_syndromes(
                graphs, chunk_generator(seed, c, cuda_device),
                weight, p, batch, model)
            res = decode_batch(graphs, sx, sz, p, cfg)
            unfused += classify_batch(
                test, xe, ze, res.decisions_x.to(torch.int32),
                res.decisions_z.to(torch.int32),
                res.error_code).cpu().numpy()
        np.testing.assert_array_equal(got, unfused)


@pytest.mark.cuda
def test_each_eager_chunk_launches_once(cuda_device, cards):
    """``mc_chunk`` on the card launches the kernel once a chunk and counts
    1 in ``classify.fused`` a chunk; its counters are int64 and its
    tables are made once, at the first chunk."""
    graphs, test, weight, p, model = _on_card(cards, "hi610", cuda_device)
    cfg = BPConfig(max_iters=100, algorithm="sum-product")
    launches = classify_cuda.launches
    with tracing.recording() as rec:
        tables = []
        for c in range(3):
            counters, _ = montecarlo.mc_chunk(graphs, test, SEED, c, weight,
                                              p, cfg, 2048,
                                              error_model=model,
                                              device=cuda_device)
            assert classify_cuda.launches == launches + c + 1
            assert counters.dtype == torch.int64
            tables.append(classify_cuda.prepare(graphs, test))
    assert rec.counters["classify.fused"] == 3
    assert tables[0] is tables[1] is tables[2]
