"""Monte-Carlo estimation of logical-error statistics (PyTorch).

The port of ``qec_ldpc_tpu/parallel/montecarlo.py::run_monte_carlo``, for
circulant and lifted codes alike.  Each chunk runs the whole pipeline on
one device:

  sample errors -> syndromes -> X/Z decode [-> relay retries] -> classify
  -> counters.

Chunk c draws from generators of (seed, c), so the statistics do not
depend on how chunks are grouped; these and the other per-chunk primitives
live beneath this module and parallel/mc_graph.py, in parallel/chunk.py.
A group of ``steps_per_call`` chunks adds into counters on the device,
which the host reads once.  How a chunk runs is decided once a point: a
replay of a CUDA graph of the whole pipeline (:func:`graph_path`,
:class:`_ChunkGraph`), one kernel from the decoders' final messages to
the counters (:func:`fused_path`, kernels/classify_cuda.py), and one launch
for both graphs' decode (``decode.paired_path``, K5 on lifted codes).

With a ``mesh`` (parallel/mesh.py) every rank runs the same call and gets
the same totals: each data rank decodes its lanes from generators of (seed,
chunk, data index), the counterpart of JAX's ``fold_in(fold_in(key, c),
d)`` (:func:`make_sharded_chunk`, or parallel/mc_graph.py on a graph axis).

:func:`run_monte_carlo_osd` is the quality mode (the port of JAX's
function of that name, on one device or a data-only mesh): the same
samples, then OSD (decoder/osd.py) on the lanes BP and relay leave failed:

  sample -> syndromes -> decode with soft outputs [-> relay] -> classify
  the other lanes and move the failed ones to the front -> OSD on the
  failed lanes -> splice the corrections -> classify the failed lanes.

:func:`mc_chunk` and :func:`mc_chunk_arrays` are one chunk of the counting
path: its counters, or its per-lane arrays.

Not ported (TPU-only, invisible in the results): the power-of-two rounding
of the failed-lane fetch (``_gather_failed_lanes``), which bounded the
number of compiled shapes.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from qec_ldpc_tpu_torch import tracing
from qec_ldpc_tpu_torch.decoder.decode import (
    SYNDROME_FAIL_X,
    SYNDROME_FAIL_Z,
    CodeGraphs,
    decode_batch,
    paired_path,
    run_decoders,
)
from qec_ldpc_tpu_torch.decoder.osd import CSSPostprocessor, splice
from qec_ldpc_tpu_torch.decoder.relay import RelayDraws, relay_decode_batch
from qec_ldpc_tpu_torch.decoder.sum_product import BPConfig
from qec_ldpc_tpu_torch.kernels import classify_cuda
from qec_ldpc_tpu_torch.parallel.chunk import (
    _Fetch,
    accumulators,
    chunk_generator,
    chunk_group,
    compact_chunk,
    data_shard,
    gather_arrays,
    reduce_over_data,
    relay_draws,
    sample_syndromes,
)
from qec_ldpc_tpu_torch.parallel.mc_graph import (
    make_graph_sharded_chunk,
    make_graph_sharded_osd_chunk,
)
from qec_ldpc_tpu_torch.parallel.mesh import DATA_AXIS, GRAPH_AXIS, Mesh
from qec_ldpc_tpu_torch.sampling.classify import (
    NUM_COUNTERS,
    RankBasisTest,
    classify_batch,
    make_rank_basis_test,
)
from qec_ldpc_tpu_torch.sampling.errors import generator_seed


def _resolve_logical_test(graphs: CodeGraphs, i_minus_p, device):
    """None -> rank-basis test of the code (the reference convention for
    QC-CSS codes, the physical one for bivariate bicycle and
    hypergraph-product codes); a dense matrix (array or tensor) goes to
    ``device``; a RankBasisTest passes through."""
    if i_minus_p is None:
        return make_rank_basis_test(graphs.code, device)
    if isinstance(i_minus_p, RankBasisTest):
        return i_minus_p
    if isinstance(i_minus_p, torch.Tensor):
        return i_minus_p.to(device)
    return torch.as_tensor(np.asarray(i_minus_p), device=device)


def _sample_and_decode(graphs: CodeGraphs, generator: torch.Generator,
                       weight: int, error_probability: float, cfg: BPConfig,
                       batch: int, error_model: str, relay_retries: int = 0,
                       draws: RelayDraws | None = None,
                       weight_cap: int | None = None,
                       lanes: slice | None = None):
    """Sample errors -> syndromes -> decode (relay-repaired when
    ``relay_retries > 0``, the gammas from ``draws``).  Returns
    (xe, ze, sx, sz, res) with errors as int32; ``weight_cap`` and
    ``lanes`` as in :func:`sample_syndromes`."""
    xe_i, ze_i, sx, sz = sample_syndromes(graphs, generator, weight,
                                          error_probability, batch,
                                          error_model, weight_cap, lanes)
    if relay_retries > 0:
        res, _, _ = relay_decode_batch(graphs, sx, sz, error_probability,
                                       draws, cfg, retries=relay_retries)
    else:
        res = decode_batch(graphs, sx, sz, error_probability, cfg)
    return xe_i, ze_i, sx, sz, res


def fused_path(device: torch.device, relay_retries: int, cfg: BPConfig,
               i_minus_p) -> bool:
    """Whether a counting chunk decides and classifies in one kernel
    (``classify_cuda.decide_classify``): on a CUDA device, with no relay
    (whose retries replace lanes' decisions), for sum-product or min-sum
    (layered min-sum decides from posteriors) under a rank-basis logical
    test.  A configuration ``decode_batch`` refuses (the TPU's "mxu"
    routing) takes the other path, which refuses it."""
    return (device.type == "cuda" and relay_retries == 0
            and cfg.algorithm in classify_cuda.ALGORITHMS
            and cfg.kernel_roll_impl != "mxu"
            and isinstance(i_minus_p, RankBasisTest))


def _chunk_body(graphs: CodeGraphs, i_minus_p, generator: torch.Generator,
                weight: int, error_probability: float, cfg: BPConfig,
                batch: int, error_model: str, relay_retries: int = 0,
                draws: RelayDraws | None = None,
                weight_cap: int | None = None, *, fused: bool = False,
                paired: bool = False, into=None):
    """Sample + decode + classify one batch, added into ``into``, a pair of
    int64 device accumulators (counters[NUM_COUNTERS], iters[2]), fresh
    zeros when None, which it returns; iters are the executed BP
    lane-iterations for [X, Z], relay retries included.

    ``fused``: the point's :func:`fused_path` decision.  Where it holds, the
    decoders' final messages go to ``classify_cuda.decide_classify`` (its
    tables from ``prepare``, made in the point's set-up), which adds the
    chunk into the accumulators, and ``paired``, the point's
    ``decode.paired_path`` decision, says whether the two graphs decode in
    one launch."""
    if into is None:
        into = (torch.zeros(NUM_COUNTERS, dtype=torch.int64,
                            device=generator.device),
                torch.zeros(2, dtype=torch.int64, device=generator.device))
    if fused:
        xe_i, ze_i, sx, sz = sample_syndromes(
            graphs, generator, weight, error_probability, batch, error_model,
            weight_cap)
        prior = np.float32(cfg.prior_factor) * np.float32(error_probability)
        with tracing.span("mc.decode"):
            (vx, itx), (vz, itz) = run_decoders(graphs, (sx, sz), prior,
                                                cfg, paired)
        with tracing.span("mc.classify"):
            classify_cuda.decide_classify(
                classify_cuda.prepare(graphs, i_minus_p), cfg, (vx, vz),
                (sx, sz), (xe_i, ze_i), (itx, itz), *into)
        return into
    xe_i, ze_i, _, _, res = _sample_and_decode(
        graphs, generator, weight, error_probability, cfg, batch, error_model,
        relay_retries, draws, weight_cap)
    with tracing.span("mc.classify"):
        counters = classify_batch(i_minus_p, xe_i, ze_i,
                                  res.decisions_x.to(torch.int32),
                                  res.decisions_z.to(torch.int32),
                                  res.error_code)
    iters = torch.stack([res.iter_samples_x, res.iter_samples_z])
    into[0].add_(counters)
    into[1].add_(iters)
    return into


def _chunk_runner(graphs: CodeGraphs, i_minus_p, seed: int, weight: int,
                  error_probability: float, cfg: BPConfig, batch: int,
                  error_model: str, relay_retries: int,
                  weight_cap: int | None, fused: bool, device: torch.device,
                  shard: tuple[int, ...] = (), replay: bool = False,
                  paired: bool = False):
    """:func:`chunk_group`'s ``run(c, into)`` for a point's chunks through
    :func:`_chunk_body`: replayed from a CUDA graph (:class:`_ChunkGraph`)
    where ``replay``, else eager on the generators of (seed, c, ``shard``),
    ``shard`` the rank's mesh indices."""
    body = functools.partial(
        _chunk_body, graphs, i_minus_p, weight=weight,
        error_probability=error_probability, cfg=cfg, batch=batch,
        error_model=error_model, relay_retries=relay_retries,
        weight_cap=weight_cap, fused=fused, paired=paired)
    if replay:
        return _ChunkGraph(body, device, seed).run

    def run(c, into):
        body(chunk_generator(seed, c, device, *shard),
             draws=relay_draws(seed, c, device, *shard)
             if relay_retries > 0 else None, into=into)
    return run


def _chunk_samples(batch_size: int, mesh: Mesh | None) -> int:
    """Samples per chunk: on a mesh, ``batch_size // num_data`` lanes on
    each data shard."""
    if mesh is None:
        return batch_size
    num_data = mesh.size(DATA_AXIS)
    return max(1, batch_size // num_data) * num_data


def effective_steps_per_call(count: int, batch_size: int,
                             steps_per_call: int, mesh: Mesh | None = None) -> int:
    """The steps_per_call :func:`run_monte_carlo` will actually use: the
    largest divisor of the number of chunks <= steps_per_call, unless that
    is below steps_per_call // 8 (the JAX driver's rule, kept so journals
    and group boundaries agree between the two packages)."""
    num_chunks = -(-count // _chunk_samples(batch_size, mesh))
    if num_chunks % steps_per_call:
        div = next((d for d in range(min(steps_per_call, num_chunks), 0, -1)
                    if num_chunks % d == 0), 1)
        if div >= max(1, steps_per_call // 8):
            steps_per_call = div
    return steps_per_call


def graph_path(device: torch.device, mesh: Mesh | None,
               relay_retries: int) -> bool:
    """Whether :func:`run_monte_carlo` replays a captured chunk: on one CUDA
    device, with no mesh and no relay (relay reads a flag from the device
    per retry, which no graph can hold)."""
    return device.type == "cuda" and mesh is None and relay_retries == 0


#: the stream each device captures on, kept as ``torch.cuda.graph`` keeps
#: its own: a stream's first matrix product allocates it a cuBLAS workspace
#: (32 MiB on the H100) for the life of the process
_CAPTURE_STREAMS: dict[torch.device, torch.cuda.Stream] = {}


class _ChunkGraph:
    """:func:`chunk_group`'s ``run(c, into)`` as a CUDA graph on one device
    (:meth:`run`; ``into`` the same accumulators at every call): the call's
    first chunk of ``body(generator, into=into)`` runs eagerly, then is
    captured, and the later chunks replay it.  The graph's generator is
    reseeded by the chunk's seed before each replay (``manual_seed``
    restarts its Philox offset at 0), so a replay draws what the chunk's
    fresh generator (:func:`chunk_generator`) draws.  The graph allocates
    from a memory pool of its own, freed with it.  The kernel wrappers'
    ``launches`` count the capture's calls, not the replays."""

    def __init__(self, body, device: torch.device, seed: int):
        self.body, self.device, self.seed = body, device, seed
        self.generator = torch.Generator(device=device)
        self.graph = self.pool = None

    def __del__(self):
        self.graph = None  # before its pool

    def run(self, chunk: int, into) -> None:
        if self.graph is None:
            return self._capture(chunk, into)
        with tracing.span("mc.sample"):
            self.generator.manual_seed(generator_seed([self.seed, chunk]))
        with tracing.span("mc.launch"):
            self.graph.replay()
        tracing.count("mc.graph_replays")

    def _capture(self, chunk: int, into) -> None:
        """Run chunk ``chunk`` eagerly (building the kernels and the caches
        the graph reads), then capture the body on the graph's generator."""
        with torch.cuda.device(self.device):
            stream = _CAPTURE_STREAMS.get(self.device)
            if stream is None:
                stream = _CAPTURE_STREAMS[self.device] = torch.cuda.Stream(
                    self.device)
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                self.body(chunk_generator(self.seed, chunk, self.device),
                          into=into)
                self.pool = torch.cuda.MemPool()
                graph = torch.cuda.CUDAGraph()
                graph.register_generator_state(self.generator)
                graph.capture_begin(self.pool.id,
                                    capture_error_mode="thread_local")
                try:
                    self.body(self.generator, into=into)
                finally:
                    graph.capture_end()
            torch.cuda.current_stream(self.device).wait_stream(stream)
        self.graph = graph
        tracing.count("mc.graph_captures")


class _Point:
    """What the two drivers share of one point: the mesh refusal, the
    logical test on ``device`` and the running totals from
    ``init_counters`` on, which :meth:`tally` extends."""

    def __init__(self, graphs: CodeGraphs, i_minus_p, mesh: Mesh | None,
                 device: torch.device, init_counters, progress):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise ValueError(f"mesh must be a parallel.mesh.Mesh, got "
                             f"{type(mesh).__name__}")
        self.i_minus_p = _resolve_logical_test(graphs, i_minus_p, device)
        self.counters = np.zeros(NUM_COUNTERS, dtype=np.int64)
        if init_counters is not None:
            self.counters += np.asarray(init_counters, dtype=np.int64)
        self.iters = 0
        self.progress = progress

    def tally(self, host: np.ndarray, index: int, num: int) -> None:
        """Add a fetched ``[counters | iters]`` vector, step ``index`` of
        ``num``, and hand it to ``progress`` in the span ``outside``."""
        counters, iters = host[:NUM_COUNTERS], int(host[NUM_COUNTERS:].sum())
        self.counters += counters
        self.iters += iters
        if self.progress is not None:
            with tracing.span(tracing.OUTSIDE):
                self.progress(index, num, counters, iters)


def mc_chunk(graphs: CodeGraphs, i_minus_p, seed: int, chunk: int,
             weight: int, error_probability: float, cfg: BPConfig,
             batch: int, error_model: str = "weight", relay_retries: int = 0,
             *, device: torch.device | str, weight_cap: int | None = None):
    """One chunk of :func:`run_monte_carlo` on ``device``: the ``batch``
    samples of global chunk ``chunk`` from the generators of (seed, chunk),
    decoded (relay-repaired when ``relay_retries > 0``) and classified.
    ``i_minus_p`` and ``weight_cap`` as in :func:`run_monte_carlo`.
    Returns int64 device tensors (counters[NUM_COUNTERS], iters[2]), iters
    the executed lane-iterations for [X, Z]."""
    device = torch.device(device)
    i_minus_p = _resolve_logical_test(graphs, i_minus_p, device)
    fused = fused_path(device, relay_retries, cfg, i_minus_p)
    paired = paired_path(graphs, cfg, device)
    out = _chunk_body(graphs, i_minus_p, chunk_generator(seed, chunk, device),
                      weight, error_probability, cfg, batch, error_model,
                      relay_retries, relay_draws(seed, chunk, device)
                      if relay_retries > 0 else None, weight_cap, fused=fused,
                      paired=paired)
    tracing.count("classify.fused", int(fused))
    tracing.count("decode.paired", int(paired))
    return out


def mc_chunk_arrays(graphs: CodeGraphs, seed: int, chunk: int, weight: int,
                    error_probability: float, cfg: BPConfig, batch: int,
                    error_model: str = "weight", relay_retries: int = 0,
                    *, device: torch.device | str, mesh: Mesh | None = None):
    """The samples and decode of :func:`mc_chunk` as per-lane arrays:
    ``(xe, ze, sx, sz)`` int8 and the DecodeResult (soft outputs when
    ``cfg.return_soft``), for debugging and analysis.

    ``mesh`` (a data-only mesh; every rank calls with its own ``device``):
    each data rank draws the chunk's full batch and each relay retry's
    gammas for the full batch, decodes its own columns, and every rank
    returns the full arrays (:func:`gather_arrays`): the ``mesh=None``
    call's, but for iteration totals, which depend on the partition on the
    plain path (each shard's loop exits on its own lanes)."""
    device = torch.device(device)
    if mesh is not None and mesh.size(GRAPH_AXIS) > 1:
        raise ValueError("a graph axis > 1 decodes graph-sharded: use "
                         "mc_graph.make_graph_sharded_arrays_chunk")
    lanes, lo = data_shard(mesh, batch)
    xe, ze, sx, sz, res = _sample_and_decode(
        graphs, chunk_generator(seed, chunk, device), weight,
        error_probability, cfg, batch, error_model, relay_retries,
        relay_draws(seed, chunk, device, width=batch, offset=lo)
        if relay_retries > 0 else None, lanes=lanes)
    return gather_arrays(mesh, xe, ze, sx, sz, res)


def make_sharded_chunk(mesh: Mesh, graphs: CodeGraphs, weight: int,
                       cfg: BPConfig, batch_per_device: int,
                       error_model: str = "weight", relay_retries: int = 0,
                       weight_cap: int | None = None):
    """The data-parallel chunk group of this rank: the returned
    ``chunk_fn(i_minus_p, seed, error_probability, chunk_ids, *, device)``
    decodes ``batch_per_device`` lanes of each chunk from the generators of
    (seed, chunk, data index) and returns the group's (counters, iters[2])
    summed over the data axis, the same on every rank.  ``weight_cap`` as
    in :func:`run_monte_carlo`."""
    didx = mesh.rank(DATA_AXIS)

    def chunk_fn(i_minus_p, seed, error_probability, chunk_ids, *, device):
        device = torch.device(device)
        fused = fused_path(device, relay_retries, cfg, i_minus_p)
        paired = paired_path(graphs, cfg, device)
        run = _chunk_runner(graphs, i_minus_p, seed, weight,
                            error_probability, cfg, batch_per_device,
                            error_model, relay_retries, weight_cap, fused,
                            device, (didx,), paired=paired)
        return reduce_over_data(mesh, *chunk_group(
            run, chunk_ids, accumulators(device), fused, paired))

    return chunk_fn


def run_monte_carlo(
    graphs: CodeGraphs,
    weight: int,
    count: int,
    error_probability: float,
    cfg: BPConfig,
    seed: int,
    batch_size: int = 1024,
    mesh: Mesh | None = None,
    error_model: str = "weight",
    progress: "callable | None" = None,
    start_chunk: int = 0,
    init_counters: np.ndarray | None = None,
    steps_per_call: int = 1,
    relay_retries: int = 0,
    i_minus_p=None,
    weight_cap: int | None = None,
    *,
    device: torch.device | str,
):
    """Accumulate statistics counters over ``count`` samples on ``device``.

    Chunks of ``batch_size`` samples run until >= count samples are tested
    (count is rounded up to whole chunks).  ``steps_per_call`` chunks form a
    group whose counters are read back once; ``progress(group, num_groups,
    counters, lane_iters)`` is called per group and ``start_chunk`` /
    ``init_counters`` resume at a group boundary.  ``i_minus_p``: a dense
    (2n x 2n) matrix or a RankBasisTest; defaults to the rank-basis test of
    ``graphs.code``.  ``relay_retries > 0`` repairs BP failures with that
    many damped min-sum retries (decoder/relay.py); each retry reads one
    flag from the device.

    ``mesh`` (parallel/mesh.py): every rank calls with the same arguments
    and its own ``device``; a chunk is ``batch_size // num_data`` samples
    per data shard, decoded data-parallel, or graph-sharded when the graph
    axis is > 1 (circulant codes).  The group's counters are summed over
    the data axis (one all_reduce) and every rank returns the totals.

    ``weight_cap`` (weight model; single device and data-only meshes): draw
    each sample's errors with the dynamic sampler, ``weight_cap`` candidate
    draws of which the first ``weight`` count, so every weight of a sweep
    draws from the same stream (the JAX package's rule, which the CLI's
    journal follows).  At ``weight == weight_cap`` the draws equal the
    static sampler's.  The graph-sharded path ignores it, as JAX's does.

    On one CUDA device with no mesh and no relay (:func:`graph_path`) the
    host launches one CUDA graph a chunk (:class:`_ChunkGraph`, dropped
    when the call returns), with the draws, counters, lane-iterations and
    ``progress`` calls of the eager chunks.  Where :func:`fused_path` holds
    too, decisions and classification are one kernel, whose tables are
    made once a point.

    Returns (counters[NUM_COUNTERS] int64 numpy, total_bp_lane_iterations).
    """
    device = torch.device(device)
    with tracing.span("mc.point"):
        with tracing.span("mc.point_setup"):
            point = _Point(graphs, i_minus_p, mesh, device, init_counters,
                           progress)
            i_minus_p = point.i_minus_p
            fused = fused_path(device, relay_retries, cfg, i_minus_p)
            if fused:
                classify_cuda.prepare(graphs, i_minus_p)  # the chunks' tables
            replaying = graph_path(device, mesh, relay_retries)
            # the chunk runner, picked once
            if mesh is not None:
                per_dev = max(1, batch_size // mesh.size(DATA_AXIS))
                chunk_fn = (make_graph_sharded_chunk(
                    mesh, graphs, weight, cfg, per_dev, error_model,
                    relay_retries) if mesh.size(GRAPH_AXIS) > 1
                    else make_sharded_chunk(mesh, graphs, weight, cfg,
                                            per_dev, error_model,
                                            relay_retries, weight_cap))

                def run_group(ids):
                    return chunk_fn(i_minus_p, seed, error_probability, ids,
                                    device=device)
            else:
                if replaying and device.index is None:
                    device = torch.device("cuda", torch.cuda.current_device())
                paired = paired_path(graphs, cfg, device)
                run = _chunk_runner(graphs, i_minus_p, seed, weight,
                                    error_probability, cfg, batch_size,
                                    error_model, relay_retries, weight_cap,
                                    fused, device, replay=replaying,
                                    paired=paired)
                into = accumulators(device)

                def run_group(ids):
                    return chunk_group(run, ids, into, fused, paired)
            num_chunks = -(-count // _chunk_samples(batch_size, mesh))
            steps_per_call = effective_steps_per_call(
                count, batch_size, steps_per_call, mesh)
            groups = [range(g, min(g + steps_per_call, num_chunks))
                      for g in range(0, num_chunks, steps_per_call)]
        for gi in range(start_chunk, len(groups)):
            with tracing.span("mc.group"):
                counters, iters = run_group(groups[gi])
                if not replaying:
                    # eager chunks replay no graph: the counter reads 0
                    tracing.count("mc.graph_replays", 0)
                both = torch.cat([counters, iters])
                with tracing.span("mc.fetch"):
                    host = both.cpu().numpy()  # one fetch
            point.tally(host, gi, len(groups))
    return point.counters, point.iters


def make_osd_chunk(graphs: CodeGraphs, weight: int, cfg: BPConfig,
                   batch: int, error_model: str = "weight",
                   relay_retries: int = 0, mesh: Mesh | None = None):
    """The device half of the quality mode's chunk on one device or a data
    mesh: ``chunk_fn(i_minus_p, seed, chunk, error_probability, *,
    device)`` samples global chunk ``chunk``'s full ``batch`` from the
    generator of (seed, chunk), decodes (with soft outputs when ``cfg``
    asks) this rank's columns, each relay retry drawing its gammas for the
    full batch, and returns :func:`compact_chunk` of them (the contract of
    ``mc_graph.make_graph_sharded_osd_chunk``)."""
    if mesh is not None and mesh.size(GRAPH_AXIS) > 1:
        raise ValueError("graph-sharded quality chunks live in "
                         "mc_graph.make_graph_sharded_osd_chunk")
    lanes, lo = data_shard(mesh, batch)

    def chunk_fn(i_minus_p, seed, chunk, error_probability, *, device):
        return compact_chunk(i_minus_p, *_sample_and_decode(
            graphs, chunk_generator(seed, chunk, device), weight,
            error_probability, cfg, batch, error_model, relay_retries,
            relay_draws(seed, chunk, device, width=batch, offset=lo)
            if relay_retries > 0 else None, lanes=lanes))

    return chunk_fn


def _repair_and_classify(post: CSSPostprocessor | None, i_minus_p,
                         counts: np.ndarray, bundle) -> torch.Tensor:
    """The tail of a quality-mode chunk: OSD-repair the failed lanes (the
    first ``counts[0]`` of the compacted bundle; none when ``post`` is None)
    and classify them.  The solves run where ``post``'s decoders route them
    (OSD-0 on the device, ``lam > 0`` on the host); splicing and
    classification stay on the bundle's device, where the X- and Z-failed
    lanes are found from their known counts, with no host read.  Returns
    the failed lanes' int32 counters on that device.  Counts the lanes
    handed to OSD in ``osd.lanes`` and the bits of their augmented systems
    ``[H_pi | s]``, lanes x m x (n + 1) summed over the sectors, in
    ``osd.system_bits``."""
    k, k_x, k_z = (int(v) for v in counts)
    with tracing.span("mc.osd"):
        if k == 0:
            return torch.zeros(NUM_COUNTERS, dtype=torch.int32,
                               device=bundle[-1].device)
        xe, ze, sx, sz, dx, dz, soft_x, soft_z, ec = (
            None if a is None else a[..., :k] for a in bundle)
        dec = {SYNDROME_FAIL_X: dx, SYNDROME_FAIL_Z: dz}
        if post is not None:
            tracing.count("osd.lanes", k_x + k_z)
            tracing.count("osd.system_bits",
                          sum(kb * osd.m * (osd.n + 1)
                              for kb, osd in ((k_x, post.x), (k_z, post.z))))
            for bit, osd, kb, syn, soft in (
                    (SYNDROME_FAIL_X, post.x, k_x, sx, soft_x),
                    (SYNDROME_FAIL_Z, post.z, k_z, sz, soft_z)):
                if kb:
                    failed = torch.argsort(((ec & bit) == 0).to(torch.int32),
                                           stable=True)[:kb]
                    dec[bit], ec = splice(osd, dec[bit], ec, bit, syn, soft,
                                          failed)
        return classify_batch(i_minus_p, xe, ze,
                              dec[SYNDROME_FAIL_X].to(torch.int32),
                              dec[SYNDROME_FAIL_Z].to(torch.int32), ec)


def run_monte_carlo_osd(
    graphs: CodeGraphs,
    weight: int,
    count: int,
    error_probability: float,
    cfg: BPConfig,
    seed: int,
    batch_size: int = 1024,
    lam: int = 0,
    error_model: str = "weight",
    progress: "callable | None" = None,
    relay_retries: int = 0,
    i_minus_p=None,
    start_chunk: int = 0,
    init_counters: np.ndarray | None = None,
    *,
    device: torch.device | str,
    mesh: Mesh | None = None,
):
    """Monte-Carlo statistics with repair of BP failures (the quality mode)
    on ``device``.

    The counter contract, chunking and per-chunk generators of
    :func:`run_monte_carlo`, so the error draws are the same seed for seed.
    Two repair stages, each optional: ``relay_retries > 0`` runs relay
    retries on the device; ``lam >= 0`` runs OSD on whatever still fails
    (``lam`` is the combination-sweep depth; ``lam == -1`` turns OSD off).
    ``lam == 0`` solves on ``device`` (K7 on a GPU); ``lam > 0`` solves on
    the host.  Every OSD-solved lane satisfies its syndrome, so with OSD on
    the syndrome-fail counters end at 0; convergence-fail counters keep
    their meaning.  Pair OSD with ``algorithm="min-sum"`` or
    ``"layered-min-sum"``.

    The host reads two small vectors per chunk: the failed-lane counts and
    the chunk's counters.  Chunk c + 1 is queued on the device before chunk
    c's OSD tail, and each read waits for its own chunk only, so the device
    stays busy.  ``progress(chunk, num_chunks, counters, lane_iters)`` is
    called per chunk; ``start_chunk`` / ``init_counters`` resume from
    post-repair counters at a chunk boundary.

    ``mesh`` (parallel/mesh.py; ``device`` is the rank's): as in JAX,
    every data rank draws the chunk's FULL batch, and each relay retry's
    gammas, from the generators of (seed, chunk) and decodes, classifies
    and repairs its own ``batch_size // num_data`` columns; every rank
    returns the totals, summed over ``data`` once a chunk.  For min-sum and
    layered min-sum the counters equal the ``mesh=None`` run's.  A graph
    axis > 1 decodes each data shard graph-sharded
    (``mc_graph.make_graph_sharded_osd_chunk``; circulant codes) with JAX's
    per-graph-shard relay draws; its graph ranks repair replicas of one
    bundle, and each data shard counts once.  Several processes need a mesh
    (a port mesh spans every rank), or each would count every failure.

    Returns (counters[NUM_COUNTERS] int64 numpy, total_bp_lane_iterations).
    """
    world = (torch.distributed.get_world_size()
             if torch.distributed.is_available()
             and torch.distributed.is_initialized() else 1)
    if world > 1 and mesh is None:
        raise ValueError(
            "run_monte_carlo_osd with several processes requires a mesh "
            "spanning all of them (mesh=None would decode the full batch in "
            "every process and count each failure once per process)")
    device = torch.device(device)
    with tracing.span("mc.point"):
        with tracing.span("mc.point_setup"):
            point = _Point(graphs, i_minus_p, mesh, device, init_counters,
                           progress)
            i_minus_p = point.i_minus_p
            post = None
            if lam >= 0:
                cfg = dataclasses.replace(cfg, return_soft=True)
                post = CSSPostprocessor(graphs, lam=lam).to(device)
            sharded = mesh is not None and mesh.size(GRAPH_AXIS) > 1
            chunk_fn = (make_graph_sharded_osd_chunk(
                mesh, graphs, weight, cfg, batch_size, error_model,
                relay_retries) if sharded
                else make_osd_chunk(graphs, weight, cfg, batch_size,
                                    error_model, relay_retries, mesh))
            # the graph-sharded engines decode one graph at a time
            paired = int(not sharded and paired_path(graphs, cfg, device))
            num_chunks = -(-count // batch_size)

        def dispatch(c):
            with tracing.span("mc.chunk", c):
                tracing.count("decode.paired", paired)
                return c, chunk_fn(i_minus_p, seed, c, error_probability,
                                   device=device)

        def tail(item):
            c, (counters_ok, iters, counts, bundle) = item
            with tracing.span("mc.chunk", c):
                failed = _repair_and_classify(post, i_minus_p, counts.get(),
                                              bundle)
                counters = counters_ok + failed
                if mesh is not None:
                    counters, iters = reduce_over_data(mesh, counters, iters)
                return c, _Fetch(torch.cat([counters.to(torch.int64),
                                            iters.to(torch.int64)]))

        def finish(item):
            c, fetch = item
            with tracing.span("mc.chunk", c):
                host = fetch.get()
            point.tally(host, c, num_chunks)

        # a one-deep pipeline: chunk c's tail is queued after chunk c + 1's
        # device half, and its counters are read after chunk c + 1's tail is
        # queued
        pending = queued = None
        for c in range(start_chunk, num_chunks + 1):
            out = dispatch(c) if c < num_chunks else None
            if pending is not None:
                done = tail(pending)
                if queued is not None:
                    finish(queued)
                queued = done
            pending = out
        if queued is not None:
            finish(queued)
    return point.counters, point.iters
