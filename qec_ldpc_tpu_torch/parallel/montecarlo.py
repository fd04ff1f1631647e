"""Monte-Carlo estimation of logical-error statistics (PyTorch).

The port of ``qec_ldpc_tpu/parallel/montecarlo.py::run_monte_carlo``, for
circulant and lifted codes alike.  Each chunk runs the whole pipeline on
one device:

  sample errors -> syndromes -> X/Z decode [-> relay retries] -> classify
  -> counters.

Per-chunk randomness comes from ``torch.Generator``s on the device seeded
from (seed, global chunk id): one for the errors and, with
``relay_retries > 0``, one per relay retry and graph for the damping draws
(:func:`relay_draws`), so the statistics do not depend on how chunks are
grouped.  Counters stay on the device for a whole group of
``steps_per_call`` chunks; the host reads them once per group.

With a ``mesh`` (parallel/mesh.py) every rank runs the same call.  On a
data-only mesh (:func:`make_sharded_chunk`) each rank decodes
``batch_size // num_data`` lanes of every chunk from generators seeded by
(seed, chunk, data index), the counterpart of JAX's
``fold_in(fold_in(key, c), d)``; a graph axis > 1 hands the decode to the
graph-sharded engines (parallel/mc_graph.py) on the same samples.  The
counters and lane-iterations are summed over the data axis once per group,
and every rank returns the same totals.

:func:`run_monte_carlo_osd` is the quality mode (the port of JAX's
function of that name, on one device or a data-only mesh): the same
samples, then OSD (decoder/osd.py) on the lanes BP and relay leave failed:

  sample -> syndromes -> decode with soft outputs [-> relay] -> classify
  the other lanes and move the failed ones to the front -> OSD on the
  failed lanes -> splice the corrections -> classify the failed lanes.

On a data mesh each rank draws the chunk's full batch from the one
generator of (seed, chunk) and decodes its own columns, and each relay
retry's gammas for the full batch, as JAX does, so the samples and the
counters are those of the single-device run; a graph axis > 1 hands the
decode to the graph-sharded quality chunk
(``mc_graph.make_graph_sharded_osd_chunk``).

:func:`mc_chunk` and :func:`mc_chunk_arrays` are one chunk of the counting
path: its counters, or its per-lane arrays.

Not ported (TPU-only, invisible in the results): the power-of-two rounding
of the failed-lane fetch (``_gather_failed_lanes``), which bounded the
number of compiled shapes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qec_ldpc_tpu_torch.decoder.decode import (
    SYNDROME_FAIL_X,
    SYNDROME_FAIL_Z,
    CodeGraphs,
    DecodeResult,
    decode_batch,
)
from qec_ldpc_tpu_torch.decoder.osd import CSSPostprocessor, splice
from qec_ldpc_tpu_torch.decoder.relay import RelayDraws, relay_decode_batch
from qec_ldpc_tpu_torch.decoder.sum_product import BPConfig
from qec_ldpc_tpu_torch.parallel.mesh import DATA_AXIS, GRAPH_AXIS, Mesh
from qec_ldpc_tpu_torch.sampling.classify import (
    NUM_COUNTERS,
    RankBasisTest,
    classify_batch,
    make_rank_basis_test,
)
from qec_ldpc_tpu_torch.sampling.errors import (
    sample_depolarizing_errors,
    sample_weight_w_errors,
    sample_weight_w_errors_dynamic,
    seeded_generator,
)


#: the relay stream's tag: the JAX package's fold_in constant ("RELA")
RELAY_STREAM = 0x52454C41


def chunk_generator(seed: int, chunk: int, device: torch.device | str,
                    *shard: int) -> torch.Generator:
    """The error generator of global chunk ``chunk``: a function of
    (seed, chunk) alone, and on a mesh of the rank's data index
    (``shard``)."""
    return seeded_generator([seed, chunk, *shard], device)


def relay_draws(seed: int, chunk: int, device: torch.device | str,
                *shard: int, width: int | None = None,
                offset: int = 0) -> RelayDraws:
    """The relay damping draws of global chunk ``chunk``: retry r of graph k
    draws from the generator of (seed, chunk, RELAY_STREAM, ``shard``, k,
    r), independent of the error stream and of the other graph's retries.
    ``shard``: the rank's mesh indices where each rank has a stream of its
    own; ``width``/``offset``: draw the full ``width`` lanes and keep this
    rank's columns from ``offset`` (decoder/relay.py)."""
    return RelayDraws([seed, chunk, RELAY_STREAM, *shard], device, width,
                      offset)


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


def sample_syndromes(graphs: CodeGraphs, generator: torch.Generator,
                     weight: int, error_probability: float, batch: int,
                     error_model: str, weight_cap: int | None = None,
                     lanes: slice | None = None):
    """Sample errors -> syndromes.  Returns (xe, ze, sx, sz), errors as
    int32.  ``weight_cap``: draw weight-model errors with the dynamic
    sampler (``weight_cap`` candidates, the first ``weight`` active).
    ``lanes``: keep only these lanes of the ``batch`` drawn (a data shard's
    columns of the full-batch draw)."""
    n = graphs.code.n
    if error_model == "weight":
        if weight_cap is not None:
            xe, ze = sample_weight_w_errors_dynamic(generator, n, weight,
                                                    weight_cap, batch)
        else:
            xe, ze = sample_weight_w_errors(generator, n, weight, batch)
    elif error_model == "depolarizing":
        xe, ze = sample_depolarizing_errors(generator, n, error_probability,
                                            batch)
    else:
        raise ValueError(f"unknown error model {error_model!r}")
    if lanes is not None:
        xe, ze = xe[:, lanes], ze[:, lanes]
    xe_i = xe.to(torch.int32).contiguous()
    ze_i = ze.to(torch.int32).contiguous()
    return xe_i, ze_i, graphs.x.syndrome(xe_i), graphs.z.syndrome(ze_i)


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


def _chunk_body(graphs: CodeGraphs, i_minus_p, generator: torch.Generator,
                weight: int, error_probability: float, cfg: BPConfig,
                batch: int, error_model: str, relay_retries: int = 0,
                draws: RelayDraws | None = None,
                weight_cap: int | None = None):
    """Sample + decode + classify one batch.  Returns device tensors
    (counters[NUM_COUNTERS] int32, iters[2]) with iters the executed BP
    lane-iterations for [X, Z], relay retries included."""
    xe_i, ze_i, _, _, res = _sample_and_decode(
        graphs, generator, weight, error_probability, cfg, batch, error_model,
        relay_retries, draws, weight_cap)
    counters = classify_batch(i_minus_p, xe_i, ze_i,
                              res.decisions_x.to(torch.int32),
                              res.decisions_z.to(torch.int32),
                              res.error_code)
    iters = torch.stack([res.iter_samples_x, res.iter_samples_z])
    return counters, iters


def _effective_spc(num_chunks: int, steps_per_call: int) -> int:
    """The group size actually used for ``num_chunks`` chunks: the largest
    divisor of num_chunks <= steps_per_call, unless that is below
    steps_per_call // 8 (the JAX driver's rule, kept so journals and group
    boundaries agree between the two packages)."""
    if num_chunks % steps_per_call:
        div = next((d for d in range(min(steps_per_call, num_chunks), 0, -1)
                    if num_chunks % d == 0), 1)
        if div >= max(1, steps_per_call // 8):
            steps_per_call = div
    return steps_per_call


def _chunk_samples(batch_size: int, mesh: Mesh | None) -> int:
    """Samples per chunk: on a mesh, ``batch_size // num_data`` lanes on
    each data shard."""
    if mesh is None:
        return batch_size
    num_data = mesh.size(DATA_AXIS)
    return max(1, batch_size // num_data) * num_data


def effective_steps_per_call(count: int, batch_size: int,
                             steps_per_call: int, mesh: Mesh | None = None) -> int:
    """The steps_per_call :func:`run_monte_carlo` will actually use."""
    return _effective_spc(-(-count // _chunk_samples(batch_size, mesh)),
                          steps_per_call)


def _chunk_group(graphs: CodeGraphs, i_minus_p, chunk_ids, seed: int,
                 shard: tuple[int, ...], weight: int, error_probability: float,
                 cfg: BPConfig, batch: int, error_model: str,
                 relay_retries: int, device: torch.device,
                 weight_cap: int | None = None):
    """The chunks ``chunk_ids`` of one rank (mesh indices ``shard``, empty
    without a mesh), summed on the device: (counters int64, iters[2]
    int64)."""
    counters = torch.zeros(NUM_COUNTERS, dtype=torch.int64, device=device)
    iters = torch.zeros(2, dtype=torch.int64, device=device)
    for c in chunk_ids:
        cnt, its = _chunk_body(graphs, i_minus_p,
                               chunk_generator(seed, c, device, *shard),
                               weight, error_probability, cfg, batch,
                               error_model, relay_retries,
                               relay_draws(seed, c, device, *shard)
                               if relay_retries > 0 else None, weight_cap)
        counters += cnt
        iters += its
    return counters, iters


def reduce_over_data(mesh: Mesh, counters: torch.Tensor, iters: torch.Tensor):
    """Sum a group's (counters, iters) over the data axis: one all_reduce."""
    total = mesh.all_reduce(torch.cat([counters.to(torch.int64),
                                       iters.to(torch.int64)]),
                            "sum", DATA_AXIS)
    return total[:NUM_COUNTERS], total[NUM_COUNTERS:]


def gather_lanes(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """A (..., lanes) tensor of every data shard joined along its last axis
    in data order: the full batch's columns.  One all_gather."""
    g = torch.movedim(mesh.all_gather(x, DATA_AXIS), 0, -2)
    return g.reshape(*x.shape[:-1], -1)


def data_shard(mesh: Mesh | None, batch: int) -> tuple[slice | None, int]:
    """(this rank's columns of a ``batch``-lane chunk, their first lane):
    (None, 0) without a mesh."""
    if mesh is None:
        return None, 0
    num_data = mesh.size(DATA_AXIS)
    if batch % num_data:
        raise ValueError(f"batch_size={batch} must be divisible by the "
                         f"data-axis size {num_data}")
    bpd = batch // num_data
    lo = mesh.rank(DATA_AXIS) * bpd
    return slice(lo, lo + bpd), lo


def mc_chunk(graphs: CodeGraphs, i_minus_p, seed: int, chunk: int,
             weight: int, error_probability: float, cfg: BPConfig,
             batch: int, error_model: str = "weight", relay_retries: int = 0,
             *, device: torch.device | str, weight_cap: int | None = None):
    """One chunk of :func:`run_monte_carlo` on ``device``: the ``batch``
    samples of global chunk ``chunk`` from the generators of (seed, chunk),
    decoded (relay-repaired when ``relay_retries > 0``) and classified.
    ``i_minus_p`` and ``weight_cap`` as in :func:`run_monte_carlo`.
    Returns device tensors (counters[NUM_COUNTERS] int32, iters[2]), iters
    the executed lane-iterations for [X, Z]."""
    device = torch.device(device)
    return _chunk_body(graphs, _resolve_logical_test(graphs, i_minus_p, device),
                       chunk_generator(seed, chunk, device), weight,
                       error_probability, cfg, batch, error_model,
                       relay_retries, relay_draws(seed, chunk, device)
                       if relay_retries > 0 else None, weight_cap)


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
    returns the full arrays, gathered over ``data``: they equal the
    ``mesh=None`` call's.  Iteration totals are the data shards' sum and
    maximum, which depend on the partition on the plain path (each shard's
    loop exits on its own lanes)."""
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
    if mesh is not None:
        def gather(a):
            return None if a is None else gather_lanes(mesh, a)

        xe, ze, sx, sz = (gather(a) for a in (xe, ze, sx, sz))
        its = mesh.all_gather(torch.stack([
            res.iters_x, res.iters_z, res.iter_samples_x,
            res.iter_samples_z]).to(torch.int64), DATA_AXIS)
        res = DecodeResult(
            decisions_x=gather(res.decisions_x),
            decisions_z=gather(res.decisions_z),
            error_code=gather(res.error_code),
            iters_x=its[:, 0].max(), iters_z=its[:, 1].max(),
            iter_samples_x=its[:, 2].sum(), iter_samples_z=its[:, 3].sum(),
            soft_x=gather(res.soft_x), soft_z=gather(res.soft_z))
    return (*(a.to(torch.int8) for a in (xe, ze, sx, sz)), res)


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
        return reduce_over_data(mesh, *_chunk_group(
            graphs, i_minus_p, chunk_ids, seed, (didx,), weight,
            error_probability, cfg, batch_per_device, error_model,
            relay_retries, torch.device(device), weight_cap))

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

    Returns (counters[NUM_COUNTERS] int64 numpy, total_bp_lane_iterations).
    """
    device = torch.device(device)
    i_minus_p = _resolve_logical_test(graphs, i_minus_p, device)
    if mesh is None:
        def run_group(ids):
            return _chunk_group(graphs, i_minus_p, ids, seed, (), weight,
                                error_probability, cfg, batch_size,
                                error_model, relay_retries, device,
                                weight_cap)
    else:
        if not isinstance(mesh, Mesh):
            raise ValueError(f"mesh must be a parallel.mesh.Mesh, got "
                             f"{type(mesh).__name__}")
        per_dev = _chunk_samples(batch_size, mesh) // mesh.size(DATA_AXIS)
        if mesh.size(GRAPH_AXIS) > 1:
            from qec_ldpc_tpu_torch.parallel.mc_graph import (
                make_graph_sharded_chunk,
            )

            chunk_fn = make_graph_sharded_chunk(mesh, graphs, weight, cfg,
                                                per_dev, error_model,
                                                relay_retries)
        else:
            chunk_fn = make_sharded_chunk(mesh, graphs, weight, cfg, per_dev,
                                          error_model, relay_retries,
                                          weight_cap)

        def run_group(ids):
            return chunk_fn(i_minus_p, seed, error_probability, ids,
                            device=device)
    totals = np.zeros(NUM_COUNTERS, dtype=np.int64)
    if init_counters is not None:
        totals += np.asarray(init_counters, dtype=np.int64)
    total_iters = 0
    num_chunks = -(-count // _chunk_samples(batch_size, mesh))
    steps_per_call = _effective_spc(num_chunks, steps_per_call)
    groups = [range(g, min(g + steps_per_call, num_chunks))
              for g in range(0, num_chunks, steps_per_call)]
    for gi in range(start_chunk, len(groups)):
        counters, iters = run_group(groups[gi])
        host = torch.cat([counters, iters]).cpu().numpy()  # one fetch
        group_counters = host[:NUM_COUNTERS]
        group_iters = int(host[NUM_COUNTERS:].sum())
        totals += group_counters
        total_iters += group_iters
        if progress is not None:
            progress(gi, len(groups), group_counters, group_iters)
    return totals, total_iters


#: error-code bits that route a lane through OSD
_SYN_BITS = SYNDROME_FAIL_X | SYNDROME_FAIL_Z


class _Fetch:
    """A small device tensor on its way to the host: the copy is queued at
    construction, and :meth:`get` waits for that copy alone, not for work
    queued after it (a CUDA event, not a stream synchronisation)."""

    def __init__(self, tensor: torch.Tensor):
        self._host = tensor.to("cpu", non_blocking=True)
        self._ready = None
        if tensor.is_cuda:
            self._ready = torch.cuda.Event()
            self._ready.record()

    def get(self) -> np.ndarray:
        if self._ready is not None:
            self._ready.synchronize()
        return self._host.numpy()


def _classify_and_compact(i_minus_p, xe, ze, sx, sz, res):
    """Classify every lane without a syndrome-fail bit on the device, and
    permute the per-lane arrays so the failed lanes come first, in their
    order.  Returns ``(counters_ok, counts, bundle)``: ``counts`` (3,) int64
    holds the failed lanes, the X-failed and the Z-failed; ``bundle`` is
    (xe, ze, sx, sz, dx, dz, soft_x, soft_z, error_code) compacted (the
    soft outputs None when the decode made none)."""
    ec = res.error_code
    fail = (ec & _SYN_BITS) != 0
    counters = classify_batch(i_minus_p, xe, ze,
                              res.decisions_x.to(torch.int32),
                              res.decisions_z.to(torch.int32), ec, valid=~fail)
    order = torch.argsort((~fail).to(torch.int32), stable=True)
    bundle = tuple(None if a is None else a.index_select(a.dim() - 1, order)
                   for a in (xe, ze, sx, sz, res.decisions_x, res.decisions_z,
                             res.soft_x, res.soft_z, ec))
    counts = torch.stack([fail.sum(), ((ec & SYNDROME_FAIL_X) != 0).sum(),
                          ((ec & SYNDROME_FAIL_Z) != 0).sum()])
    return counters, counts, bundle


def make_osd_chunk(graphs: CodeGraphs, weight: int, cfg: BPConfig,
                   batch: int, error_model: str = "weight",
                   relay_retries: int = 0, mesh: Mesh | None = None):
    """The device half of the quality mode's chunk on one device or a data
    mesh: ``chunk_fn(i_minus_p, seed, chunk, error_probability, *,
    device)`` samples global chunk ``chunk``'s full ``batch`` from the
    generator of (seed, chunk), decodes (with soft outputs when ``cfg``
    asks) this rank's columns (all of them without a mesh, the data
    shard's on one), each relay retry drawing its gammas for the full
    batch, classifies the non-failed lanes and compacts.  It returns
    ``(counters_ok, iters[2], counts fetch, bundle)`` for the rank's
    columns, the failed-lane counts already on their way to the host (the
    contract of ``mc_graph.make_graph_sharded_osd_chunk``)."""
    if mesh is not None and mesh.size(GRAPH_AXIS) > 1:
        raise ValueError("graph-sharded quality chunks live in "
                         "mc_graph.make_graph_sharded_osd_chunk")
    lanes, lo = data_shard(mesh, batch)

    def chunk_fn(i_minus_p, seed, chunk, error_probability, *, device):
        xe, ze, sx, sz, res = _sample_and_decode(
            graphs, chunk_generator(seed, chunk, device), weight,
            error_probability, cfg, batch, error_model, relay_retries,
            relay_draws(seed, chunk, device, width=batch, offset=lo)
            if relay_retries > 0 else None, lanes=lanes)
        counters, counts, bundle = _classify_and_compact(i_minus_p, xe, ze,
                                                         sx, sz, res)
        iters = torch.stack([res.iter_samples_x, res.iter_samples_z])
        return counters, iters, _Fetch(counts), bundle

    return chunk_fn


def _repair_and_classify(post: CSSPostprocessor | None, i_minus_p,
                         counts: np.ndarray, bundle) -> torch.Tensor:
    """The tail of a quality-mode chunk: OSD-repair the failed lanes (the
    first ``counts[0]`` of the compacted bundle; none when ``post`` is None)
    and classify them.  The solves run where ``post``'s decoders route them
    (OSD-0 on the device, ``lam > 0`` on the host); splicing and
    classification stay on the bundle's device, where the X- and Z-failed
    lanes are found from their known counts, with no host read.  Returns
    the failed lanes' int32 counters on that device."""
    k, k_x, k_z = (int(v) for v in counts)
    if k == 0:
        return torch.zeros(NUM_COUNTERS, dtype=torch.int32,
                           device=bundle[-1].device)
    xe, ze, sx, sz, dx, dz, soft_x, soft_z, ec = (
        None if a is None else a[..., :k] for a in bundle)
    dec = {SYNDROME_FAIL_X: dx, SYNDROME_FAIL_Z: dz}
    if post is not None:
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
    every data rank draws the chunk's FULL batch from the one generator of
    (seed, chunk) and decodes, classifies and repairs its own
    ``batch_size // num_data`` columns; the chunk's counters and
    lane-iterations are summed over the data axis (one all_reduce per
    chunk) and every rank returns the totals.  Each relay retry draws its
    gammas for the full batch and keeps the rank's columns.  Lanes decode
    independently, so for min-sum and layered min-sum, relay or not, the
    counters equal the ``mesh=None`` run's.  A graph axis > 1 decodes
    each data shard graph-sharded (``mc_graph.make_graph_sharded_osd_chunk``;
    circulant codes), with JAX's per-graph-shard relay draws, so there only
    the relay-free counters equal ``mesh=None``'s.  Every graph rank of a
    data shard then holds the same compacted bundle; each repairs the same
    failed lanes and classifies them, and the counters are summed over the
    data axis alone, so each data shard's lanes count once.  Several
    processes need a mesh (a port mesh spans every rank), or each would
    count every failure.

    Returns (counters[NUM_COUNTERS] int64 numpy, total_bp_lane_iterations).
    """
    world = (torch.distributed.get_world_size()
             if torch.distributed.is_available()
             and torch.distributed.is_initialized() else 1)
    if mesh is not None and not isinstance(mesh, Mesh):
        raise ValueError(f"mesh must be a parallel.mesh.Mesh, got "
                         f"{type(mesh).__name__}")
    if world > 1 and mesh is None:
        # the counters are summed over the mesh's data axis (a port mesh
        # spans every rank): without one each process would decode the full
        # batch and count each failure once per process
        raise ValueError(
            "run_monte_carlo_osd with several processes requires a mesh "
            "spanning all of them (mesh=None would decode the full batch in "
            "every process and count each failure once per process)")
    device = torch.device(device)
    post = None
    if lam >= 0:
        cfg = dataclasses.replace(cfg, return_soft=True)
        post = CSSPostprocessor(graphs, lam=lam).to(device)
    if mesh is not None and mesh.size(GRAPH_AXIS) > 1:
        from qec_ldpc_tpu_torch.parallel.mc_graph import (
            make_graph_sharded_osd_chunk,
        )

        chunk_fn = make_graph_sharded_osd_chunk(mesh, graphs, weight, cfg,
                                                batch_size, error_model,
                                                relay_retries)
    else:
        chunk_fn = make_osd_chunk(graphs, weight, cfg, batch_size,
                                  error_model, relay_retries, mesh)
    i_minus_p = _resolve_logical_test(graphs, i_minus_p, device)
    totals = np.zeros(NUM_COUNTERS, dtype=np.int64)
    if init_counters is not None:
        totals += np.asarray(init_counters, dtype=np.int64)
    total_iters = 0
    num_chunks = -(-count // batch_size)

    def dispatch(c):
        return c, chunk_fn(i_minus_p, seed, c, error_probability,
                           device=device)

    def tail(item):
        c, (counters_ok, iters, counts, bundle) = item
        counters = counters_ok + _repair_and_classify(post, i_minus_p,
                                                      counts.get(), bundle)
        if mesh is not None:
            counters, iters = reduce_over_data(mesh, counters, iters)
        return c, _Fetch(torch.cat([counters.to(torch.int64),
                                    iters.to(torch.int64)]))

    def finish(item):
        nonlocal totals, total_iters
        c, fetch = item
        host = fetch.get()
        counters = host[:NUM_COUNTERS]
        chunk_iters = int(host[NUM_COUNTERS:].sum())
        totals += counters
        total_iters += chunk_iters
        if progress is not None:
            progress(c, num_chunks, counters, chunk_iters)

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
    return totals, total_iters
