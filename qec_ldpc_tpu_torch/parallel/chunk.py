"""The per-chunk primitives beneath both Monte-Carlo drivers (PyTorch),
parallel/montecarlo.py and parallel/mc_graph.py: the chunk's generators of
(seed, chunk[, data index]) and relay's draws, so the statistics do not
depend on how chunks are grouped or sharded; sampling; the data axis's
collectives; the quality mode's compaction; the counting path's group
loop (:func:`chunk_group`).  It imports neither driver."""

from __future__ import annotations

import numpy as np
import torch

from qec_ldpc_tpu_torch import tracing
from qec_ldpc_tpu_torch.decoder.decode import (
    SYNDROME_FAIL_X,
    SYNDROME_FAIL_Z,
    CodeGraphs,
    DecodeResult,
)
from qec_ldpc_tpu_torch.decoder.relay import RelayDraws
from qec_ldpc_tpu_torch.parallel.mesh import DATA_AXIS, Mesh
from qec_ldpc_tpu_torch.sampling.classify import NUM_COUNTERS, classify_batch
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
    with tracing.span("mc.sample"):
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
    with tracing.span("mc.sample"):
        if error_model == "weight":
            if weight_cap is not None:
                xe, ze = sample_weight_w_errors_dynamic(generator, n, weight,
                                                        weight_cap, batch)
            else:
                xe, ze = sample_weight_w_errors(generator, n, weight, batch)
        elif error_model == "depolarizing":
            xe, ze = sample_depolarizing_errors(generator, n,
                                                error_probability, batch)
        else:
            raise ValueError(f"unknown error model {error_model!r}")
        if lanes is not None:
            xe, ze = xe[:, lanes], ze[:, lanes]
        xe_i = xe.to(torch.int32).contiguous()
        ze_i = ze.to(torch.int32).contiguous()
        return xe_i, ze_i, graphs.x.syndrome(xe_i), graphs.z.syndrome(ze_i)


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


def gather_lanes(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """A (..., lanes) tensor of every data shard joined along its last axis
    in data order: the full batch's columns.  One all_gather."""
    g = torch.movedim(mesh.all_gather(x, DATA_AXIS), 0, -2)
    return g.reshape(*x.shape[:-1], -1)


def gather_arrays(mesh: Mesh | None, xe, ze, sx, sz, res: DecodeResult):
    """A chunk's per-lane arrays, a data shard's on a mesh, gathered over
    ``data`` (as they are without a mesh): ``(xe, ze, sx, sz)`` int8 and the
    full batch's DecodeResult, its loop counts the shards' maximum and its
    lane-iterations their sum."""
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


def reduce_over_data(mesh: Mesh, counters: torch.Tensor, iters: torch.Tensor):
    """Sum a group's (counters, iters) over the data axis: one all_reduce."""
    total = mesh.all_reduce(torch.cat([counters.to(torch.int64),
                                       iters.to(torch.int64)]),
                            "sum", DATA_AXIS)
    return total[:NUM_COUNTERS], total[NUM_COUNTERS:]


def accumulators(device: torch.device | str):
    """A group's int64 accumulators on ``device``, counters[NUM_COUNTERS]
    and lane-iterations [X, Z], left for :func:`chunk_group` to zero."""
    return (torch.empty(NUM_COUNTERS, dtype=torch.int64, device=device),
            torch.empty(2, dtype=torch.int64, device=device))


def chunk_group(run, chunk_ids, into, fused: bool | None = None,
                paired: bool | None = None):
    """The chunks ``chunk_ids`` of one group summed into ``into``
    (:func:`accumulators`, zeroed first): ``run(c, into)`` adds chunk ``c``,
    under the span ``mc.chunk``.  The point's decisions count 1 or 0 a
    chunk (None: nothing): ``fused``, whether a chunk decides and
    classifies in one kernel, in ``classify.fused``; ``paired``, whether
    its two graphs decode in one launch (``decode.paired_path``), in
    ``decode.paired``.  Returns ``into``."""
    for acc in into:
        acc.zero_()
    counts = [(name, int(flag)) for name, flag in
              (("classify.fused", fused), ("decode.paired", paired))
              if flag is not None]
    for c in chunk_ids:
        with tracing.span("mc.chunk", c):
            run(c, into)
            for name, n in counts:
                tracing.count(name, n)
    return into


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
        with tracing.span("mc.fetch"):
            if self._ready is not None:
                self._ready.synchronize()
            return self._host.numpy()


#: error-code bits that route a lane through OSD
_SYN_BITS = SYNDROME_FAIL_X | SYNDROME_FAIL_Z


def _classify_and_compact(i_minus_p, xe, ze, sx, sz, res):
    """Classify every lane without a syndrome-fail bit on the device, and
    permute the per-lane arrays so the failed lanes come first, in their
    order.  Returns ``(counters_ok, counts, bundle)``: ``counts`` (3,) int64
    holds the failed lanes, the X-failed and the Z-failed; ``bundle`` is
    (xe, ze, sx, sz, dx, dz, soft_x, soft_z, error_code) compacted (the
    soft outputs None when the decode made none)."""
    with tracing.span("mc.classify"):
        ec = res.error_code
        fail = (ec & _SYN_BITS) != 0
        counters = classify_batch(i_minus_p, xe, ze,
                                  res.decisions_x.to(torch.int32),
                                  res.decisions_z.to(torch.int32), ec,
                                  valid=~fail)
        order = torch.argsort((~fail).to(torch.int32), stable=True)
        bundle = tuple(None if a is None
                       else a.index_select(a.dim() - 1, order)
                       for a in (xe, ze, sx, sz, res.decisions_x,
                                 res.decisions_z, res.soft_x, res.soft_z, ec))
        counts = torch.stack([fail.sum(), ((ec & SYNDROME_FAIL_X) != 0).sum(),
                              ((ec & SYNDROME_FAIL_Z) != 0).sum()])
        return counters, counts, bundle


def compact_chunk(i_minus_p, xe, ze, sx, sz, res):
    """The end of a quality-mode chunk's device half:
    ``(counters_ok, iters[2], counts fetch, bundle)`` of
    :func:`_classify_and_compact`, the failed-lane counts already on their
    way to the host."""
    counters, counts, bundle = _classify_and_compact(i_minus_p, xe, ze, sx,
                                                     sz, res)
    return (counters, torch.stack([res.iter_samples_x, res.iter_samples_z]),
            _Fetch(counts), bundle)
