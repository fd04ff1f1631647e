"""Graph-parallel Monte-Carlo statistics: the (data x graph) mesh chunks
(PyTorch).

The port of ``qec_ldpc_tpu/parallel/mc_graph.py``.  Per chunk of
:func:`make_graph_sharded_chunk`, on every rank:

  sample (data-local, the same on every rank of a graph group) -> full
  syndromes -> graph-sharded X/Z decode (the halo collectives ride the
  ``graph`` axis) [-> graph-sharded relay retries] -> all_gather of the
  decisions over ``graph`` -> classify -> counters.

The group's chunks run in the group loop of parallel/chunk.py
(``chunk_group``), and its counters are summed over ``data`` once.  Samples
come from the generators of (seed, chunk, data index), as in the
data-parallel chunk (``montecarlo.make_sharded_chunk``), so for the exact
decoders (min-sum, layered min-sum) the counters equal a data-only mesh's
of the same ``num_data`` bit for bit; sum-product reassociates the
cross-shard products and agrees statistically.  Circulant codes run the block-column engines of
``parallel/graph_sharded.py``; lifted codes (bivariate bicycle, hypergraph
product, toric) the lane-sharded engine of ``parallel/lifted_sharded.py``,
each rank decoding its band of the full syndromes, exact for min-sum and
sum-product alike.

The quality mode's chunks (:func:`make_graph_sharded_osd_chunk`, and
:func:`make_graph_sharded_arrays_chunk`, which returns the per-lane arrays;
circulant codes only: the lane-sharded engine has no soft outputs, as in
JAX) draw the chunk's full batch from the generator of (seed, chunk), as
the single-device quality mode does: every data rank slices its columns,
decodes them graph-sharded with soft outputs, and gathers the decisions and
soft outputs over ``graph`` into global variable order, the single-device
decode's bit for bit for min-sum and layered min-sum.  Relay keeps JAX's
per-graph-shard draw (a generator of (seed, chunk, graph index) a rank),
so relay counters are deterministic, not those of ``mesh=None``.
"""

from __future__ import annotations

import numpy as np
import torch

from qec_ldpc_tpu_torch.decoder.decode import (
    CodeGraphs,
    DecodeResult,
    error_code,
)
from qec_ldpc_tpu_torch.decoder.layout import CirculantGraph
from qec_ldpc_tpu_torch.decoder.lifted import LiftedGraph
from qec_ldpc_tpu_torch.decoder.min_sum import prior_llr
from qec_ldpc_tpu_torch.decoder.sum_product import BPConfig
from qec_ldpc_tpu_torch.parallel import lifted_sharded
from qec_ldpc_tpu_torch.parallel.graph_sharded import (
    _decode_one_graph_sharded,
    _relay_one_graph_sharded,
    routers,
)
from qec_ldpc_tpu_torch.parallel.chunk import (
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
from qec_ldpc_tpu_torch.parallel.mesh import DATA_AXIS, GRAPH_AXIS, Mesh
from qec_ldpc_tpu_torch.sampling.classify import classify_batch


def _reject_unsupported_pallas(graphs: CodeGraphs, cfg: BPConfig) -> None:
    """``cfg.kernel='pallas'`` on the graph axis names the fused
    between-halos step (K8), which serves circulant min-sum alone."""
    if cfg.kernel == "pallas" and (cfg.algorithm != "min-sum"
                                   or not isinstance(graphs.x, CirculantGraph)):
        raise ValueError(
            "cfg.kernel='pallas' with num_graph > 1 is only supported for "
            "algorithm='min-sum' on circulant QC codes (the fused "
            "between-halos kernel); use kernel='xla' for this combination")


def _decode_chunk(mesh: Mesh, routers_xz, cfg: BPConfig, sx: torch.Tensor,
                  sz: torch.Tensor, error_probability: float, draws,
                  relay_retries: int, want_soft: bool = False):
    """Graph-sharded X and Z decode of a data shard's full syndromes
    [-> relay retries drawing from ``draws``]: ``(dx, dz, soft_x, soft_z,
    error_code, (X, Z) loop iterations, (X, Z) reported lane-iterations)``,
    the last 0-dim int64 tensors (``graph_sharded.lane_iterations``), the
    decisions and soft outputs gathered over ``graph`` in global variable
    order (soft None unless ``want_soft``)."""
    prior = np.float32(cfg.prior_factor) * np.float32(error_probability)
    out = []
    for k, router, syn in ((0, routers_xz[0], sx), (1, routers_xz[1], sz)):
        d, cf, sf, it, lanes, soft = _decode_one_graph_sharded(
            mesh, router, syn, prior, cfg, want_soft)
        if draws is not None:
            gammas = draws.gammas(k, router.Lc * router.P, syn.shape[-1])
            d, solved, extra, extra_lanes = _relay_one_graph_sharded(
                mesh, router, syn, prior_llr(prior), cfg, gammas, d, ~sf,
                relay_retries)
            sf, it, lanes = ~solved, it + extra, lanes + extra_lanes
        # rank g owns block columns [g*Lc, (g+1)*Lc): the gathered shards
        # are the global variable order
        d, soft = (None if a is None else
                   mesh.all_gather(a, GRAPH_AXIS).reshape(-1, syn.shape[-1])
                   for a in (d, soft))
        out.append((d, soft, cf, sf, it, lanes.sum(dtype=torch.int64)))
    (dx, softx, cfx, sfx, itx, lx), (dz, softz, cfz, sfz, itz, lz) = out
    return (dx, dz, softx, softz, error_code(sfx, sfz, cfx, cfz), (itx, itz),
            (lx, lz))


def make_graph_sharded_chunk(mesh: Mesh, graphs: CodeGraphs, weight: int,
                             cfg: BPConfig, batch_per_device: int,
                             error_model: str = "weight",
                             relay_retries: int = 0):
    """This rank's (data x graph)-sharded chunk group, with the contract of
    ``montecarlo.make_sharded_chunk``: ``chunk_fn(i_minus_p, seed,
    error_probability, chunk_ids, *, device)`` returns the group's
    (counters, iters[2]) summed over the data axis, ``iters`` the executed
    X and Z lane-iterations (``graph_sharded.lane_iterations``: on a card
    each lane's own count, as a data-only mesh's kernels count).
    ``batch_per_device`` counts samples per data shard (every graph shard
    works on the same samples).  ``relay_retries > 0`` repairs failed lanes
    with graph-sharded damped retries, each rank drawing the damping of its
    own variables (a lifted code: its band) from ``relay_draws(seed, chunk,
    device, data index, graph index)``.  Circulant codes need G | L; lifted
    codes one check block per graph and G | l (``lifted_sharded.adapters``)."""
    _reject_unsupported_pallas(graphs, cfg)
    if mesh.size(GRAPH_AXIS) <= 1:
        raise ValueError("graph axis has size 1; use make_sharded_chunk")
    if isinstance(graphs.x, CirculantGraph):
        routers_xz = routers(mesh, graphs)

        def decode(sx, sz, error_probability, draws):
            dx, dz, _, _, code, _, lanes = _decode_chunk(
                mesh, routers_xz, cfg, sx, sz, error_probability, draws,
                relay_retries)
            return dx, dz, code, lanes
    elif isinstance(graphs.x, LiftedGraph):
        adapters_xz = lifted_sharded.adapters(mesh, graphs, cfg)

        def decode(sx, sz, error_probability, draws):
            dx, dz, code, _, lanes = lifted_sharded.decode_full(
                adapters_xz, cfg, sx, sz, error_probability, draws,
                relay_retries)
            return dx, dz, code, lanes
    else:
        raise ValueError(f"unsupported graph type {type(graphs.x)!r}")
    didx, gidx = mesh.rank(DATA_AXIS), mesh.rank(GRAPH_AXIS)

    def chunk_fn(i_minus_p, seed, error_probability, chunk_ids, *, device):
        device = torch.device(device)

        def run(c, into):
            xe, ze, sx, sz = sample_syndromes(
                graphs, chunk_generator(seed, c, device, didx), weight,
                error_probability, batch_per_device, error_model)
            draws = (relay_draws(seed, c, device, didx, gidx)
                     if relay_retries > 0 else None)
            dx, dz, code, lanes = decode(sx, sz, error_probability, draws)
            into[0].add_(classify_batch(i_minus_p, xe, ze, dx.to(torch.int32),
                                        dz.to(torch.int32), code))
            into[1].add_(torch.stack(lanes))

        return reduce_over_data(mesh, *chunk_group(
            run, chunk_ids, accumulators(device)))

    return chunk_fn


def _check_graph_osd_mesh(mesh: Mesh, graphs: CodeGraphs, cfg: BPConfig,
                          batch: int):
    """The validation of the graph-sharded soft-output chunks: returns this
    rank's (columns of the chunk, X and Z shard routers)."""
    _reject_unsupported_pallas(graphs, cfg)
    if not isinstance(graphs.x, CirculantGraph):
        raise ValueError(
            "graph-sharded OSD arrays need circulant QC codes (the lifted "
            "lane-sharded engine has no soft outputs); use num_graph=1")
    if mesh.size(GRAPH_AXIS) <= 1:
        raise ValueError("graph axis has size 1; use "
                         "montecarlo.make_osd_chunk")
    lanes, _ = data_shard(mesh, batch)
    return lanes, routers(mesh, graphs)


def _soft_decode_shard(mesh: Mesh, graphs: CodeGraphs, lanes: slice,
                       routers_xz, cfg: BPConfig, weight: int,
                       error_model: str, relay_retries: int, batch: int,
                       seed: int, chunk: int, error_probability: float,
                       device: torch.device):
    """One rank's half of a soft-output quality chunk: draw global chunk
    ``chunk``'s full ``batch`` from the generator of (seed, chunk), keep the
    data shard's ``lanes``, decode them graph-sharded with soft outputs
    [-> graph-sharded relay, each rank's gammas from
    ``relay_draws(seed, chunk, device, graph index)``].  Returns the shard's
    ``(xe, ze, sx, sz, DecodeResult)``, decisions and soft outputs in
    global variable order and ``iter_samples_*`` the shard's executed
    lane-iterations (``graph_sharded.lane_iterations``)."""
    xe, ze, sx, sz = sample_syndromes(
        graphs, chunk_generator(seed, chunk, device), weight,
        error_probability, batch, error_model, lanes=lanes)
    draws = (relay_draws(seed, chunk, device, mesh.rank(GRAPH_AXIS))
             if relay_retries > 0 else None)
    dx, dz, softx, softz, code, (itx, itz), (isx, isz) = _decode_chunk(
        mesh, routers_xz, cfg, sx, sz, error_probability, draws,
        relay_retries, want_soft=True)
    # filled on the device: a tensor built from host values would block
    ix, iz = (torch.full((), v, dtype=torch.int64, device=device)
              for v in (itx, itz))
    res = DecodeResult(decisions_x=dx, decisions_z=dz, error_code=code,
                       iters_x=ix, iters_z=iz, iter_samples_x=isx,
                       iter_samples_z=isz, soft_x=softx, soft_z=softz)
    return xe, ze, sx, sz, res


def make_graph_sharded_arrays_chunk(mesh: Mesh, graphs: CodeGraphs,
                                    weight: int, cfg: BPConfig, batch: int,
                                    error_model: str = "weight",
                                    relay_retries: int = 0):
    """One Monte-Carlo chunk over a (data x graph) mesh returning the full
    per-lane arrays, the graph-sharded sibling of
    ``montecarlo.mc_chunk_arrays(mesh=)`` (debugging and analysis; the
    quality mode runs :func:`make_graph_sharded_osd_chunk`).

    ``chunk_fn(seed, chunk, error_probability, *, device)`` samples the
    ``batch`` lanes of ``mc_chunk_arrays(seed, chunk, ...)``, decodes each
    data shard's columns graph-sharded with soft outputs, and returns on
    every rank ``(xe, ze, sx, sz)`` int8 and the DecodeResult of the whole
    batch, gathered over ``data``.  Min-sum's and layered min-sum's
    decisions and soft outputs equal the single-device decode's bit for
    bit.  Circulant codes only (the lifted engine has no soft outputs).
    ``iters_*`` are the data shards' largest loop count, ``iter_samples_*``
    the sum of their reported lane-iterations
    (``graph_sharded.lane_iterations``; on the CPU loop count x lanes,
    which depends on the partition)."""
    lanes, routers_xz = _check_graph_osd_mesh(mesh, graphs, cfg, batch)

    def chunk_fn(seed, chunk, error_probability, *, device):
        return gather_arrays(mesh, *_soft_decode_shard(
            mesh, graphs, lanes, routers_xz, cfg, weight, error_model,
            relay_retries, batch, seed, chunk, error_probability,
            torch.device(device)))

    return chunk_fn


def make_graph_sharded_osd_chunk(mesh: Mesh, graphs: CodeGraphs,
                                 weight: int, cfg: BPConfig, batch: int,
                                 error_model: str = "weight",
                                 relay_retries: int = 0):
    """The device half of the quality mode's chunk over a (data x graph)
    mesh, with the contract of ``montecarlo.make_osd_chunk``:
    ``chunk_fn(i_minus_p, seed, chunk, error_probability, *, device)``
    returns ``(counters_ok, iters[2], counts fetch, bundle)`` for the rank's
    data shard, its failed lanes compacted first.

    Every graph rank of a data shard returns the same values: the
    decisions and soft outputs are gathered over ``graph`` and the flags
    reduced over it, so the compacted bundles are replicas.
    ``run_monte_carlo_osd`` repairs them on every graph rank and sums the
    counters over ``data`` alone, so each data shard counts once."""
    lanes, routers_xz = _check_graph_osd_mesh(mesh, graphs, cfg, batch)

    def chunk_fn(i_minus_p, seed, chunk, error_probability, *, device):
        return compact_chunk(i_minus_p, *_soft_decode_shard(
            mesh, graphs, lanes, routers_xz, cfg, weight, error_model,
            relay_retries, batch, seed, chunk, error_probability,
            torch.device(device)))

    return chunk_fn
