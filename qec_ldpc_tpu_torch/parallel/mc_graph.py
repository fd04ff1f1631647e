"""Graph-parallel Monte-Carlo statistics: the (data x graph) mesh chunk
(PyTorch).

The port of ``qec_ldpc_tpu/parallel/mc_graph.py::make_graph_sharded_chunk``
for circulant codes.  Per chunk, on every rank:

  sample (data-local, the same on every rank of a graph group) -> full
  syndromes -> graph-sharded X/Z decode (the halo collectives ride the
  ``graph`` axis) [-> graph-sharded relay retries] -> all_gather of the
  decisions over ``graph`` -> classify -> counters.

The group's counters are summed over ``data`` once.  Samples come from the
generators of (seed, chunk, data index), as in the data-parallel chunk
(``montecarlo.make_sharded_chunk``), so for the exact decoders (min-sum,
layered min-sum) the counters equal a data-only mesh's of the same
``num_data`` bit for bit; sum-product reassociates the cross-shard products
and agrees statistically.

Not ported: the lane-sharded lifted engine (ROADMAP queue 1 item 12b) and
the quality-mode chunks (``make_graph_sharded_arrays_chunk``,
``make_graph_sharded_osd_chunk``; item 12c).
"""

from __future__ import annotations

import numpy as np
import torch

from qec_ldpc_tpu_torch.decoder.decode import CodeGraphs, error_code
from qec_ldpc_tpu_torch.decoder.layout import CirculantGraph
from qec_ldpc_tpu_torch.decoder.min_sum import prior_llr
from qec_ldpc_tpu_torch.decoder.sum_product import BPConfig
from qec_ldpc_tpu_torch.parallel.graph_sharded import (
    _decode_one_graph_sharded,
    _relay_one_graph_sharded,
    routers,
)
from qec_ldpc_tpu_torch.parallel.mesh import DATA_AXIS, GRAPH_AXIS, Mesh
from qec_ldpc_tpu_torch.parallel.montecarlo import (
    chunk_generator,
    reduce_over_data,
    relay_generator,
    sample_syndromes,
)
from qec_ldpc_tpu_torch.sampling.classify import NUM_COUNTERS, classify_batch


def make_graph_sharded_chunk(mesh: Mesh, graphs: CodeGraphs, weight: int,
                             cfg: BPConfig, batch_per_device: int,
                             error_model: str = "weight",
                             relay_retries: int = 0):
    """This rank's (data x graph)-sharded chunk group, with the contract of
    ``montecarlo.make_sharded_chunk``: ``chunk_fn(i_minus_p, seed,
    error_probability, chunk_ids, *, device)`` returns the group's
    (counters, iters[2]) summed over the data axis.  ``batch_per_device``
    counts samples per data shard (every graph shard works on the same
    samples).  ``relay_retries > 0`` repairs failed lanes with graph-sharded
    damped retries, each rank drawing the damping of its own variables from
    the generator of (seed, chunk, RELAY_STREAM, data index, graph index)."""
    if cfg.kernel == "pallas" and (cfg.algorithm != "min-sum"
                                   or not isinstance(graphs.x, CirculantGraph)):
        raise ValueError(
            "cfg.kernel='pallas' with num_graph > 1 is only supported for "
            "algorithm='min-sum' on circulant QC codes (the fused "
            "between-halos kernel); use kernel='xla' for this combination")
    if mesh.size(GRAPH_AXIS) <= 1:
        raise ValueError("graph axis has size 1; use make_sharded_chunk")
    x_router, z_router = routers(mesh, graphs)
    didx, gidx = mesh.rank(DATA_AXIS), mesh.rank(GRAPH_AXIS)
    n = graphs.code.n

    def decode_chunk(sx, sz, error_probability, relay_gen):
        prior = np.float32(cfg.prior_factor) * np.float32(error_probability)
        out = []
        for router, syn in ((x_router, sx), (z_router, sz)):
            d, cf, sf, it = _decode_one_graph_sharded(mesh, router, syn,
                                                      prior, cfg)
            if relay_gen is not None:
                d, solved, extra = _relay_one_graph_sharded(
                    mesh, router, syn, prior_llr(prior), cfg, relay_gen, d,
                    ~sf, relay_retries)
                sf, it = ~solved, it + extra
            # rank g owns block columns [g*Lc, (g+1)*Lc): the gathered
            # shards are the global variable order
            out.append((mesh.all_gather(d, GRAPH_AXIS).reshape(n, -1), cf,
                        sf, it))
        (dx, cfx, sfx, itx), (dz, cfz, sfz, itz) = out
        return dx, dz, error_code(sfx, sfz, cfx, cfz), (itx, itz)

    def chunk_fn(i_minus_p, seed, error_probability, chunk_ids, *, device):
        device = torch.device(device)
        counters = torch.zeros(NUM_COUNTERS, dtype=torch.int64, device=device)
        lane_iters = np.zeros(2, dtype=np.int64)
        for c in chunk_ids:
            xe, ze, sx, sz = sample_syndromes(
                graphs, chunk_generator(seed, c, device, didx), weight,
                error_probability, batch_per_device, error_model)
            relay_gen = (relay_generator(seed, c, device, didx, gidx)
                         if relay_retries > 0 else None)
            dx, dz, code, its = decode_chunk(sx, sz, error_probability,
                                             relay_gen)
            counters += classify_batch(i_minus_p, xe, ze, dx.to(torch.int32),
                                       dz.to(torch.int32), code)
            lane_iters += np.asarray(its) * batch_per_device
        iters = torch.from_numpy(lane_iters).to(device)
        return reduce_over_data(mesh, counters, iters)

    return chunk_fn
