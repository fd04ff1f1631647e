"""Single-device Monte-Carlo estimation of logical-error statistics (PyTorch).

The port of ``qec_ldpc_tpu/parallel/montecarlo.py::run_monte_carlo`` without
a mesh, for circulant and lifted codes alike.  Each chunk runs the whole
pipeline on one device:

  sample errors -> syndromes -> X/Z decode [-> relay retries] -> classify
  -> counters.

Per-chunk randomness comes from ``torch.Generator``s on the device seeded
from (seed, global chunk id) — one for the errors and, with
``relay_retries > 0``, one for the relay decoder's damping draws — so the
statistics do not depend on how chunks are grouped.  Counters stay on the
device for a whole group of ``steps_per_call`` chunks; the host reads them
once per group.
"""

from __future__ import annotations

import numpy as np
import torch

from qec_ldpc_tpu_torch.decoder.decode import CodeGraphs, decode_batch
from qec_ldpc_tpu_torch.decoder.relay import relay_decode_batch
from qec_ldpc_tpu_torch.decoder.sum_product import BPConfig
from qec_ldpc_tpu_torch.sampling.classify import (
    NUM_COUNTERS,
    RankBasisTest,
    classify_batch,
    make_rank_basis_test,
)
from qec_ldpc_tpu_torch.sampling.errors import (
    sample_depolarizing_errors,
    sample_weight_w_errors,
)


#: the relay stream's tag: the JAX package's fold_in constant ("RELA")
RELAY_STREAM = 0x52454C41


def _generator(entropy: list[int], device: torch.device | str) -> torch.Generator:
    """A generator seeded from ``entropy`` alone, mixed by NumPy's
    SeedSequence into a 64-bit seed."""
    state = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]) | (int(state[1]) << 32))
    return g


def chunk_generator(seed: int, chunk: int,
                    device: torch.device | str) -> torch.Generator:
    """The error generator of global chunk ``chunk``: a function of
    (seed, chunk) alone."""
    return _generator([seed, chunk], device)


def relay_generator(seed: int, chunk: int,
                    device: torch.device | str) -> torch.Generator:
    """The relay (damping-draw) generator of global chunk ``chunk``: a
    function of (seed, chunk, RELAY_STREAM) alone, independent of the
    error stream."""
    return _generator([seed, chunk, RELAY_STREAM], device)


def _resolve_logical_test(graphs: CodeGraphs, i_minus_p, device):
    """None -> rank-basis test of the code (the reference convention for
    QC-CSS codes, the physical one for bivariate bicycle and
    hypergraph-product codes); a dense matrix goes to ``device``; a
    RankBasisTest passes through."""
    if i_minus_p is None:
        return make_rank_basis_test(graphs.code, device)
    if isinstance(i_minus_p, RankBasisTest):
        return i_minus_p
    return torch.as_tensor(np.asarray(i_minus_p), device=device)


def _sample_and_decode(graphs: CodeGraphs, generator: torch.Generator,
                       weight: int, error_probability: float, cfg: BPConfig,
                       batch: int, error_model: str, relay_retries: int = 0,
                       relay_gen: torch.Generator | None = None):
    """Sample errors -> syndromes -> decode (relay-repaired when
    ``relay_retries > 0``, drawing its gammas from ``relay_gen``).  Returns
    (xe, ze, sx, sz, res) with errors as int32."""
    n = graphs.code.n
    if error_model == "weight":
        xe, ze = sample_weight_w_errors(generator, n, weight, batch)
    elif error_model == "depolarizing":
        xe, ze = sample_depolarizing_errors(generator, n, error_probability,
                                            batch)
    else:
        raise ValueError(f"unknown error model {error_model!r}")
    xe_i = xe.to(torch.int32)
    ze_i = ze.to(torch.int32)
    sx = graphs.x.syndrome(xe_i)
    sz = graphs.z.syndrome(ze_i)
    if relay_retries > 0:
        res, _, _ = relay_decode_batch(graphs, sx, sz, error_probability,
                                       relay_gen, cfg, retries=relay_retries)
    else:
        res = decode_batch(graphs, sx, sz, error_probability, cfg)
    return xe_i, ze_i, sx, sz, res


def _chunk_body(graphs: CodeGraphs, i_minus_p, generator: torch.Generator,
                weight: int, error_probability: float, cfg: BPConfig,
                batch: int, error_model: str, relay_retries: int = 0,
                relay_gen: torch.Generator | None = None):
    """Sample + decode + classify one batch.  Returns device tensors
    (counters[NUM_COUNTERS] int32, iters[2]) with iters the executed BP
    lane-iterations for [X, Z], relay retries included."""
    xe_i, ze_i, _, _, res = _sample_and_decode(
        graphs, generator, weight, error_probability, cfg, batch, error_model,
        relay_retries, relay_gen)
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


def effective_steps_per_call(count: int, batch_size: int,
                             steps_per_call: int) -> int:
    """The steps_per_call :func:`run_monte_carlo` will actually use."""
    return _effective_spc(-(-count // batch_size), steps_per_call)


def run_monte_carlo(
    graphs: CodeGraphs,
    weight: int,
    count: int,
    error_probability: float,
    cfg: BPConfig,
    seed: int,
    batch_size: int = 1024,
    mesh=None,
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

    Returns (counters[NUM_COUNTERS] int64 numpy, total_bp_lane_iterations).
    """
    if mesh is not None:
        raise NotImplementedError("mesh runs are not ported yet (ROADMAP "
                                  "queue 1 item 12)")
    if weight_cap is not None:
        raise NotImplementedError("the dynamic-weight sampler is not ported "
                                  "yet (ROADMAP queue 1 item 11)")
    device = torch.device(device)
    i_minus_p = _resolve_logical_test(graphs, i_minus_p, device)
    totals = np.zeros(NUM_COUNTERS, dtype=np.int64)
    if init_counters is not None:
        totals += np.asarray(init_counters, dtype=np.int64)
    total_iters = 0
    num_chunks = -(-count // batch_size)
    steps_per_call = _effective_spc(num_chunks, steps_per_call)
    groups = [range(g, min(g + steps_per_call, num_chunks))
              for g in range(0, num_chunks, steps_per_call)]
    for gi in range(start_chunk, len(groups)):
        counters = torch.zeros(NUM_COUNTERS, dtype=torch.int64, device=device)
        iters = torch.zeros(2, dtype=torch.int64, device=device)
        for c in groups[gi]:
            cnt, its = _chunk_body(graphs, i_minus_p,
                                   chunk_generator(seed, c, device), weight,
                                   error_probability, cfg, batch_size,
                                   error_model, relay_retries,
                                   relay_generator(seed, c, device)
                                   if relay_retries > 0 else None)
            counters += cnt
            iters += its
        host = torch.cat([counters, iters]).cpu().numpy()  # one fetch
        group_counters = host[:NUM_COUNTERS]
        group_iters = int(host[NUM_COUNTERS:].sum())
        totals += group_counters
        total_iters += group_iters
        if progress is not None:
            progress(gi, len(groups), group_counters, group_iters)
    return totals, total_iters
