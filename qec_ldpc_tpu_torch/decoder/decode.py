"""Full X/Z decode with hard decision and error-code flags (PyTorch).

The port of ``qec_ldpc_tpu/decoder/decode.py`` for circulant graphs and
lifted graphs (bivariate bicycle, hypergraph-product and toric codes):
decode the X and Z syndromes with ``cfg.algorithm``, hard-decide each
variable, flag per-lane convergence failures, and flag syndrome failures by
re-encoding the decision.  Per algorithm:

  * ``"sum-product"``: flipped if ANY incident message is >= 0.5 (the
    reference's any-edge rule); convergence failures from a final band test.
    Runs through ``kernels/bp_cuda.bp_run`` (K1, or K6 on a lifted graph).
  * ``"min-sum"``: the LLR image, flipped if any incident LLR is <= 0;
    convergence failures from the LLR band test.  Runs through
    ``kernels/min_sum_cuda.min_sum_run`` (K2/K4, or K5 on a lifted graph;
    both lifted graphs in one K5 launch where :func:`paired_path` holds).
  * ``"layered-min-sum"``: flipped where the posterior LLR is <= 0; a
    convergence failure IS a syndrome failure.  Runs through
    ``kernels/layered_cuda.layered_run``; circulant graphs only (the block
    rows of a lifted graph are not variable-disjoint layers).

Each wrapper runs its CUDA kernel for CUDA tensors and its plain PyTorch
version for CPU tensors.

With ``cfg.return_soft`` the result also carries per-variable soft outputs
``(num_vars, batch)`` float32, the reliabilities OSD ranks by
(decoder/osd.py): layered min-sum's posterior ``q``; for min-sum the sum of
each variable's edge LLRs; for sum-product the sum of its edges'
``log1p(-v) - log(v)`` with ``v`` clipped to [1e-12, 1 - 1e-7] and NaN edges
counting 0.  The edge sums run left to right over the incidence rank, the
order JAX's CPU reduction takes, so min-sum soft outputs match it bit for
bit on any device (a CUDA reduction promises no order).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qec_ldpc_tpu_torch import tracing
from qec_ldpc_tpu_torch.codes import QuantumLDPCCode
from qec_ldpc_tpu_torch.decoder import layered, min_sum, sum_product
from qec_ldpc_tpu_torch.decoder.layout import CirculantGraph
from qec_ldpc_tpu_torch.decoder.lifted import LiftedGraph
from qec_ldpc_tpu_torch.decoder.min_sum import (
    _not_converged_mask_llr,
    np_log_band,
    prior_llr,
)
from qec_ldpc_tpu_torch.decoder.sum_product import BPConfig, _not_converged_mask
from qec_ldpc_tpu_torch.kernels import (
    bp_cuda,
    layered_cuda,
    lifted_min_sum_cuda,
    min_sum_cuda,
)

ALGORITHMS = ("sum-product", "min-sum", "layered-min-sum")

# ErrorCode bit flags (the reference's Decoder.h)
SUCCESS = 0
SYNDROME_FAIL_X = 1
SYNDROME_FAIL_Z = 2
CONVERGENCE_FAIL_X = 4
CONVERGENCE_FAIL_Z = 8


@dataclasses.dataclass(frozen=True, eq=False)
class CodeGraphs:
    """Static decode-time structure for one code: the X and Z graphs, both
    circulant (``build``) or both lifted (``BicycleCode.build_graphs``,
    ``HypergraphProductCode.build_graphs``)."""

    code: QuantumLDPCCode  # or BicycleCode / HypergraphProductCode
    x: CirculantGraph | LiftedGraph
    z: CirculantGraph | LiftedGraph

    @staticmethod
    def build(code: QuantumLDPCCode) -> "CodeGraphs":
        with tracing.span("setup.graphs"):
            return CodeGraphs(
                code=code,
                x=CirculantGraph.from_table(code.hc, code.P),
                z=CirculantGraph.from_table(code.hd, code.P),
            )


@dataclasses.dataclass
class DecodeResult:
    """Batched decode output; all tensors have a trailing batch axis."""

    decisions_x: torch.Tensor  # (num_vars, batch) int8 hard decisions
    decisions_z: torch.Tensor
    error_code: torch.Tensor   # (batch,) int32 bitmask
    iters_x: torch.Tensor      # () max iterations executed by any lane
    iters_z: torch.Tensor
    #: () executed lane-iterations (sum over lanes of each lane's count)
    iter_samples_x: torch.Tensor
    iter_samples_z: torch.Tensor
    #: (num_vars, batch) float32 soft outputs when ``cfg.return_soft``
    soft_x: torch.Tensor | None = None
    soft_z: torch.Tensor | None = None


def error_code(sfx: torch.Tensor, sfz: torch.Tensor, cfx: torch.Tensor,
               cfz: torch.Tensor) -> torch.Tensor:
    """(batch,) int32 ErrorCode bits from the per-lane syndrome-fail and
    convergence-fail flags of the X and Z graphs."""
    return (sfx.to(torch.int32) * SYNDROME_FAIL_X
            + sfz.to(torch.int32) * SYNDROME_FAIL_Z
            + cfx.to(torch.int32) * CONVERGENCE_FAIL_X
            + cfz.to(torch.int32) * CONVERGENCE_FAIL_Z)


def decide(graph: CirculantGraph | LiftedGraph, v: torch.Tensor,
           syndrome: torch.Tensor, cfg: BPConfig):
    """Decisions and failure flags from final messages ``v`` of
    ``cfg.algorithm`` ("sum-product": probabilities, "min-sum": LLRs).

    Returns ``(decisions (num_vars, batch) int8, conv_fail (batch,) bool,
    syn_fail (batch,) bool)``.  A NaN message (0/0 on a saturated lane)
    fails both compares and sets no decision bit."""
    vv = graph.vn_view(graph.to_var(v))  # (B, num_vars, batch)
    if cfg.algorithm == "min-sum":
        decisions = (vv <= 0.0).any(dim=0).to(torch.int8)
        conv_fail = _not_converged_mask_llr(v, np_log_band(cfg.conv_low))
    else:
        decisions = (vv >= cfg.hard_threshold).any(dim=0).to(torch.int8)
        conv_fail = _not_converged_mask(v, cfg.conv_low, cfg.conv_high)
    return decisions, conv_fail, syndrome_fail(graph, decisions, syndrome)


def syndrome_fail(graph: CirculantGraph | LiftedGraph,
                  decisions: torch.Tensor,
                  syndrome: torch.Tensor) -> torch.Tensor:
    """Per lane: the re-encoded decision differs from the syndrome."""
    return (graph.syndrome(decisions.to(torch.int32)) != syndrome).any(dim=0)


def _edge_sum(vv: torch.Tensor) -> torch.Tensor:
    """(rank, num_vars, batch) -> (num_vars, batch): the sum over the
    incidence rank, left to right."""
    total = vv[0]
    for i in range(1, vv.shape[0]):
        total = total + vv[i]
    return total


def edge_soft(vv: torch.Tensor, cfg: BPConfig) -> torch.Tensor:
    """(rank, ..., batch) var-side messages of ``cfg.algorithm`` ("min-sum":
    LLRs, "sum-product": probabilities) -> (..., batch) soft outputs: the
    sum of the edge LLRs over the incidence rank, left to right."""
    if cfg.algorithm == "min-sum":
        return _edge_sum(vv)
    # a NaN edge (0/0 on a saturated lane) carries no information: 0 LLR
    vc = vv.clamp(1e-12, 1.0 - 1e-7)
    term = torch.log1p(-vc) - torch.log(vc)
    return _edge_sum(torch.where(vv.isnan(), 0.0, term))


def soft_output(graph: CirculantGraph | LiftedGraph, v: torch.Tensor,
                cfg: BPConfig) -> torch.Tensor:
    """Per-variable soft output from final messages ``v`` of
    ``cfg.algorithm``: the sum of the edge LLRs, an affine image of the
    posterior LLR within a lane (each edge is the prior plus a leave-one-out
    sum), so it ranks the variables as the posterior does."""
    return edge_soft(graph.vn_view(graph.to_var(v)), cfg)


def lane_sort(syndrome: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(perm, inv)``: the batch-lane permutation that orders lanes by
    syndrome weight (a stable sort, so equal weights keep their order), and
    its inverse.  The same permutation as the JAX package's
    ``decoder/decode.py::_lane_sort``; syndrome weight predicts how long a
    lane takes to converge."""
    perm = torch.argsort(syndrome.sum(dim=0), stable=True)
    return perm, torch.argsort(perm)


def _sort_lanes(syndrome: torch.Tensor, cfg: BPConfig):
    """``(the syndrome the kernel decodes, the inverse permutation or
    None)``: in :func:`lane_sort` order where ``cfg.kernel_sort_lanes``."""
    if not cfg.kernel_sort_lanes:
        return syndrome, None
    perm, inv = lane_sort(syndrome)
    return syndrome[:, perm].contiguous(), inv


def _unsort(out: torch.Tensor, lane_iters: torch.Tensor, inv):
    """A kernel's outputs back in the lanes' given order."""
    return (out, lane_iters) if inv is None else (out[:, inv], lane_iters[inv])


def run_decoder(graph: CirculantGraph | LiftedGraph, syndrome: torch.Tensor,
                prior: np.float32, cfg: BPConfig, plain: bool = False):
    """One graph through ``cfg.algorithm``'s kernel wrapper: ``(out,
    lane_iters)``, ``out`` the final check-indexed messages (sum-product:
    probabilities, min-sum: LLRs) or layered min-sum's posteriors, and
    ``lane_iters`` (batch,) each lane's executed iterations.  ``plain``: run
    the plain PyTorch loop on any device, every lane counting the loop's
    iterations.

    With ``cfg.kernel_sort_lanes`` the kernel decodes the lanes in
    :func:`lane_sort` order and its outputs go back to the original order
    right after the call, so everything after it sees the lanes as given.
    Lanes decode independently, so only the per-lane iteration counts'
    placement within a launch changes."""
    if cfg.algorithm == "layered-min-sum" and isinstance(graph, LiftedGraph):
        raise ValueError(
            "layered-min-sum requires a CirculantGraph (block-row layers of "
            "a lifted graph are not variable-disjoint); use algorithm="
            "'min-sum' for lifted codes")
    syn_k, inv = _sort_lanes(syndrome, cfg)
    # the kernel wrappers and the plain loops take the same arguments
    if cfg.algorithm == "layered-min-sum":
        run = layered.layered_min_sum_run if plain else layered_cuda.layered_run
        args = (prior_llr(prior), cfg.max_iters, cfg.layered_check_every,
                cfg.min_sum_alpha)
    elif cfg.algorithm == "min-sum":
        run = min_sum.min_sum_run if plain else min_sum_cuda.min_sum_run
        args = (prior_llr(prior), cfg.max_iters, cfg.check_every,
                cfg.conv_low, cfg.min_sum_alpha)
    else:
        run = sum_product.bp_run if plain else bp_cuda.bp_run
        args = (prior, cfg.max_iters, cfg.check_every, cfg.conv_low,
                cfg.conv_high)
    with tracing.span("mc.launch"):
        out, lane_iters = run(graph, syn_k, *args)
    if plain:
        lane_iters = lane_iters.expand(syn_k.shape[1])
    return _unsort(out, lane_iters, inv)


def paired_path(graphs: CodeGraphs, cfg: BPConfig,
                device: torch.device | str, plain: bool = False) -> bool:
    """Whether both graphs can decode in one launch
    (``lifted_min_sum_cuda.lifted_min_sum_pair_run``, K5 on both sectors):
    on a CUDA device, not ``plain``, for min-sum on two lifted graphs that
    share one plan (``lifted_min_sum_cuda.pair_plan``: one ``Dv``, every
    array in shared memory).  A caller asks once, for all its calls of
    :func:`run_decoders` (:func:`decode_batch` once a call, the Monte-Carlo
    drivers once a point), and counts what it passed."""
    return (torch.device(device).type == "cuda" and not plain
            and cfg.algorithm == "min-sum"
            and lifted_min_sum_cuda.pair_plan((graphs.x, graphs.z), False,
                                              device) is not None)


def run_decoders(graphs: CodeGraphs, syndromes, prior: np.float32,
                 cfg: BPConfig, paired: bool, plain: bool = False):
    """Both graphs, X then Z: :func:`run_decoder`'s two ``(out,
    lane_iters)``.  ``paired``: the caller's :func:`paired_path` decision,
    made once for all its calls.  Where it holds, one launch decodes both
    (each sector's lanes sorted on their own first where
    ``cfg.kernel_sort_lanes``), with each lane's result what two launches
    give, bit for bit; otherwise one launch a graph."""
    sx, sz = syndromes
    if not paired:
        return (run_decoder(graphs.x, sx, prior, cfg, plain),
                run_decoder(graphs.z, sz, prior, cfg, plain))
    (sx_k, inv_x), (sz_k, inv_z) = (_sort_lanes(s, cfg) for s in syndromes)
    with tracing.span("mc.launch"):
        (vx, itx), (vz, itz) = lifted_min_sum_cuda.lifted_min_sum_pair_run(
            (graphs.x, graphs.z), (sx_k, sz_k), prior_llr(prior),
            cfg.max_iters, cfg.check_every, cfg.conv_low, cfg.min_sum_alpha)
    return _unsort(vx, itx, inv_x), _unsort(vz, itz, inv_z)


def _finish_graph(graph: CirculantGraph | LiftedGraph, syndrome: torch.Tensor,
                  out: torch.Tensor, cfg: BPConfig):
    """One graph's decoder output ``out`` (:func:`run_decoder`'s):
    ``(decisions, conv_fail, syn_fail, soft)``, ``soft`` None unless
    ``cfg.return_soft``."""
    if cfg.algorithm == "layered-min-sum":
        # layered keeps posteriors: the decision is q <= 0, and "failed to
        # converge" is "the decision violates the syndrome"
        decisions = (out <= 0.0).to(torch.int8)
        syn_fail = syndrome_fail(graph, decisions, syndrome)
        # layered q IS the posterior
        return (decisions, syn_fail, syn_fail,
                out if cfg.return_soft else None)
    soft = soft_output(graph, out, cfg) if cfg.return_soft else None
    return (*decide(graph, out, syndrome, cfg), soft)


def decode_batch(
    graphs: CodeGraphs,
    syndrome_x: torch.Tensor,  # (J*P, batch) in {0, 1}
    syndrome_z: torch.Tensor,  # (K*P, batch)
    error_probability: float,
    cfg: BPConfig = BPConfig(),
    *,
    plain: bool = False,
) -> DecodeResult:
    """Decode both graphs with ``cfg.algorithm`` (one of ``ALGORITHMS``).

    ``iter_samples_*`` counts executed lane-iterations: on the kernel path
    each lane's own count, for sum-product (K1, K6 on a lifted graph),
    min-sum (K2/K4, K5) and layered min-sum (K3) alike (JAX's Pallas
    kernels count per 128-lane tile); iterations x batch on the plain path,
    as in JAX.  ``plain``: run the plain PyTorch version on CUDA tensors too
    (decoder/validate.py's engine: a CUDA kernel cannot be instrumented);
    on CPU tensors it always runs.  Both graphs go through
    :func:`run_decoders`, so min-sum on a lifted code whose two graphs share
    one plan decodes them in one launch on a card (:func:`paired_path`)."""
    if cfg.algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {cfg.algorithm!r}; expected one "
                         f"of {ALGORITHMS}")
    if cfg.kernel_roll_impl == "mxu":
        raise NotImplementedError(
            "kernel_roll_impl='mxu' is a TPU matrix-unit routing; the port "
            "routes by index")
    prior = np.float32(cfg.prior_factor) * np.float32(error_probability)
    out, ec = [], None
    with tracing.span("mc.decode"):
        syndromes = [s.to(torch.int32).contiguous()
                     for s in (syndrome_x, syndrome_z)]
        decoded = run_decoders(
            graphs, syndromes, prior, cfg,
            paired_path(graphs, cfg, syndromes[0].device, plain), plain)
        for graph, syndrome, (v, lane_iters), syn_bit, conv_bit in (
                (graphs.x, syndromes[0], decoded[0], SYNDROME_FAIL_X,
                 CONVERGENCE_FAIL_X),
                (graphs.z, syndromes[1], decoded[1], SYNDROME_FAIL_Z,
                 CONVERGENCE_FAIL_Z)):
            decisions, conv_fail, syn_fail, soft = _finish_graph(
                graph, syndrome, v, cfg)
            # each graph's error-code bits (error_code's, one graph at a time)
            bits = (syn_fail.to(torch.int32) * syn_bit
                    + conv_fail.to(torch.int32) * conv_bit)
            ec = bits if ec is None else ec + bits
            out.append((decisions, lane_iters.max(), lane_iters.sum(), soft))
    (dx, itx, isx, softx), (dz, itz, isz, softz) = out
    return DecodeResult(decisions_x=dx, decisions_z=dz, error_code=ec,
                        iters_x=itx, iters_z=itz,
                        iter_samples_x=isx, iter_samples_z=isz,
                        soft_x=softx, soft_z=softz)


def syndromes_from_errors(
    graphs: CodeGraphs, x_errors: torch.Tensor, z_errors: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(num_vars, batch) error bits -> ((J*P, batch), (K*P, batch)) syndromes."""
    return graphs.x.syndrome(x_errors), graphs.z.syndrome(z_errors)
