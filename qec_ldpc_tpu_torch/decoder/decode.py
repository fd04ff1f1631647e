"""Full X/Z decode with hard decision and error-code flags (PyTorch).

The port of ``qec_ldpc_tpu/decoder/decode.py`` for ``algorithm=
"sum-product"``: decode the X and Z syndromes with BP, hard-decide each
variable as flipped if ANY of its incident messages is >= 0.5 (the
reference's any-edge rule), flag per-lane convergence failures from a final
convergence pass, and flag syndrome failures by re-encoding the decision.

BP runs through ``kernels/bp_cuda.bp_run``: the CUDA kernel for CUDA
tensors, the plain ``sum_product.bp_run`` for CPU tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qec_ldpc_tpu_torch.codes import QuantumLDPCCode
from qec_ldpc_tpu_torch.decoder.layout import CirculantGraph
from qec_ldpc_tpu_torch.decoder.sum_product import BPConfig, _not_converged_mask
from qec_ldpc_tpu_torch.kernels import bp_cuda

# ErrorCode bit flags (the reference's Decoder.h)
SUCCESS = 0
SYNDROME_FAIL_X = 1
SYNDROME_FAIL_Z = 2
CONVERGENCE_FAIL_X = 4
CONVERGENCE_FAIL_Z = 8


@dataclasses.dataclass(frozen=True, eq=False)
class CodeGraphs:
    """Static decode-time structure for one code: the X and Z circulant graphs."""

    code: QuantumLDPCCode
    x: CirculantGraph
    z: CirculantGraph

    @staticmethod
    def build(code: QuantumLDPCCode) -> "CodeGraphs":
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


def decide(graph: CirculantGraph, v: torch.Tensor, syndrome: torch.Tensor,
           cfg: BPConfig):
    """Decisions and failure flags from final BP messages ``v``.

    Returns ``(decisions (num_vars, batch) int8, conv_fail (batch,) bool,
    syn_fail (batch,) bool)``.  A NaN message (0/0 on a saturated lane)
    fails ``>=`` and sets no decision bit."""
    vv = graph.vn_view(graph.to_var(v))  # (B, num_vars, batch)
    decisions = (vv >= cfg.hard_threshold).any(dim=0).to(torch.int8)
    conv_fail = _not_converged_mask(v, cfg.conv_low, cfg.conv_high)
    s_hat = graph.syndrome(decisions.to(torch.int32))
    syn_fail = (s_hat != syndrome).any(dim=0)
    return decisions, conv_fail, syn_fail


def decode_batch(
    graphs: CodeGraphs,
    syndrome_x: torch.Tensor,  # (J*P, batch) in {0, 1}
    syndrome_z: torch.Tensor,  # (K*P, batch)
    error_probability: float,
    cfg: BPConfig = BPConfig(),
) -> DecodeResult:
    """Decode both graphs; ``cfg.algorithm`` must be ``"sum-product"``."""
    if cfg.algorithm != "sum-product":
        raise NotImplementedError(
            f"algorithm={cfg.algorithm!r} is not ported yet (ROADMAP queue 1 "
            f"item 7: min-sum and layered min-sum)")
    if cfg.kernel_roll_impl == "mxu":
        raise NotImplementedError(
            "kernel_roll_impl='mxu' is a TPU matrix-unit routing; the port "
            "routes by index")
    if cfg.return_soft:
        raise NotImplementedError(
            "return_soft feeds OSD post-processing, not ported yet (ROADMAP "
            "queue 1 item 10)")
    prior = np.float32(cfg.prior_factor) * np.float32(error_probability)
    out = []
    for graph, syndrome in ((graphs.x, syndrome_x), (graphs.z, syndrome_z)):
        syndrome = syndrome.to(torch.int32).contiguous()
        v, lane_iters = bp_cuda.bp_run(
            graph, syndrome, prior, cfg.max_iters, cfg.check_every,
            cfg.conv_low, cfg.conv_high)
        out.append((*decide(graph, v, syndrome, cfg),
                    lane_iters.max(), lane_iters.sum()))
    (dx, cfx, sfx, itx, isx), (dz, cfz, sfz, itz, isz) = out
    code = (sfx.to(torch.int32) * SYNDROME_FAIL_X
            + sfz.to(torch.int32) * SYNDROME_FAIL_Z
            + cfx.to(torch.int32) * CONVERGENCE_FAIL_X
            + cfz.to(torch.int32) * CONVERGENCE_FAIL_Z)
    return DecodeResult(decisions_x=dx, decisions_z=dz, error_code=code,
                        iters_x=itx, iters_z=itz,
                        iter_samples_x=isx, iter_samples_z=isz)


def syndromes_from_errors(
    graphs: CodeGraphs, x_errors: torch.Tensor, z_errors: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(num_vars, batch) error bits -> ((J*P, batch), (K*P, batch)) syndromes."""
    return graphs.x.syndrome(x_errors), graphs.z.syndrome(z_errors)
