"""Relay / ensemble BP: randomized damped min-sum retries for BP failures.

The port of ``qec_ldpc_tpu/decoder/relay.py``.  When the primary decode's
hard decision violates the syndrome, the lane is decoded again by min-sum
with RANDOM PER-VARIABLE DAMPING: each retry draws fresh
``gamma ~ U[gamma_low, gamma_high)`` per (variable, lane) and blends
``v = gamma * v_old + (1 - gamma) * v_new`` on every edge of the variable.
The disorder breaks the trapping-set symmetries that pin flooding BP; a lane
is repaired as soon as a retry's hard decision satisfies its syndrome, which
an exact re-encode checks.  Retries run through
``kernels/min_sum_cuda.min_sum_run`` with its damping operand: the CUDA
kernel on a CUDA tensor (K2, or K5 on the lifted graphs of bivariate
bicycle and hypergraph-product codes), the plain version on a CPU tensor.

Solved lanes get a zero syndrome, so they converge at the first convergence
check and cost one check window.  The JAX version loops under
``lax.while_loop`` until every lane is solved or the retries run out; here
that condition is read on the host, so each retry costs one device-to-host
read (``bool(solved.all())``), the port's image of the loop's ``cond``.

The gammas come from :class:`RelayDraws`: retry r of graph k draws from its
own generator, seeded from (the caller's entropy, k, r) alone, so no
graph's draws depend on how many retries the other graph ran, and a decode
of some columns of a wider batch (a data shard's) draws exactly the gammas
the whole batch's decode gives those lanes (JAX's ``gamma_lanes`` and
``lane_offset``).  Torch's streams cannot match JAX's keys: relay is held
exactly on shared gammas and statistically end to end.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from qec_ldpc_tpu_torch import tracing
from qec_ldpc_tpu_torch.decoder.decode import (
    SYNDROME_FAIL_X,
    SYNDROME_FAIL_Z,
    CodeGraphs,
    DecodeResult,
    decode_batch,
    syndrome_fail,
)
from qec_ldpc_tpu_torch.decoder.layout import CirculantGraph
from qec_ldpc_tpu_torch.decoder.lifted import LiftedGraph
from qec_ldpc_tpu_torch.decoder.min_sum import prior_llr
from qec_ldpc_tpu_torch.decoder.sum_product import BPConfig
from qec_ldpc_tpu_torch.kernels import min_sum_cuda
from qec_ldpc_tpu_torch.sampling.errors import seeded_generator

#: default damping-draw range gamma ~ U[GAMMA_LOW, GAMMA_HIGH), the JAX
#: package's (tuned there on [[610,61]] W in {40, 50} and BB [[144,12,12]])
GAMMA_LOW = 0.05
GAMMA_HIGH = 1.0


class RelayDraws:
    """The damping draws of one relay decode.  Retry ``r`` of graph ``k``
    (0 for X, 1 for Z) draws a (num_vars, ``width``) float32 uniform from
    the generator of (``entropy``, k, r) on ``device`` and keeps the columns
    ``offset`` .. ``offset + batch``; ``width`` None is the decode's own
    batch."""

    def __init__(self, entropy, device: torch.device | str,
                 width: int | None = None, offset: int = 0):
        self.entropy = [int(e) for e in entropy]
        self.device = torch.device(device)
        self.width, self.offset = width, offset

    def gammas(self, k: int, num_vars: int, batch: int,
               low: float = GAMMA_LOW, high: float = GAMMA_HIGH
               ) -> Callable[[int], torch.Tensor]:
        """Retry r -> graph ``k``'s (num_vars, batch) draw from U[low,
        high)."""
        width = batch if self.width is None else self.width
        lo = self.offset
        if lo < 0 or lo + batch > width:
            raise ValueError(f"lanes {lo}..{lo + batch} lie outside the "
                             f"{width} drawn")

        def draw(r: int) -> torch.Tensor:
            g = seeded_generator([*self.entropy, k, r], self.device)
            u = torch.rand((num_vars, width), generator=g, device=self.device,
                           dtype=torch.float32)
            return u[:, lo:lo + batch] * (high - low) + low
        return draw


def _relay_one_graph(graph: CirculantGraph | LiftedGraph,
                     syndrome: torch.Tensor,
                     llr: float, cfg: BPConfig,
                     gammas: Callable[[int], torch.Tensor],
                     decisions0: torch.Tensor, solved0: torch.Tensor,
                     retries: int):
    """Retry loop for one graph.  ``decisions0``/``solved0``: the primary
    decode's hard decisions and per-lane syndrome-satisfied mask;
    ``gammas(r)`` gives retry r's (num_vars, batch) damping draw.

    Returns ``(decisions, solved, retries_used, extra_lane_iters)``: the
    last counts the retries' executed min-sum lane-iterations (a 0-dim
    tensor), so the work accounting stays honest under relay.  Counts the
    retries in ``relay.retries``."""
    decisions, solved = decisions0, solved0
    with tracing.span("mc.relay"):
        lane_iters = torch.zeros((), dtype=torch.int64, device=syndrome.device)
        r = 0
        while r < retries:
            with tracing.span("mc.fetch"):
                done = bool(solved.all())
            if done:
                break
            damping = graph.expand_vars(gammas(r)).contiguous()
            s_eff = torch.where(solved[None, :], 0, syndrome)
            with tracing.span("mc.launch"):
                v, per_lane = min_sum_cuda.min_sum_run(
                    graph, s_eff, llr, cfg.max_iters, cfg.check_every,
                    cfg.conv_low, cfg.min_sum_alpha, damping=damping)
            vv = graph.vn_view(graph.to_var(v))
            d_new = (vv <= 0.0).any(dim=0).to(decisions.dtype)
            newly = ~syndrome_fail(graph, d_new, syndrome) & ~solved
            decisions = torch.where(newly[None, :], d_new, decisions)
            solved = solved | newly
            lane_iters = lane_iters + per_lane.sum()
            r += 1
        tracing.count("relay.retries", r)
    return decisions, solved, r, lane_iters


def relay_decode_batch(
    graphs: CodeGraphs,
    syndrome_x: torch.Tensor,
    syndrome_z: torch.Tensor,
    error_probability: float,
    draws: RelayDraws,
    cfg: BPConfig = BPConfig(),
    retries: int = 8,
    gamma_low: float = GAMMA_LOW,
    gamma_high: float = GAMMA_HIGH,
) -> tuple[DecodeResult, int, int]:
    """Primary decode (``cfg`` as configured) + relay retries for failed
    lanes.  Returns ``(result, retries_x, retries_z)``: the primary
    DecodeResult with decisions and error code replaced where a retry
    repaired the lane.

    SYNDROME_FAIL bits are cleared on repaired lanes; convergence-fail bits
    keep their meaning from the primary decode.  The retries' executed
    lane-iterations are added to ``iter_samples_x/z``.  The gammas come
    from ``draws``, graph 0 the X retries and graph 1 the Z retries."""
    res = decode_batch(graphs, syndrome_x, syndrome_z, error_probability, cfg)
    llr = prior_llr(np.float32(cfg.prior_factor) * np.float32(error_probability))
    ec = res.error_code
    out = {}
    for k, name, bit, graph, syn, dec in (
        (0, "x", SYNDROME_FAIL_X, graphs.x, syndrome_x, res.decisions_x),
        (1, "z", SYNDROME_FAIL_Z, graphs.z, syndrome_z, res.decisions_z),
    ):
        syn = syn.to(torch.int32).contiguous()
        gammas = draws.gammas(k, graph.num_vars, syn.shape[1], gamma_low,
                              gamma_high)
        d, solved, used, extra = _relay_one_graph(
            graph, syn, llr, cfg, gammas, dec, (ec & bit) == 0, retries)
        ec = torch.where(solved, ec & ~bit, ec)
        out[name] = (d, used, extra)
    result = dataclasses.replace(
        res, decisions_x=out["x"][0], decisions_z=out["z"][0], error_code=ec,
        iter_samples_x=res.iter_samples_x + out["x"][2],
        iter_samples_z=res.iter_samples_z + out["z"][2])
    return result, out["x"][1], out["z"][1]
