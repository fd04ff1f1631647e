"""Batched normalized min-sum BP over a circulant or lifted Tanner graph
(PyTorch).

The plain PyTorch version of ``qec_ldpc_tpu/decoder/min_sum.py``, and the
reference the CUDA kernels (kernels/min_sum_cuda.py on a ``CirculantGraph``,
kernels/lifted_min_sum_cuda.py on a ``LiftedGraph``) are held against; it
reads the graph only through its duck-typed views.  LLR
convention ``llr = log(P(no error) / P(error))``, so ``p >= 0.5 <=> llr <= 0``:

  * check-node rule  E = syndrome_sign * (alpha * prod(sign V_l') * min |V_l'|)
  * var-node rule    V = prior_llr + sum(E_b'), leaving out the target check
    except on the last iteration, which forms the full posterior
  * optional damping V = d * V_old + (1 - d) * V_new per check-indexed edge
    (the relay decoder's engine, decoder/relay.py)
  * convergence: a lane is done when no message has |llr| < ln((1-low)/low),
    tested on the masked messages after each iteration n with
    n % check_every == 0; converged lanes are frozen, and the loop ends when
    all lanes are done or the iteration cap is reached.

Bit-exact with the JAX version on the CPU, the damped path included.  The
leave-one-out sums keep the JAX code's prefix/suffix association order; XLA
on the CPU contracts the damped blend into ``fma(1 - d, V_new, d * V_old)``,
which :func:`~qec_ldpc_tpu_torch.decoder.sum_product.fma_f32` reproduces.

The prior LLR is a host value here, not a device computation: XLA's float32
``log`` and PyTorch's differ by up to 2 ulp on about 6% of priors (they agree
at the priors the repository runs).  :func:`prior_llr` computes it once on
the host, and every run takes it as a Python float.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from qec_ldpc_tpu_torch.decoder.layout import CirculantGraph
from qec_ldpc_tpu_torch.decoder.lifted import LiftedGraph
from qec_ldpc_tpu_torch.decoder.sum_product import exclusive_scans, fma_f32


def prior_llr(prior: float) -> float:
    """Channel prior probability -> float32 LLR ``log1p(-p) - log(p)``, on
    the host, returned as a Python float holding a float32 value."""
    p = torch.tensor(np.float32(prior), dtype=torch.float32)
    return float(torch.log1p(-p) - torch.log(p))


def np_log_band(conv_low: float) -> float:
    """Probability band edge -> LLR magnitude: p in (low, 1-low) iff
    |llr| < log((1-low)/low)."""
    return math.log((1.0 - conv_low) / conv_low)


def f32(x: float) -> float:
    """A Python float rounded to float32 (JAX compares and multiplies weakly
    typed Python floats in float32)."""
    return float(np.float32(x))


def _loo_sums(terms: list[torch.Tensor]) -> list[torch.Tensor]:
    """Leave-one-out sums of a short list (exclusive prefix + suffix)."""
    prefix, suffix = exclusive_scans(terms, torch.add, torch.zeros_like(terms[0]))
    return [p + s for p, s in zip(prefix, suffix)]


def _loo_mins(terms: list[torch.Tensor]) -> list[torch.Tensor]:
    """Leave-one-out minima of a short list (NaN propagates, as in JAX)."""
    prefix, suffix = exclusive_scans(terms, torch.minimum,
                                     torch.full_like(terms[0], math.inf))
    return [torch.minimum(p, s) for p, s in zip(prefix, suffix)]


def _loo_sign_products(signs: list[torch.Tensor]) -> list[torch.Tensor]:
    """Leave-one-out products of +-1 sign tensors."""
    prefix, suffix = exclusive_scans(signs, torch.mul, torch.ones_like(signs[0]))
    return [p * s for p, s in zip(prefix, suffix)]


def _sign(t: torch.Tensor) -> torch.Tensor:
    """-1 where t < 0, else +1 (NaN and -0 give +1)."""
    return torch.where(t < 0, -1.0, 1.0).to(t.dtype)


def cn_update_min_sum(graph: CirculantGraph | LiftedGraph, v: torch.Tensor,
                      syndrome_sign: torch.Tensor, alpha: float) -> torch.Tensor:
    """Normalized min-sum check-node update; v, result check-indexed
    (num_edges, batch) LLRs.  ``syndrome_sign``: per-edge +-1 rows."""
    alpha = f32(alpha)
    t = graph.cn_view(v)                       # (B, L, P*batch)
    mags = [t[:, i].abs() for i in range(graph.check_degree)]
    sgns = [_sign(t[:, i]) for i in range(graph.check_degree)]
    loo_min = _loo_mins(mags)
    loo_sgn = _loo_sign_products(sgns)
    e = torch.stack([alpha * loo_sgn[i] * loo_min[i]
                     for i in range(graph.check_degree)], dim=1)
    return syndrome_sign * e.reshape(v.shape)


def vn_update_llr(graph: CirculantGraph | LiftedGraph, e: torch.Tensor,
                  prior_llr: float, last: bool) -> torch.Tensor:
    """LLR variable-node update: leave-one-out sums plus the prior LLR; the
    last iteration forms full posteriors."""
    ev = graph.vn_view(graph.to_var(e))        # (B, L*P, batch) var-indexed
    terms = [ev[i] for i in range(graph.var_degree)]
    loo = _loo_sums(terms)
    if last:
        full = loo[-1] + terms[-1]
        sums = full.expand(graph.var_degree, *full.shape)
    else:
        sums = torch.stack(loo)
    vv = (prior_llr + sums).reshape(e.shape)
    return graph.to_check(vv)


def _not_converged_mask_llr(v: torch.Tensor, band: float) -> torch.Tensor:
    """Per-lane 'not converged': some message with |llr| < band (NaN counts
    as converged).  The band is rounded to float32 first, as JAX does."""
    return (v.abs() < f32(band)).any(dim=0)


def damped_blend(damping: torch.Tensor, v_old: torch.Tensor,
                 v_new: torch.Tensor) -> torch.Tensor:
    """``damping * v_old + (1 - damping) * v_new`` as XLA's CPU backend
    computes it: one fused multiply-add, ``fma(1 - d, v_new, d * v_old)``
    (of the three ways to round it, the one that matches XLA bit for bit)."""
    return fma_f32(1.0 - damping, v_new, damping * v_old)


def min_sum_run(
    graph: CirculantGraph | LiftedGraph,
    syndrome: torch.Tensor,          # (num_checks, batch) in {0, 1}
    prior_llr: float,                # float32 channel prior LLR (prior_llr())
    max_iters: int,
    check_every: int = 10,
    conv_low: float = 0.01,
    alpha: float = 0.75,
    damping: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run normalized min-sum.  Returns ``(v_final, iters_executed)``:
    check-indexed LLR messages (num_edges, batch) f32 and the number of
    iterations the loop ran (0-dim int32 tensor).

    ``damping``: optional check-indexed (num_edges, batch) float32 memory
    coefficients in [0, 1); each iteration blends
    ``v = damping * v_old + (1 - damping) * v_new``.  ``None`` is the exact
    undamped update.  The host reads the done mask only after a convergence
    test, the one place it can change."""
    v, n, _ = _min_sum_loop(graph, syndrome, prior_llr, max_iters,
                            check_every, conv_low, alpha, damping)
    return v, n


def min_sum_run_lanes(
    graph: CirculantGraph | LiftedGraph,
    syndrome: torch.Tensor,
    prior_llr: float,
    max_iters: int,
    check_every: int = 10,
    conv_low: float = 0.01,
    alpha: float = 0.75,
    damping: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`min_sum_run` with each lane's own executed iteration count:
    ``(v_final, lane_iters (batch,) int32)``, the iterations in which the
    lane was not yet done.  Lanes decode independently and a done lane is
    frozen, so a lane's count is what :func:`min_sum_run` gives for the lane
    run alone, and their maximum is the batch run's count.  The reference
    the min-sum kernel's per-lane ``iters`` is held to."""
    v, _, lane_iters = _min_sum_loop(graph, syndrome, prior_llr, max_iters,
                                     check_every, conv_low, alpha, damping)
    return v, lane_iters


def _min_sum_loop(graph, syndrome, prior_llr, max_iters, check_every,
                  conv_low, alpha, damping):
    """The loop of :func:`min_sum_run`: ``(v_final, iters_executed, per-lane
    executed iterations)``."""
    batch = syndrome.shape[-1]
    device = syndrome.device
    prior_llr = f32(prior_llr)
    band = np_log_band(conv_low)
    sign = graph.expand_checks(1.0 - 2.0 * syndrome.to(torch.float32))
    v = torch.full((graph.num_edges, batch), prior_llr, dtype=torch.float32,
                   device=device)
    if damping is not None:
        damping = damping.to(torch.float32)
    done = torch.zeros(batch, dtype=torch.bool, device=device)
    lane_iters = torch.zeros(batch, dtype=torch.int32, device=device)
    # a lane-sharded graph (parallel/lifted_sharded.py) merges the mask and
    # the continue flag over its graph group, so every rank of the group
    # runs the loop in lockstep, as its in-loop collectives require
    combine_mask = getattr(graph, "combine_lane_mask", None)
    combine_cont = getattr(graph, "combine_continue", None)
    all_done = False
    n = 0
    while n < max_iters and not all_done:
        e = cn_update_min_sum(graph, v, sign, alpha)
        v_new = vn_update_llr(graph, e, prior_llr, last=(n == max_iters - 1))
        if damping is not None:
            v_new = damped_blend(damping, v, v_new)
        v = torch.where(done[None, :], v, v_new)
        lane_iters += ~done
        if n % check_every == 0:
            mask = _not_converged_mask_llr(v, band)
            if combine_mask is not None:
                mask = combine_mask(mask)
            done = done | ~mask
            cont = not bool(done.all())
            if combine_cont is not None:
                cont = combine_cont(cont)
            all_done = not cont
        n += 1
    return v, torch.full((), n, dtype=torch.int32, device=device), lane_iters
