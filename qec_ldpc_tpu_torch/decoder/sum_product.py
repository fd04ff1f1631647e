"""Batched probability-domain sum-product BP over a circulant or lifted
Tanner graph.

The plain PyTorch version of ``qec_ldpc_tpu/decoder/sum_product.py``, and
the reference the CUDA kernels (kernels/bp_cuda.py on a ``CirculantGraph``,
kernels/lifted_bp_cuda.py on a ``LiftedGraph``) are held against.  It
reads the graph only through its duck-typed views, so it runs on both:

  * check-node rule  E = 0.5 - (0.5 - s) * prod_{l' != l} (1 - 2 v)
  * var-node rule    p*prod(e) / ((1-p)*prod(1-e) + p*prod(e)), leaving out
    the target check except on the last iteration, which forms the full
    posterior
  * convergence: every nonzero message outside (low, high), tested after
    each iteration n with n % check_every == 0, starting at n = 0
  * per-lane early exit: converged lanes are frozen; the loop ends when all
    lanes are done or the iteration cap is reached.

Bit-exact with the JAX version on the CPU.  The float operations and their
association order are the JAX code's, with one addition: XLA contracts the
variable-node denominator ``(1 - p) * prod_m + num`` into a fused
multiply-add, so :func:`fma_f32` forms it with a single rounding here too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qec_ldpc_tpu_torch.decoder.layout import CirculantGraph
from qec_ldpc_tpu_torch.decoder.lifted import LiftedGraph


@dataclasses.dataclass(frozen=True)
class BPConfig:
    """Decode-loop knobs: the same fields and defaults as the JAX
    ``BPConfig`` so configs carry across unchanged.  The port runs every
    ``algorithm`` of the JAX package ("sum-product", "min-sum",
    "layered-min-sum", the last on circulant graphs only).  On a CUDA
    tensor the decode always runs the algorithm's CUDA kernel, so
    ``kernel``, ``kernel_tile_batch`` and ``kernel_roll_impl`` (TPU kernel
    choices) are kept only so the two configs compare equal;
    ``kernel_sort_lanes`` sorts the lanes by syndrome weight around the
    kernel call (``decode.run_decoder``), as JAX does."""

    max_iters: int = 100
    check_every: int = 10
    conv_low: float = 0.01
    conv_high: float = 0.99
    #: channel-prior factor: p = prior_factor * physical error probability
    prior_factor: float = 2.0 / 3.0
    hard_threshold: float = 0.5
    algorithm: str = "sum-product"
    min_sum_alpha: float = 0.75
    layered_check_every: int = 1
    kernel: str = "xla"
    kernel_tile_batch: int = 128
    kernel_roll_impl: str = "shift"
    kernel_sort_lanes: bool = False
    #: also return per-variable soft outputs (posterior-LLR proxies)
    return_soft: bool = False


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded ONCE, like a hardware fused multiply-add.

    The product of two float32 values is exact in float64.  The float64 sum
    is made round-to-odd (its TwoSum error term nudges an inexact even
    result one ulp towards the exact sum), and a round-to-odd value with
    53 >= 24 + 2 bits rounds to the correctly rounded float32 result.
    """
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def exclusive_scans(terms: list[torch.Tensor], combine, identity: torch.Tensor
                    ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Exclusive prefix and suffix scans of a short list under ``combine``:
    ``prefix[i] = combine(prefix[i-1], terms[i-1])`` from ``identity``, and
    ``suffix[i] = combine(suffix[i+1], terms[i+1])`` downwards — the JAX
    versions' association order for every leave-one-out reduction."""
    m = len(terms)
    prefix, suffix = [identity] * m, [identity] * m
    for i in range(1, m):
        prefix[i] = combine(prefix[i - 1], terms[i - 1])
    for i in range(m - 2, -1, -1):
        suffix[i] = combine(suffix[i + 1], terms[i + 1])
    return prefix, suffix


def _loo_products(terms: list[torch.Tensor]) -> list[torch.Tensor]:
    """Leave-one-out products of a short list by exclusive prefix and
    suffix products, in the JAX version's association order."""
    prefix, suffix = exclusive_scans(terms, torch.mul, torch.ones_like(terms[0]))
    return [p * s for p, s in zip(prefix, suffix)]


def _not_converged_mask(v: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """Per-batch-lane 'not converged': some nonzero message strictly inside
    (low, high).  NaN messages fail both compares, so count as converged.
    The bounds are rounded to float32 first (as JAX does), so the compare is
    the same whether PyTorch runs it in float32 or float64; they stay Python
    scalars, because a tensor made on a GPU from a host value costs a
    blocking copy."""
    low, high = float(np.float32(low)), float(np.float32(high))
    inside = (v != 0.0) & (v > low) & (v < high)
    return inside.any(dim=0)


def cn_update(graph: CirculantGraph | LiftedGraph, v: torch.Tensor,
              syndrome_sign_half: torch.Tensor) -> torch.Tensor:
    """Check-node update.  v, result: check-indexed (num_edges, batch);
    ``syndrome_sign_half`` = 0.5 - syndrome per edge row (+-0.5)."""
    t = graph.cn_view(1.0 - 2.0 * v)                    # (B, L, P*batch)
    loo = _loo_products([t[:, i] for i in range(graph.check_degree)])
    prod = torch.stack(loo, dim=1).reshape(v.shape)
    return 0.5 - syndrome_sign_half * prod


def vn_update(graph: CirculantGraph | LiftedGraph, e: torch.Tensor,
              prior: torch.Tensor, last: bool) -> torch.Tensor:
    """Variable-node update.  e: check-indexed; returns check-indexed v.
    ``last`` includes the own-check message, forming the posterior."""
    ev = graph.vn_view(graph.to_var(e))                 # (B, L*P, batch)
    terms_p = [ev[i] for i in range(graph.var_degree)]
    terms_m = [1.0 - ev[i] for i in range(graph.var_degree)]
    if last:
        # full product in ascending-index order (== the last leave-one-out
        # product times the last term), as the JAX code and the kernel do
        full_p = _loo_products(terms_p)[-1] * terms_p[-1]
        full_m = _loo_products(terms_m)[-1] * terms_m[-1]
        prod_p = full_p.expand(graph.var_degree, *full_p.shape)
        prod_m = full_m.expand(graph.var_degree, *full_m.shape)
    else:
        prod_p = torch.stack(_loo_products(terms_p))
        prod_m = torch.stack(_loo_products(terms_m))
    num = prior * prod_p
    den = fma_f32(1.0 - prior, prod_m, num)
    vv = (num / den).reshape(e.shape)
    return graph.to_check(vv)


def bp_run(
    graph: CirculantGraph | LiftedGraph,
    syndrome: torch.Tensor,          # (num_checks, batch) in {0, 1}
    prior: torch.Tensor | float,     # channel prior (already 2/3-scaled)
    max_iters: int,
    check_every: int = 10,
    conv_low: float = 0.01,
    conv_high: float = 0.99,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run BP for one graph.  Returns ``(v_final, iters_executed)``:
    check-indexed var->check messages (num_edges, batch) f32 and the number
    of iterations the loop ran (0-dim int32 tensor).

    The host reads the done mask only after a convergence test, the one
    place it can change."""
    v, n, _ = _bp_loop(graph, syndrome, prior, max_iters, check_every,
                       conv_low, conv_high)
    return v, n


def bp_run_lanes(
    graph: CirculantGraph | LiftedGraph,
    syndrome: torch.Tensor,
    prior: torch.Tensor | float,
    max_iters: int,
    check_every: int = 10,
    conv_low: float = 0.01,
    conv_high: float = 0.99,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`bp_run` with each lane's own executed iteration count:
    ``(v_final, lane_iters (batch,) int32)``, the iterations in which the
    lane was not yet done.  Lanes decode independently and a done lane is
    frozen, so a lane's count is what :func:`bp_run` gives for the lane run
    alone, and their maximum is the batch run's count.  The reference the
    sum-product kernel's per-lane ``iters`` is held to."""
    v, _, lane_iters = _bp_loop(graph, syndrome, prior, max_iters,
                                check_every, conv_low, conv_high)
    return v, lane_iters


def _bp_loop(graph, syndrome, prior, max_iters, check_every, conv_low,
             conv_high):
    """The loop of :func:`bp_run`: ``(v_final, iters_executed, per-lane
    executed iterations)``."""
    batch = syndrome.shape[-1]
    device = syndrome.device
    sign = graph.expand_checks(0.5 - syndrome.to(torch.float32))
    prior = torch.as_tensor(prior, dtype=torch.float32, device=device)
    v = prior.expand(graph.num_edges, batch).clone()
    done = torch.zeros(batch, dtype=torch.bool, device=device)
    lane_iters = torch.zeros(batch, dtype=torch.int32, device=device)
    # the lane-sharded graph's hooks, as in decoder/min_sum.py
    combine_mask = getattr(graph, "combine_lane_mask", None)
    combine_cont = getattr(graph, "combine_continue", None)
    all_done = False
    n = 0
    while n < max_iters and not all_done:
        e = cn_update(graph, v, sign)
        v_new = vn_update(graph, e, prior, last=(n == max_iters - 1))
        v = torch.where(done[None, :], v, v_new)
        lane_iters += ~done
        if n % check_every == 0:
            mask = _not_converged_mask(v, conv_low, conv_high)
            if combine_mask is not None:
                mask = combine_mask(mask)
            done = done | ~mask
            cont = not bool(done.all())
            if combine_cont is not None:
                cont = combine_cont(cont)
            all_done = not cont
        n += 1
    return v, torch.full((), n, dtype=torch.int32, device=device), lane_iters
