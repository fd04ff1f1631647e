"""Batched LAYERED (serial-schedule) normalized min-sum BP (PyTorch).

The plain PyTorch version of ``qec_ldpc_tpu/decoder/layered.py``, and the
reference the CUDA kernel (kernels/layered_cuda.py) is held against.  A layer
is one block row ``b`` of circulants; its P checks touch each block column's
variables once, so a layer updates in one vectorized step.

State per batch lane:
  * ``q`` — posterior LLRs, var-indexed ``(num_vars, batch)``
  * ``r`` — check->var messages, check-indexed ``(num_edges, batch)``

Per layer ``b`` (one sweep = all ``B`` layers, in order):
  1. ``t[l] = q[var(b, l, r)] - r[b, l]``             (leave out own message)
  2. ``r'[b, l] = alpha * sign * loo_sign(t) * loo_min(|t|)``
  3. ``q[var(b, l, r)] = t[l] + r'[b, l]``;  ``r[b, l] = r'[b, l]``

where ``var(b, l, r) = l*P + (C[b, l] + r) % P``.  Convergence is the
layered criterion: the hard decision ``q <= 0`` satisfies the syndrome,
tested after sweep n with ``n % check_every == check_every - 1``; converged
lanes are frozen.  Bit-exact with the JAX version on the CPU: the same
operations in the same order, and routing is an exact permutation.
"""

from __future__ import annotations

import torch

from qec_ldpc_tpu_torch.decoder.layout import CirculantGraph
from qec_ldpc_tpu_torch.decoder.min_sum import (
    _loo_mins,
    _loo_sign_products,
    _sign,
    f32,
)


def syndrome_satisfied(graph: CirculantGraph, q: torch.Tensor,
                       syn_sign: torch.Tensor) -> torch.Tensor:
    """Per-lane: the hard decision of posteriors ``q`` satisfies the
    syndrome.  Pure sign arithmetic: the parity of check (b, r) is the
    product over l of the decision signs (``q <= 0`` -> -1) of its
    variables, and must equal ``syn_sign`` = 1 - 2*s, (num_checks, batch)."""
    d_sign = torch.where(q <= 0.0, -1.0, 1.0)                 # (num_vars, batch)
    per_edge = d_sign.index_select(0, graph.index("var_of_edge", q.device))
    parity = graph.cn_view(per_edge).prod(dim=1)              # (B, P*batch)
    return (parity.reshape(syn_sign.shape) == syn_sign).all(dim=0)


def layered_sweep(graph: CirculantGraph, q: torch.Tensor, r: torch.Tensor,
                  syn_sign: torch.Tensor, alpha: float):
    """One full iteration: the B block-row layers in order.  Returns new
    ``(q, r)``; the inputs are not modified."""
    B, L, P = graph.B, graph.L, graph.P
    alpha = f32(alpha)
    var_of_edge = graph.index("var_of_edge", q.device)
    q = q.clone()
    r = r.clone()
    rb = r.view(B, L, P, -1)
    for b in range(B):
        rows = var_of_edge[b * L * P:(b + 1) * L * P]
        qc = q.index_select(0, rows).view(L, P, -1)           # check order
        sgn_b = syn_sign[b * P:(b + 1) * P]                   # (P, batch)
        ts = [qc[l] - rb[b, l] for l in range(L)]
        loo_min = _loo_mins([t.abs() for t in ts])
        loo_sgn = _loo_sign_products([_sign(t) for t in ts])
        r_new = torch.stack([alpha * sgn_b * loo_sgn[l] * loo_min[l]
                             for l in range(L)])
        q_new = torch.stack(ts) + r_new
        rb[b] = r_new
        q.index_copy_(0, rows, q_new.reshape(L * P, -1))
    return q, r


def layered_min_sum_run(
    graph: CirculantGraph,
    syndrome: torch.Tensor,          # (num_checks, batch) in {0, 1}
    prior_llr: float,                # float32 channel prior LLR
    max_iters: int,
    check_every: int = 1,
    alpha: float = 0.75,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run layered normalized min-sum.  Returns ``(q_final, iters)``:
    posterior LLRs (num_vars, batch) f32 (not per-edge messages) and the
    number of sweeps run (0-dim int32 tensor).

    ``check_every`` defaults to 1: the parity test is cheap and layered
    decoding converges in a handful of sweeps.  The host reads the done mask
    only after a convergence test."""
    q, n, _ = _layered_loop(graph, syndrome, prior_llr, max_iters,
                            check_every, alpha)
    return q, n


def layered_min_sum_run_lanes(
    graph: CirculantGraph,
    syndrome: torch.Tensor,
    prior_llr: float,
    max_iters: int,
    check_every: int = 1,
    alpha: float = 0.75,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`layered_min_sum_run` with each lane's own executed sweep count:
    ``(q_final, lane_iters (batch,) int32)``, the sweeps in which the lane
    was not yet done.  Lanes decode independently and a done lane is
    frozen, so a lane's count is what :func:`layered_min_sum_run` gives for
    the lane run alone, and their maximum is the batch run's count.  The
    reference the layered kernel's per-lane ``iters`` is held to."""
    q, _, lane_iters = _layered_loop(graph, syndrome, prior_llr, max_iters,
                                     check_every, alpha)
    return q, lane_iters


def _layered_loop(graph, syndrome, prior_llr, max_iters, check_every, alpha):
    """The loop of :func:`layered_min_sum_run`: ``(q_final, sweeps
    executed, per-lane executed sweeps)``."""
    batch = syndrome.shape[-1]
    device = syndrome.device
    syn_sign = 1.0 - 2.0 * syndrome.to(torch.float32)        # (num_checks, batch)
    q = torch.full((graph.num_vars, batch), f32(prior_llr),
                   dtype=torch.float32, device=device)
    r = torch.zeros((graph.num_edges, batch), dtype=torch.float32,
                    device=device)
    done = torch.zeros(batch, dtype=torch.bool, device=device)
    lane_iters = torch.zeros(batch, dtype=torch.int32, device=device)
    all_done = False
    n = 0
    while n < max_iters and not all_done:
        q_new, r_new = layered_sweep(graph, q, r, syn_sign, alpha)
        q = torch.where(done[None, :], q, q_new)
        r = torch.where(done[None, :], r, r_new)
        lane_iters += ~done
        if n % check_every == check_every - 1:
            done = done | syndrome_satisfied(graph, q, syn_sign)
            all_done = bool(done.all())
        n += 1
    return q, torch.full((), n, dtype=torch.int32, device=device), lane_iters
