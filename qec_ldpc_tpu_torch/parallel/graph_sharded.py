"""Tanner-graph-sharded BP on circulant codes: block columns split across
the ``graph`` axis of a mesh (PyTorch).

The port of ``qec_ldpc_tpu/parallel/graph_sharded.py``.  Both parity-check
matrices of a QC-CSS code are B x L grids of P x P circulants over one
block-column (variable) axis; rank g of a graph group of G owns block
columns [g*Lc, (g+1)*Lc), Lc = L/G, of both graphs:

  * variable-node updates are local: every message a variable takes lives on
    the rank that owns its column;
  * the check-node update of a check's L edges factors into a leave-one-out
    over the rank's Lc columns and the other ranks' per-check partials, which
    one all_gather over ``graph`` exchanges each iteration (B per layered
    sweep).

A rank keeps its edges as (Lc*B*P, batch) rows in (l, b) block order (the
JAX engine's order, not the single-device (b, l) order) and routes by index
tensors built from its (B, Lc) exponent sub-table (:class:`ShardRouter`).

Every rank of a graph group holds the same syndromes and reads the same
loop-exit flag (a max over ``graph``), so the group runs its loops in
lockstep, as the all_gathers require.  Each loop also counts the
iterations every lane ran before it was done; :func:`lane_iterations` says
which count a decode reports.  Per decode:

  * min-sum — the cross-shard reductions (min, +-1 product) are exact under
    any association, so it is bit for bit the single-device decode.  The
    undamped loop runs through K8 (kernels/sharded_step_cuda.py): per
    iteration one all_gather, the other-shards combine, one step and, every
    ``check_every`` iterations, the convergence flag; the damped relay loop
    runs the same body as torch ops;
  * layered min-sum — bit for bit the single-device decode too;
  * sum-product — the cross-shard product reassociates the single-device
    one, so it agrees statistically; it is bit for bit the JAX engine.

Only circulant graphs: lifted codes shard their lift group's lanes instead
(``parallel/lifted_sharded.py``).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from qec_ldpc_tpu_torch.decoder.decode import (
    ALGORITHMS,
    CodeGraphs,
    edge_soft,
    error_code,
)
from qec_ldpc_tpu_torch.decoder.layout import CirculantGraph
from qec_ldpc_tpu_torch.decoder.min_sum import (
    _not_converged_mask_llr,
    _sign,
    damped_blend,
    f32,
    np_log_band,
    prior_llr,
)
from qec_ldpc_tpu_torch.decoder.sum_product import (
    BPConfig,
    _not_converged_mask,
    exclusive_scans,
    fma_f32,
)
from qec_ldpc_tpu_torch.kernels import sharded_step_cuda
from qec_ldpc_tpu_torch.parallel.mesh import GRAPH_AXIS, Mesh


class ShardRouter:
    """Routing of shard ``g`` of ``G`` of a circulant graph: its ``Lc``
    block columns' exponent sub-table ``table`` (B, Lc), with
    ``table[b, l] = C[b, g*Lc + l]``, and cached index tensors that move its
    (Lc*B*P, batch) edge rows between check order (lane r of block (l, b) is
    check (b, r)) and var order (lane q is variable (l, q)).  The ``layer_*``
    routings restrict to one block row b: (Lc*P, batch) slabs."""

    def __init__(self, graph: CirculantGraph, G: int, g: int):
        if graph.L % G:
            raise ValueError(f"graph axis size {G} must divide L={graph.L}")
        self.B, self.P, self.G, self.g = graph.B, graph.P, G, g
        self.Lc = graph.L // G
        self.table = np.ascontiguousarray(
            graph.table[:, g * self.Lc:(g + 1) * self.Lc] % graph.P)
        self._index: dict = {}

    def index(self, name: str, device: torch.device, layer: int | None = None
              ) -> torch.Tensor:
        """Row index ``name`` ("to_var", "to_check" or "var_of_edge") over
        all blocks, or over block row ``layer``'s Lc blocks."""
        key = (name, layer, torch.device(device))
        idx = self._index.get(key)
        if idx is None:
            B, P, Lc = self.B, self.P, self.Lc
            shifts = (self.table.T if layer is None
                      else self.table[layer][:, None]).reshape(-1)  # (l, b)
            q = np.arange(P)
            base = np.arange(shifts.size)[:, None] * P
            if name == "to_var":      # out[q] = in[(q - C) % P]
                rows = base + (q - shifts[:, None]) % P
            elif name == "to_check":  # out[r] = in[(r + C) % P]
                rows = base + (q + shifts[:, None]) % P
            elif name == "var_of_edge":  # l*P + (C + r) % P
                cols = np.arange(shifts.size) // (B if layer is None else 1)
                rows = cols[:, None] * P + (q + shifts[:, None]) % P
            else:
                raise ValueError(f"unknown routing index {name!r}")
            idx = torch.as_tensor(rows.reshape(-1), dtype=torch.int64,
                                  device=device)
            self._index[key] = idx
        return idx

    def to_var(self, x: torch.Tensor) -> torch.Tensor:
        return x.index_select(0, self.index("to_var", x.device))

    def to_check(self, x: torch.Tensor) -> torch.Tensor:
        return x.index_select(0, self.index("to_check", x.device))

    def layer_to_var(self, b: int, x: torch.Tensor) -> torch.Tensor:
        return x.index_select(0, self.index("to_var", x.device, b))

    def layer_to_check(self, b: int, x: torch.Tensor) -> torch.Tensor:
        return x.index_select(0, self.index("to_check", x.device, b))

    def expand_vars(self, x: torch.Tensor) -> torch.Tensor:
        """Local per-variable values (Lc*P, batch) -> check-indexed per-edge
        rows (Lc*B*P, batch): each edge takes its variable's value."""
        return x.index_select(0, self.index("var_of_edge", x.device))


def _other_device_product(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """Product of every other graph shard's per-check partials, in shard
    order; our own slot is JAX's masked 1 (x * 1 is x exactly, so it is
    skipped).  One all_gather."""
    gathered = mesh.all_gather(local, GRAPH_AXIS)
    me = mesh.rank(GRAPH_AXIS)
    out = torch.ones_like(local)
    for i in range(gathered.shape[0]):
        if i != me:
            out = out * gathered[i]
    return out


def _other_from_partials(mesh: Mesh, part: torch.Tensor) -> torch.Tensor:
    """(min; sign) over every other graph shard from the packed local
    partials (2*R, batch): one all_gather; min and +-1 product in shard
    order, our own slot JAX's masked (inf, 1), an identity, so skipped."""
    gathered = mesh.all_gather(part, GRAPH_AXIS)
    me = mesh.rank(GRAPH_AXIS)
    rows = part.shape[0] // 2
    omin = torch.full_like(part[:rows], math.inf)
    osgn = torch.ones_like(part[rows:])
    for i in range(gathered.shape[0]):
        if i != me:
            omin = torch.minimum(omin, gathered[i, :rows])
            osgn = osgn * gathered[i, rows:]
    return torch.cat([omin, osgn])


def lane_iterations(lane_iters: torch.Tensor, n: int) -> torch.Tensor:
    """The (batch,) executed iterations a graph-sharded decode reports for
    a loop of ``n`` iterations whose lanes ran ``lane_iters`` each before
    they were done: on a card each lane's own count, as the single-device
    kernels count (K1-K6 exit per lane), so a graph mesh reports what a
    data-only mesh of the same samples does; on the CPU the loop's count
    for every lane, as the plain single-device path and JAX's XLA loops
    do."""
    if lane_iters.is_cuda:
        return lane_iters
    return torch.full_like(lane_iters, n)


def _graph_any(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """(batch,) bool: ``local`` on any rank of the graph group (a max)."""
    return mesh.all_reduce(local.to(torch.int32), "max", GRAPH_AXIS) > 0


def _sharded_min_sum(mesh: Mesh, router: ShardRouter, syndrome: torch.Tensor,
                     llr: float, cfg: BPConfig,
                     damping: torch.Tensor | None = None):
    """Flooding normalized min-sum over the shard's columns.  Returns
    ``(v (Lc*B*P, batch) check-indexed LLRs, iterations, per-lane executed
    iterations)``.

    Undamped, an iteration is one all_gather of the partials, the combine
    and one K8 step, which also forms the next partials.  Damped (relay),
    the partials come from V, the step's update runs as torch ops and is
    blended with V before the done mask (decoder/min_sum.py's rule)."""
    bt = syndrome.shape[-1]
    llr = f32(llr)
    band = np_log_band(cfg.conv_low)
    syn_sign = 1.0 - 2.0 * syndrome.to(torch.float32)
    v = torch.full((router.Lc * router.B * router.P, bt), llr,
                   dtype=torch.float32, device=syndrome.device)
    done = torch.zeros(bt, dtype=torch.bool, device=syndrome.device)
    lane_iters = torch.zeros(bt, dtype=torch.int32, device=syndrome.device)
    part = sharded_step_cuda.local_partials(v, router.Lc)
    n, all_done = 0, False
    while n < cfg.max_iters and not all_done:
        last = n == cfg.max_iters - 1
        other = _other_from_partials(mesh, part)
        if damping is None:
            v, part = sharded_step_cuda.sharded_min_sum_step(
                router, llr, last, syn_sign, other, done, v,
                cfg.min_sum_alpha)
        else:
            v_new = sharded_step_cuda.variable_update(
                router, llr, last, syn_sign, other, v, cfg.min_sum_alpha)
            v = torch.where(done[None, :], v, damped_blend(damping, v, v_new))
            part = sharded_step_cuda.local_partials(v, router.Lc)
        lane_iters += ~done
        if n % cfg.check_every == 0:
            done = done | ~_graph_any(mesh, _not_converged_mask_llr(v, band))
            all_done = bool(done.all())
        n += 1
    return v, n, lane_iters


def _sharded_layered(mesh: Mesh, router: ShardRouter, syndrome: torch.Tensor,
                     llr: float, cfg: BPConfig):
    """Layered normalized min-sum over the shard's columns: per block row b
    (layer) one packed all_gather of its (min; sign) partials, B per sweep.
    Returns ``(q (Lc*P, batch) var-indexed posteriors, sweeps, per-lane
    executed sweeps)``."""
    B, P, Lc = router.B, router.P, router.Lc
    bt = syndrome.shape[-1]
    alpha = f32(cfg.min_sum_alpha)
    syn_sign = 1.0 - 2.0 * syndrome.to(torch.float32)        # (B*P, bt)
    q = torch.full((Lc * P, bt), f32(llr), dtype=torch.float32,
                   device=syndrome.device)
    r = torch.zeros((B * Lc * P, bt), dtype=torch.float32,
                    device=syndrome.device)
    done = torch.zeros(bt, dtype=torch.bool, device=syndrome.device)

    def sweep(q, r):
        r = r.clone()
        for b in range(B):
            sgn_b = syn_sign[b * P:(b + 1) * P]
            tc = router.layer_to_check(b, q).reshape(Lc, P, bt)
            r_b = r[b * Lc * P:(b + 1) * Lc * P].view(Lc, P, bt)
            t = tc - r_b                                      # leave out own
            mags = [t[i].abs() for i in range(Lc)]
            sgns = [_sign(t[i]) for i in range(Lc)]
            pre_m, suf_m = exclusive_scans(mags, torch.minimum,
                                      torch.full_like(mags[0], math.inf))
            pre_s, suf_s = exclusive_scans(sgns, torch.mul,
                                      torch.ones_like(sgns[0]))
            other = _other_from_partials(mesh, torch.cat([
                torch.minimum(pre_m[-1], mags[-1]), pre_s[-1] * sgns[-1]]))
            omin, osgn = other[:P], other[P:]
            r_new = torch.stack([
                alpha * sgn_b * (pre_s[i] * suf_s[i] * osgn)
                * torch.minimum(torch.minimum(pre_m[i], suf_m[i]), omin)
                for i in range(Lc)])
            q = router.layer_to_var(b, (t + r_new).reshape(Lc * P, bt))
            r_b.copy_(r_new)
        return q, r

    def satisfied(q):
        """The hard decision satisfies the syndrome: per block row the sign
        product parity of the local columns, summed over the graph group
        mod 2 (one all_reduce)."""
        d_sign = torch.where(q <= 0.0, -1.0, 1.0)
        rows = []
        for b in range(B):
            blk = router.layer_to_check(b, d_sign).reshape(Lc, P, bt)
            parity = blk[0]
            for i in range(1, Lc):
                parity = parity * blk[i]
            rows.append(parity)
        bits = (torch.stack(rows) < 0).to(torch.int32)       # (B, P, bt)
        total = mesh.all_reduce(bits, "sum", GRAPH_AXIS)
        gsign = 1.0 - 2.0 * (total % 2).to(torch.float32)
        return (gsign == syn_sign.view(B, P, bt)).all(dim=1).all(dim=0)

    ce = cfg.layered_check_every
    lane_iters = torch.zeros(bt, dtype=torch.int32, device=syndrome.device)
    n, all_done = 0, False
    while n < cfg.max_iters and not all_done:
        q_new, r_new = sweep(q, r)
        q = torch.where(done[None, :], q, q_new)
        r = torch.where(done[None, :], r, r_new)
        lane_iters += ~done
        if n % ce == ce - 1:
            done = done | satisfied(q)
            all_done = bool(done.all())
        n += 1
    return q, n, lane_iters


def _sharded_bp(mesh: Mesh, router: ShardRouter, syndrome: torch.Tensor,
                prior: np.float32, cfg: BPConfig):
    """Flooding sum-product over the shard's columns: one all_gather of the
    per-check partial products per iteration.  Returns ``(v (Lc*B*P,
    batch) check-indexed probabilities, iterations, per-lane executed
    iterations)``."""
    B, P, Lc = router.B, router.P, router.Lc
    bt = syndrome.shape[-1]
    device = syndrome.device
    sgn_half = (0.5 - syndrome.to(torch.float32)).reshape(B, P * bt)
    prior_t = torch.full((), float(prior), dtype=torch.float32, device=device)
    v = torch.full((Lc * B * P, bt), float(prior), dtype=torch.float32,
                   device=device)
    done = torch.zeros(bt, dtype=torch.bool, device=device)

    def cn(v):
        t = (1.0 - 2.0 * v).reshape(Lc, B, P * bt)
        pre, suf = exclusive_scans([t[i] for i in range(Lc)], torch.mul,
                              torch.ones_like(t[0]))
        other = _other_device_product(mesh, pre[-1] * t[-1])
        loo = torch.stack([pre[i] * suf[i] for i in range(Lc)])
        return (0.5 - sgn_half[None] * (other[None] * loo)).reshape(-1, bt)

    def vn(e, last):
        ev = router.to_var(e).reshape(Lc, B, P * bt)
        terms_p = [ev[:, i] for i in range(B)]
        terms_m = [1.0 - ev[:, i] for i in range(B)]
        ones = torch.ones_like(terms_p[0])
        pre_p, suf_p = exclusive_scans(terms_p, torch.mul, ones)
        pre_m, suf_m = exclusive_scans(terms_m, torch.mul, ones)
        outs = []
        for i in range(B):
            if last:
                prod_p = pre_p[-1] * terms_p[-1]
                prod_m = pre_m[-1] * terms_m[-1]
            else:
                prod_p = pre_p[i] * suf_p[i]
                prod_m = pre_m[i] * suf_m[i]
            num = prior_t * prod_p
            # XLA on the CPU contracts the denominator into one fma
            outs.append(num / fma_f32(1.0 - prior_t, prod_m, num))
        return router.to_check(torch.stack(outs, dim=1).reshape(-1, bt))

    lane_iters = torch.zeros(bt, dtype=torch.int32, device=device)
    n, all_done = 0, False
    while n < cfg.max_iters and not all_done:
        v_new = vn(cn(v), last=(n == cfg.max_iters - 1))
        v = torch.where(done[None, :], v, v_new)
        lane_iters += ~done
        if n % cfg.check_every == 0:
            nc = _not_converged_mask(v, cfg.conv_low, cfg.conv_high)
            done = done | ~_graph_any(mesh, nc)
            all_done = bool(done.all())
        n += 1
    return v, n, lane_iters


def _reencode_mismatch(mesh: Mesh, router: ShardRouter,
                       decisions: torch.Tensor,
                       syndrome: torch.Tensor) -> torch.Tensor:
    """(batch,) True where the decisions' re-encoded syndrome mismatches:
    the local columns' per-check sums, summed over the graph group (one
    all_reduce), mod 2."""
    bt = syndrome.shape[-1]
    contrib = router.expand_vars(decisions.to(torch.int32))
    partial = contrib.reshape(router.Lc, -1).sum(dim=0, dtype=torch.int32)
    total = mesh.all_reduce(partial, "sum", GRAPH_AXIS)
    return ((total % 2).reshape(-1, bt) != syndrome).any(dim=0)


def _decode_one_graph_sharded(mesh: Mesh, router: ShardRouter,
                              syndrome: torch.Tensor, prior: np.float32,
                              cfg: BPConfig, want_soft: bool = False):
    """Local decisions and flags for one graph: ``(decisions (Lc*P, batch)
    int8 var order, conv_fail (batch,), syn_fail (batch,), iterations,
    reported lane-iterations (batch,) (:func:`lane_iterations`), soft)``.
    ``soft`` is None unless ``want_soft``; then the local
    variables' soft outputs (Lc*P, batch) by decoder/decode.py's
    ``edge_soft``, block row 0 first (layered min-sum's posterior q):
    min-sum's and layered min-sum's bit for bit the single-device ones."""
    B, P, Lc = router.B, router.P, router.Lc
    bt = syndrome.shape[-1]
    conv_fail = soft = None
    if cfg.algorithm == "layered-min-sum":
        q, iters, lanes = _sharded_layered(mesh, router, syndrome,
                                           prior_llr(prior), cfg)
        # layered: "failed to converge" is "the decision violates the
        # syndrome", as in decoder/decode.py
        decisions = (q <= 0.0).reshape(Lc * P, bt)
    elif cfg.algorithm == "min-sum":
        v, iters, lanes = _sharded_min_sum(mesh, router, syndrome,
                                           prior_llr(prior), cfg)
        vv = router.to_var(v).reshape(Lc, B, P, bt)
        decisions = (vv <= 0.0).any(dim=1).reshape(Lc * P, bt)
        conv_fail = _graph_any(mesh, _not_converged_mask_llr(
            v, np_log_band(cfg.conv_low)))
    else:
        v, iters, lanes = _sharded_bp(mesh, router, syndrome, prior, cfg)
        vv = router.to_var(v).reshape(Lc, B, P, bt)
        decisions = (vv >= cfg.hard_threshold).any(dim=1).reshape(Lc * P, bt)
        conv_fail = _graph_any(mesh, _not_converged_mask(v, cfg.conv_low,
                                                         cfg.conv_high))
    if want_soft:
        # layered's q is the posterior; the others sum their edge LLRs
        soft = (q if cfg.algorithm == "layered-min-sum"
                else edge_soft(vv.transpose(0, 1), cfg).reshape(Lc * P, bt))
    syn_fail = _reencode_mismatch(mesh, router, decisions, syndrome)
    if conv_fail is None:
        conv_fail = syn_fail
    return (decisions.to(torch.int8), conv_fail, syn_fail, iters,
            lane_iterations(lanes, iters), soft)


def _relay_one_graph_sharded(mesh: Mesh, router: ShardRouter,
                             syndrome: torch.Tensor, llr: float,
                             cfg: BPConfig,
                             gammas: Callable[[int], torch.Tensor],
                             decisions0: torch.Tensor, solved0: torch.Tensor,
                             retries: int):
    """The graph-sharded relay retries (decoder/relay.py's rules): retry r
    damps the rank's own variables by ``gammas(r)`` (Lc*P, batch); a lane
    is repaired when a retry's decision re-encodes to its syndrome.
    Returns ``(decisions, solved, iterations, lane-iterations)``, the
    retries' executed loop iterations and their reported lane-iterations
    (batch,) (:func:`lane_iterations`).  ``solved`` is the same on every
    rank of the graph group, so the group takes the same number of
    retries."""
    Lc, P, B = router.Lc, router.P, router.B
    bt = syndrome.shape[-1]
    decisions, solved = decisions0, solved0
    trip_iters, r = 0, 0
    lanes = torch.zeros(bt, dtype=torch.int32, device=syndrome.device)
    while r < retries and not bool(solved.all()):
        damping = router.expand_vars(gammas(r))
        s_eff = torch.where(solved[None, :], 0, syndrome)
        v, it, lane_iters = _sharded_min_sum(mesh, router, s_eff, llr, cfg,
                                             damping)
        vv = router.to_var(v).reshape(Lc, B, P, bt)
        d_new = (vv <= 0.0).any(dim=1).reshape(Lc * P, bt).to(decisions.dtype)
        newly = ~_reencode_mismatch(mesh, router, d_new, syndrome) & ~solved
        decisions = torch.where(newly[None, :], d_new, decisions)
        solved = solved | newly
        trip_iters += it
        lanes = lanes + lane_iterations(lane_iters, it)
        r += 1
    return decisions, solved, trip_iters, lanes


def routers(mesh: Mesh, graphs: CodeGraphs) -> tuple[ShardRouter, ShardRouter]:
    """This rank's X and Z shard routers; raises unless both graphs are
    circulant and the graph axis divides L."""
    if not isinstance(graphs.x, CirculantGraph):
        raise ValueError(
            "the block-column engine is for circulant QC codes; decode "
            "lifted codes with lifted_sharded.make_lifted_sharded_decoder")
    G, g = mesh.size(GRAPH_AXIS), mesh.rank(GRAPH_AXIS)
    return ShardRouter(graphs.x, G, g), ShardRouter(graphs.z, G, g)


def make_graph_sharded_decoder(mesh: Mesh, graphs: CodeGraphs, cfg: BPConfig):
    """Build this rank's decode over a (data, graph) mesh.

    Returns ``decode(syndrome_x (J*P, batch), syndrome_z (K*P, batch),
    error_probability) -> (decisions_x (n, batch) int8, decisions_z,
    error_code (batch,) int32, iters (2,) int32 on the CPU)``: every rank
    passes its data shard's full syndromes and gets back that shard's
    decisions, gathered over ``graph`` in global variable order, and the X
    and Z loops' iteration counts.  Requires G | L."""
    if cfg.algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {cfg.algorithm!r}")
    if cfg.kernel == "pallas" and cfg.algorithm != "min-sum":
        raise ValueError(
            "the graph-sharded engines only have a fused between-halos "
            "kernel for algorithm='min-sum' (K8); use kernel='xla' for "
            "sum-product / layered-min-sum")
    x_router, z_router = routers(mesh, graphs)

    def decode(syndrome_x, syndrome_z, error_probability):
        prior = np.float32(cfg.prior_factor) * np.float32(error_probability)
        out = [_decode_one_graph_sharded(mesh, router,
                                         syn.to(torch.int32).contiguous(),
                                         prior, cfg)
               for router, syn in ((x_router, syndrome_x),
                                   (z_router, syndrome_z))]
        (dx, cfx, sfx, itx, _, _), (dz, cfz, sfz, itz, _, _) = out
        bt = dx.shape[-1]
        return (mesh.all_gather(dx, GRAPH_AXIS).reshape(-1, bt),
                mesh.all_gather(dz, GRAPH_AXIS).reshape(-1, bt),
                error_code(sfx, sfz, cfx, cfz),
                torch.tensor([itx, itz], dtype=torch.int32))

    return decode
