"""Lane-sharded decode of lifted graphs over the ``graph`` axis of a mesh
(PyTorch).

The port of ``qec_ldpc_tpu/parallel/lifted_sharded.py``: graph parallelism
for the lifted code families (bivariate bicycle, hypergraph-product and
toric codes; codes/bicycle.py, codes/hypergraph.py), which the block-column
engine of ``parallel/graph_sharded.py`` cannot cover, since they have only
two variable blocks.  The sharded dimension is the lift group's first axis:
for the group Z_l x Z_m, rank g of a graph group of G (G | l) owns the band
of rows [g*lc, (g+1)*lc), lc = l/G, of the (l, m) lane grid of every check,
variable and edge block alike, so a block keeps ``P = lc*m`` local lanes.

With the lanes banded this way, both message updates are local: a check row
and all its incident edge lanes live on one rank, and so does a variable's
rank-major column.  Only the routing crosses bands.  JAX moves the rows of
other bands with offset-grouped ``ppermute`` ring shifts; gloo's send and
recv take CPU tensors only, and the tests and one-card runs use gloo, so
here each routing call (``to_var``, ``to_check``, ``expand_vars``,
``syndrome``) is ONE ``all_gather`` over ``graph`` of the whole local
tensor, followed by one ``index_select``: the gathered (G, blocks, lc, m)
bands are read in global (blocks, l, m) order through the global
``LiftedGraph`` index restricted to this rank's output rows, composed into
one index built once per device and cached.  That is ``_roll_many``'s
grouping at G times the bytes, and it is exact: a routing is a permutation.

Collectives, per min-sum or sum-product iteration: two all_gathers (the
variable-node update's ``to_var`` and ``to_check``), plus one all_reduce
per convergence check (``combine_lane_mask``).  A decode adds two
all_gathers (the decisions' ``to_var``, the re-encode's ``syndrome``) and
two all_reduces (the convergence-fail and syndrome-fail flags), and
:func:`make_lifted_sharded_decoder` one all_gather of each graph's
decisions.

Lockstep: the adapter's ``combine_lane_mask`` ORs the convergence mask over
``graph``, so every rank of a graph group holds the same done mask, reads
the same loop-exit flag, and runs the loops of ``decoder/min_sum.py`` and
``decoder/sum_product.py`` (unmodified, through their ``getattr`` hooks) in
lockstep, as the all_gathers require.  ``combine_continue`` ORs the
continue flag over ``graph``; the flag is a function of that done mask, so
the OR is the flag itself and takes no collective, as in the circulant
engine.  JAX also merges the flag over ``data``: that is a rule of XLA's
rendezvous, whose collectives span the whole mesh; the port's span the
graph group only.  Done lanes freeze, so decisions and error codes do not
depend on the trip count, and each data shard runs its own single-device
iteration count.

Rolls are exact permutations and every arithmetic reduction stays local in
the single-device order, so the decode is bit for bit the single-device
plain decode of the data shard, for min-sum and sum-product, and so the
CUDA kernels' (K5, K6), which equal the plain loops lane by lane.  There is
no kernel here, as in JAX (its ``lifted_sharded.py:29-40`` says why): the
engine runs the plain loops as torch ops and refuses ``kernel='pallas'``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from qec_ldpc_tpu_torch.decoder import min_sum, sum_product
from qec_ldpc_tpu_torch.decoder.decode import CodeGraphs, error_code
from qec_ldpc_tpu_torch.decoder.lifted import LiftedGraph
from qec_ldpc_tpu_torch.decoder.min_sum import (
    _not_converged_mask_llr,
    np_log_band,
    prior_llr,
)
from qec_ldpc_tpu_torch.decoder.sum_product import BPConfig, _not_converged_mask
from qec_ldpc_tpu_torch.parallel.graph_sharded import lane_iterations
from qec_ldpc_tpu_torch.parallel.mesh import GRAPH_AXIS, Mesh

#: the algorithms the lane-sharded engine runs
ALGORITHMS = ("min-sum", "sum-product")


class ShardedLiftedGraph:
    """This rank's view of a ``LiftedGraph`` whose (l, m) lane grid is
    band-sharded over the ``graph`` axis of ``mesh`` along l.

    Duck-typed with ``LiftedGraph`` for the plain decoders, every size its
    local value (P -> lc*m), every routing one all_gather over ``graph`` and
    one cached index.  Every rank of the graph group must make the same
    calls in the same order."""

    def __init__(self, base: LiftedGraph, mesh: Mesh):
        if len(base.group) != 2:
            raise ValueError("lane sharding needs a product group (l, m); "
                             "use parallel/graph_sharded.py for Z_P codes")
        G = mesh.size(GRAPH_AXIS)
        l, m = base.group
        if l % G != 0:
            raise ValueError(f"graph axis size {G} must divide l={l}")
        self.base, self.mesh = base, mesh
        self.G, self.g = G, mesh.rank(GRAPH_AXIS)
        self.l, self.m = l, m
        self.lc = l // G
        self.P = self.lc * m  # local lanes per block
        self.num_check_blocks = base.num_check_blocks
        self.num_var_blocks = base.num_var_blocks
        self.check_degree = base.check_degree
        self.var_degree = base.var_degree
        self.num_checks = self.num_check_blocks * self.P
        self.num_vars = self.num_var_blocks * self.P
        self.num_edge_blocks = base.num_edge_blocks
        self.num_edges = self.num_edge_blocks * self.P
        self._index: dict = {}

    # -- the band's rows -------------------------------------------------------

    def band(self) -> slice:
        """This rank's rows of a single check block's global lane axis."""
        return slice(self.g * self.P, (self.g + 1) * self.P)

    def _gathered_rows(self, blocks: int) -> np.ndarray:
        """For each global row (block, L, j) of a ``blocks``-block tensor,
        in global order, its row in the flat all_gather of every rank's
        local (blocks, lc, m) tensor: (L // lc, block, L % lc, j)."""
        b, L, j = np.meshgrid(np.arange(blocks), np.arange(self.l),
                              np.arange(self.m), indexing="ij")
        rows = ((L // self.lc) * blocks + b) * self.P + (L % self.lc) * self.m + j
        return rows.reshape(-1)

    def index(self, name: str, device: torch.device | str) -> torch.Tensor:
        """The local routing index ``name`` ("to_var", "to_check" or
        "var_of_edge") into the flat gathered tensor, on ``device``: the
        global ``LiftedGraph`` index's rows of this rank's band of each
        output block, read through :meth:`_gathered_rows`."""
        device = torch.device(device)
        key = (name, device)
        idx = self._index.get(key)
        if idx is None:
            src_blocks = (self.num_var_blocks if name == "var_of_edge"
                          else self.num_edge_blocks)
            glob = self.base.index(name, "cpu").numpy()
            own = glob.reshape(self.num_edge_blocks, self.l, self.m)[
                :, self.g * self.lc:(self.g + 1) * self.lc, :].reshape(-1)
            idx = torch.as_tensor(self._gathered_rows(src_blocks)[own],
                                  dtype=torch.int64, device=device)
            self._index[key] = idx
        return idx

    def _route(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """One all_gather of ``x`` over ``graph``, then routing ``name``."""
        gathered = self.mesh.all_gather(x, GRAPH_AXIS)
        return gathered.reshape(-1, x.shape[-1]).index_select(
            0, self.index(name, x.device))

    # -- LiftedGraph interface (local shapes) ----------------------------------

    def to_var(self, x: torch.Tensor) -> torch.Tensor:
        return self._route("to_var", x)

    def to_check(self, x: torch.Tensor) -> torch.Tensor:
        return self._route("to_check", x)

    def expand_vars(self, g: torch.Tensor) -> torch.Tensor:
        """Local per-variable rows -> local check-indexed per-edge rows:
        each edge takes its variable's value, from the band that owns it."""
        return self._route("var_of_edge", g)

    def syndrome(self, errors: torch.Tensor) -> torch.Tensor:
        """The local checks' mod-2 syndrome of the banded error rows; each
        check is whole on its rank, so no reduction collective is needed."""
        per_edge = self._route("var_of_edge", errors)
        acc = self.cn_view(per_edge).sum(dim=1, dtype=errors.dtype)
        return acc.reshape(self.num_checks, -1) % 2

    def cn_view(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(self.num_check_blocks, self.check_degree, -1)

    def vn_view(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(self.var_degree, self.num_vars, -1)

    def expand_checks(self, s: torch.Tensor) -> torch.Tensor:
        c_p = s.reshape(self.num_check_blocks, 1, self.P, -1)
        full = c_p.expand(self.num_check_blocks, self.check_degree, self.P,
                          s.shape[-1])
        return full.reshape(self.num_edges, -1)

    # -- the decoder loops' hooks ----------------------------------------------

    def combine_lane_mask(self, mask: torch.Tensor) -> torch.Tensor:
        """OR a per-lane bool over the graph group (one all_reduce)."""
        return self.mesh.all_reduce(mask.to(torch.int32), "max",
                                    GRAPH_AXIS) > 0

    def combine_continue(self, cont: bool) -> bool:
        """OR the loop-continue flag over the graph group.  The loops derive
        it from a done mask that :meth:`combine_lane_mask` made the same on
        every rank of the group, so the OR is the flag itself."""
        return cont

    def reorder(self, d: torch.Tensor) -> torch.Tensor:
        """Local per-variable rows -> the graph group's, gathered (one
        all_gather) and put from (G, VB, lc, m) band order into global
        (VB, l, m) variable order."""
        bt = d.shape[-1]
        gathered = self.mesh.all_gather(d, GRAPH_AXIS)
        return (gathered.reshape(self.G, self.num_var_blocks, self.lc, self.m,
                                 bt)
                .transpose(0, 1).reshape(-1, bt))


def _decode_one(adapter: ShardedLiftedGraph, syndrome: torch.Tensor,
                prior: np.float32, cfg: BPConfig):
    """Local decode of one graph from its band of the syndrome: returns
    ``(decisions (num_vars local, batch) int8, conv_fail (batch,),
    syn_fail (batch,), iterations, reported lane-iterations (batch,))``,
    the flags the graph group's (``graph_sharded.lane_iterations``)."""
    if cfg.algorithm == "min-sum":
        v, iters, lanes = min_sum._min_sum_loop(
            adapter, syndrome, prior_llr(prior), cfg.max_iters,
            cfg.check_every, cfg.conv_low, cfg.min_sum_alpha, None)
        vv = adapter.vn_view(adapter.to_var(v))
        decisions = (vv <= 0.0).any(dim=0)
        conv_fail = adapter.combine_lane_mask(
            _not_converged_mask_llr(v, np_log_band(cfg.conv_low)))
    elif cfg.algorithm == "sum-product":
        v, iters, lanes = sum_product._bp_loop(
            adapter, syndrome, float(prior), cfg.max_iters, cfg.check_every,
            cfg.conv_low, cfg.conv_high)
        vv = adapter.vn_view(adapter.to_var(v))
        decisions = (vv >= cfg.hard_threshold).any(dim=0)
        conv_fail = adapter.combine_lane_mask(
            _not_converged_mask(v, cfg.conv_low, cfg.conv_high))
    else:
        raise ValueError(f"lane-sharded decode supports sum-product/min-sum, "
                         f"not {cfg.algorithm!r}")
    s_hat = adapter.syndrome(decisions.to(torch.int32))
    syn_fail = adapter.combine_lane_mask((s_hat != syndrome).any(dim=0))
    iters = int(iters)
    return (decisions.to(torch.int8), conv_fail, syn_fail, iters,
            lane_iterations(lanes, iters))


def _relay_one_lifted(adapter: ShardedLiftedGraph, syndrome: torch.Tensor,
                      llr: float, cfg: BPConfig,
                      gammas: Callable[[int], torch.Tensor],
                      decisions0: torch.Tensor, solved0: torch.Tensor,
                      retries: int):
    """The lane-sharded relay retries (decoder/relay.py's rules): retry r
    damps this rank's own variable band by ``gammas(r)`` (num_vars local,
    batch), and ``expand_vars`` delivers each edge its variable's
    coefficient from the band that owns it; a lane is repaired when a
    retry's decision re-encodes to its syndrome.  Returns ``(decisions,
    solved, iterations, lane-iterations)``, the retries' executed loop
    iterations and their reported lane-iterations (batch,).  ``solved`` is
    the same on every rank of the group, so the group takes the same
    number of retries."""
    decisions, solved = decisions0, solved0
    trip_iters, r = 0, 0
    lanes = torch.zeros(syndrome.shape[-1], dtype=torch.int32,
                        device=syndrome.device)
    while adapter.combine_continue(r < retries and not bool(solved.all())):
        damping = adapter.expand_vars(gammas(r))
        s_eff = torch.where(solved[None, :], 0, syndrome)
        v, it, lane_iters = min_sum._min_sum_loop(
            adapter, s_eff, llr, cfg.max_iters, cfg.check_every,
            cfg.conv_low, cfg.min_sum_alpha, damping)
        vv = adapter.vn_view(adapter.to_var(v))
        d_new = (vv <= 0.0).any(dim=0).to(decisions.dtype)
        mismatch = adapter.combine_lane_mask(
            (adapter.syndrome(d_new.to(torch.int32)) != syndrome).any(dim=0))
        newly = ~mismatch & ~solved
        decisions = torch.where(newly[None, :], d_new, decisions)
        solved = solved | newly
        trip_iters += int(it)
        lanes = lanes + lane_iterations(lane_iters, int(it))
        r += 1
    return decisions, solved, trip_iters, lanes


def adapters(mesh: Mesh, graphs: CodeGraphs, cfg: BPConfig
             ) -> tuple[ShardedLiftedGraph, ShardedLiftedGraph]:
    """This rank's X and Z adapters.  Raises ``ValueError`` on what the
    lane-sharded engine cannot run: a graph that is not a one-check-block
    ``LiftedGraph`` over a product group whose l the graph axis divides,
    ``kernel='pallas'``, ``return_soft`` and an algorithm other than
    min-sum and sum-product."""
    for g in (graphs.x, graphs.z):
        if not isinstance(g, LiftedGraph):
            raise ValueError("lane sharding is for LiftedGraph codes; use "
                             "make_graph_sharded_decoder for circulant codes")
        if g.num_check_blocks != 1:
            raise ValueError("lane sharding requires one check block "
                             f"(got {g.num_check_blocks}); true for BB and "
                             "HGP codes")
    if cfg.kernel == "pallas":
        raise ValueError(
            "cfg.kernel='pallas' is not supported by the lane-sharded "
            "decoder (it runs the plain loops as torch ops); use "
            "kernel='xla'")
    if cfg.return_soft:
        raise ValueError(
            "cfg.return_soft is not supported by the lane-sharded decoder "
            "(no soft outputs -> no OSD composition); decode with "
            "decode_batch for OSD post-processing")
    if cfg.algorithm not in ALGORITHMS:
        raise ValueError(f"lane-sharded decode supports sum-product/min-sum, "
                         f"not {cfg.algorithm!r}")
    return ShardedLiftedGraph(graphs.x, mesh), ShardedLiftedGraph(graphs.z,
                                                                  mesh)


def decode_full(adapters_xz, cfg: BPConfig, sx: torch.Tensor,
                sz: torch.Tensor, error_probability: float, draws=None,
                relay_retries: int = 0):
    """Lane-sharded X and Z decode of a data shard's full syndromes (global
    check order) [-> relay retries drawing from ``draws``]: returns
    ``(dx, dz, error_code, (X, Z) loop iterations, (X, Z) reported
    lane-iterations)``, the last 0-dim int64 tensors, the decisions gathered
    over ``graph`` in global variable order."""
    prior = np.float32(cfg.prior_factor) * np.float32(error_probability)
    out = []
    for k, adapter, syn in ((0, adapters_xz[0], sx), (1, adapters_xz[1], sz)):
        band = syn[adapter.band()].to(torch.int32).contiguous()
        d, cf, sf, it, lanes = _decode_one(adapter, band, prior, cfg)
        if draws is not None:
            gammas = draws.gammas(k, adapter.num_vars, band.shape[-1])
            d, solved, extra, extra_lanes = _relay_one_lifted(
                adapter, band, prior_llr(prior), cfg, gammas, d, ~sf,
                relay_retries)
            sf, it, lanes = ~solved, it + extra, lanes + extra_lanes
        out.append((adapter.reorder(d), cf, sf, it,
                    lanes.sum(dtype=torch.int64)))
    (dx, cfx, sfx, itx, lx), (dz, cfz, sfz, itz, lz) = out
    return dx, dz, error_code(sfx, sfz, cfx, cfz), (itx, itz), (lx, lz)


def make_lifted_sharded_decoder(mesh: Mesh, graphs: CodeGraphs,
                                cfg: BPConfig):
    """Build this rank's lane-sharded decode over a (data, graph) mesh.

    Returns ``decode(syndrome_x (num_checks, batch), syndrome_z,
    error_probability) -> (decisions_x (n, batch) int8, decisions_z,
    error_code (batch,) int32, iters (2,) int32 on the CPU)``: every rank
    passes its data shard's full syndromes in global check order and gets
    back that shard's decisions, gathered over ``graph`` in global variable
    order, and the X and Z loops' iteration counts.  Requires one check
    block per graph (true for BB and HGP codes) and G | l; raises
    ``ValueError`` on what :func:`adapters` refuses."""
    adapters_xz = adapters(mesh, graphs, cfg)

    def decode(syndrome_x, syndrome_z, error_probability):
        for name, s, g in (("syndrome_x", syndrome_x, graphs.x),
                           ("syndrome_z", syndrome_z, graphs.z)):
            if s.dim() != 2 or s.shape[0] != g.num_checks:
                raise ValueError(
                    f"{name} must be ({g.num_checks}, batch) in GLOBAL "
                    f"check order, got {tuple(s.shape)}")
        if syndrome_z.shape[-1] != syndrome_x.shape[-1]:
            raise ValueError(f"syndrome batch sizes differ: "
                             f"{syndrome_x.shape[-1]} vs "
                             f"{syndrome_z.shape[-1]}")
        dx, dz, code, its, _ = decode_full(adapters_xz, cfg, syndrome_x,
                                           syndrome_z, error_probability)
        return dx, dz, code, torch.tensor(its, dtype=torch.int32)

    return decode
