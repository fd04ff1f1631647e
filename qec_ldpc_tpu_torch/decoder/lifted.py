"""Lifted-graph edge-tensor layout (PyTorch): PCM blocks that are sums of
monomial permutations over Z_P or Z_l x Z_m.

The port of ``qec_ldpc_tpu/decoder/lifted.py``, with the same fields, the
same ``build`` and ``from_circulant``, and the same storage orders:

  * the lift group is Z_P (``group=(P,)``) or Z_l x Z_m (``group=(l, m)``);
    edge block ``e`` = (check block, var block, shift) joins check lane
    ``r`` to var lane ``(r + shift) % group``, lanes flattened row-major:
    on (l, m), check lane (r1, r2) meets var lane
    ``((r1 + a) % l) * m + (r2 + b) % m`` for shift (a, b);
  * check-major storage: edge blocks sorted (stably) by check block, Dc
    consecutive blocks per check row, so ``cn_view`` is (C, Dc, P*batch);
  * var-major order (what ``to_var`` produces): position ``i*V + v`` holds
    var block v's rank-i incident edge block, ranks in check-major order,
    so ``vn_view`` is (Dv, V*P, batch) with axis 0 the leave-one-out axis.
    The plain decoders' leave-one-out sums and products run over ranks in
    this order, which fixes their float rounding.

Its interface is duck-typed with ``CirculantGraph`` (``cn_view``,
``vn_view``, ``to_var``, ``to_check``, ``syndrome``, ``expand_checks``,
``expand_vars``, ``check_degree``, ``var_degree``, ``num_edges``,
``num_checks``, ``num_vars``, ``P``), so the plain sum-product and min-sum
run on it unchanged.  The TPU version routes with static per-axis rolls;
here each routing is ONE ``index_select`` with an int64 index built once
per device and cached on the graph.  ``dense_pcm`` stays NumPy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _normalize_shift(shift, group: tuple[int, ...]) -> tuple[int, ...]:
    if isinstance(shift, (int, np.integer)):
        shift = (int(shift),)
    return tuple(int(s) % g for s, g in zip(shift, group, strict=True))


def _neg(shift: tuple[int, ...], group: tuple[int, ...]) -> tuple[int, ...]:
    return tuple((-s) % g for s, g in zip(shift, group))


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: identity hash
class LiftedGraph:
    """Static message-routing data for one lifted (generalized QC) PCM."""

    #: lift group: (P,) for Z_P, (l, m) for Z_l x Z_m
    group: tuple[int, ...]
    num_check_blocks: int
    num_var_blocks: int
    #: edge blocks in check-major order
    check_blocks: tuple[int, ...]
    var_blocks: tuple[int, ...]
    shifts: tuple[tuple[int, ...], ...]
    #: uniform degrees
    check_degree: int
    var_degree: int
    #: var-major order: _var_rank_edges[i*V + v] = check-major edge id of var
    #: block v's rank-i incident edge; _var_pos = its inverse permutation
    _var_rank_edges: tuple[int, ...]
    _var_pos: tuple[int, ...]
    #: (name, device) -> cached int64 index tensor
    _index: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)

    @staticmethod
    def build(
        num_check_blocks: int,
        num_var_blocks: int,
        group: tuple[int, ...] | int,
        edges: list[tuple[int, int, object]],
    ) -> "LiftedGraph":
        """``edges``: (check_block, var_block, shift) triples; shift is an int
        (Z_P) or a tuple matching ``group``.  Stable-sorted into check-major
        order; degrees must come out uniform."""
        if isinstance(group, int):
            group = (group,)
        group = tuple(int(g) for g in group)
        order = sorted(range(len(edges)), key=lambda e: edges[e][0])
        cb = tuple(int(edges[e][0]) for e in order)
        vb = tuple(int(edges[e][1]) for e in order)
        sh = tuple(_normalize_shift(edges[e][2], group) for e in order)
        counts_c = np.bincount(cb, minlength=num_check_blocks)
        counts_v = np.bincount(vb, minlength=num_var_blocks)
        if len(set(counts_c)) != 1:
            raise ValueError(f"non-uniform check degrees {sorted(set(counts_c))}")
        if len(set(counts_v)) != 1:
            raise ValueError(f"non-uniform var degrees {sorted(set(counts_v))}")
        dc, dv = int(counts_c[0]), int(counts_v[0])
        # rank-major var order: for rank i, var blocks 0..V-1
        incident: list[list[int]] = [[] for _ in range(num_var_blocks)]
        for e, v in enumerate(vb):
            incident[v].append(e)
        var_rank_edges = tuple(
            incident[v][i] for i in range(dv) for v in range(num_var_blocks))
        var_pos = [0] * len(cb)
        for p, e in enumerate(var_rank_edges):
            var_pos[e] = p
        return LiftedGraph(
            group=group,
            num_check_blocks=num_check_blocks,
            num_var_blocks=num_var_blocks,
            check_blocks=cb,
            var_blocks=vb,
            shifts=sh,
            check_degree=dc,
            var_degree=dv,
            _var_rank_edges=var_rank_edges,
            _var_pos=tuple(var_pos),
        )

    @staticmethod
    def from_circulant(table: np.ndarray, P: int) -> "LiftedGraph":
        """A CirculantGraph-equivalent lifted graph: block row b, column l,
        shift table[b, l] — the same edge order and var-major layout as
        ``CirculantGraph.from_table(table, P)``."""
        table = np.asarray(table)
        B, L = table.shape
        edges = [(b, l, int(table[b, l])) for b in range(B) for l in range(L)]
        return LiftedGraph.build(B, L, (P,), edges)

    # -- sizes ---------------------------------------------------------------

    @property
    def P(self) -> int:
        return int(np.prod(self.group))

    @property
    def num_checks(self) -> int:
        return self.num_check_blocks * self.P

    @property
    def num_vars(self) -> int:
        return self.num_var_blocks * self.P

    @property
    def num_edge_blocks(self) -> int:
        return len(self.check_blocks)

    @property
    def num_edges(self) -> int:
        return self.num_edge_blocks * self.P

    # -- cached index tensors ------------------------------------------------

    def lanes(self, shift: tuple[int, ...]) -> np.ndarray:
        """(P,) flat lane map r -> (r + shift) % group, row-major."""
        coords = np.unravel_index(np.arange(self.P), self.group)
        return np.ravel_multi_index(
            tuple((c + s) % g for c, s, g in zip(coords, shift, self.group)),
            self.group)

    def index(self, name: str, device: torch.device | str) -> torch.Tensor:
        """The ``(num_edges,)`` int64 routing index ``name`` on ``device``:

        * ``"to_var"``: var-major row ``p*P + q`` reads check-major row
          ``e*P + (q - shift_e) % group`` of edge block e = _var_rank_edges[p]
        * ``"to_check"``: check-major row ``e*P + r`` reads var-major row
          ``_var_pos[e]*P + (r + shift_e) % group``
        * ``"var_of_edge"``: the variable of each check-major edge,
          ``var_blocks[e]*P + (r + shift_e) % group``
        """
        device = torch.device(device)
        key = (name, device)
        idx = self._index.get(key)
        if idx is None:
            P = self.P
            if name == "to_var":
                rows = [e * P + self.lanes(_neg(self.shifts[e], self.group))
                        for e in self._var_rank_edges]
            elif name == "to_check":
                rows = [self._var_pos[e] * P + self.lanes(self.shifts[e])
                        for e in range(self.num_edge_blocks)]
            elif name == "var_of_edge":
                rows = [self.var_blocks[e] * P + self.lanes(self.shifts[e])
                        for e in range(self.num_edge_blocks)]
            else:
                raise ValueError(f"unknown routing index {name!r}")
            idx = torch.as_tensor(np.concatenate(rows), dtype=torch.int64,
                                  device=device)
            self._index[key] = idx
        return idx

    # -- routing ---------------------------------------------------------------

    def to_var(self, x: torch.Tensor) -> torch.Tensor:
        """Check-indexed check-major -> var-indexed var-major (rank-major)."""
        return x.index_select(0, self.index("to_var", x.device))

    def to_check(self, x: torch.Tensor) -> torch.Tensor:
        """Var-indexed var-major -> check-indexed check-major (inverse)."""
        return x.index_select(0, self.index("to_check", x.device))

    # -- graph-structured linear ops -------------------------------------------

    def syndrome(self, errors: torch.Tensor) -> torch.Tensor:
        """Mod-2 syndrome (num_vars, batch) -> (num_checks, batch):
        S[c*P + r] = XOR over the row's edge blocks of
        errors[vb*P + (r + shift) % group]."""
        per_edge = errors.index_select(0, self.index("var_of_edge", errors.device))
        acc = self.cn_view(per_edge).sum(dim=1, dtype=errors.dtype)
        return acc.reshape(self.num_checks, -1) % 2

    # -- flat <-> structured views ---------------------------------------------

    def cn_view(self, x: torch.Tensor) -> torch.Tensor:
        """(num_edges, batch) check-major -> (C, Dc, P*batch)."""
        return x.reshape(self.num_check_blocks, self.check_degree, -1)

    def vn_view(self, x: torch.Tensor) -> torch.Tensor:
        """(num_edges, batch) var-major -> (Dv, V*P, batch), axis 0 =
        incidence rank (the leave-one-out axis)."""
        return x.reshape(self.var_degree, self.num_vars, -1)

    def expand_checks(self, s: torch.Tensor) -> torch.Tensor:
        """Per-check (C*P, batch) -> per-edge check-major (num_edges, batch)."""
        c_p = s.reshape(self.num_check_blocks, 1, self.P, -1)
        full = c_p.expand(self.num_check_blocks, self.check_degree, self.P,
                          s.shape[-1])
        return full.reshape(self.num_edges, -1)

    def expand_vars(self, g: torch.Tensor) -> torch.Tensor:
        """Per-variable (V*P, batch) -> CHECK-indexed per-edge rows: each
        edge takes its variable's value."""
        return g.index_select(0, self.index("var_of_edge", g.device))

    # -- dense export (tests / GF(2) algebra) ------------------------------------

    def dense_pcm(self) -> np.ndarray:
        """Expand to the dense binary PCM (num_checks x num_vars)."""
        P = self.P
        pcm = np.zeros((self.num_checks, self.num_vars), dtype=np.int8)
        idx = np.arange(P)
        for e in range(self.num_edge_blocks):
            tgt = self.lanes(self.shifts[e])
            pcm[self.check_blocks[e] * P + idx, self.var_blocks[e] * P + tgt] ^= 1
        return pcm
