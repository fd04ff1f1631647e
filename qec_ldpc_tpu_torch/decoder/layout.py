"""Circulant edge-tensor layout for Tanner-graph message passing (PyTorch).

Same layout as ``qec_ldpc_tpu/decoder/layout.py``: every parity-check matrix
is a B x L grid of P x P circulant permutation blocks with exponents
C[b, l], and edge (b, l, r), r in [0, P), joins

    check  b*P + r      and      variable  l*P + (C[b, l] + r) % P.

Messages live in a flat ``(B*L*P, batch)`` tensor, edge rows ordered by
(b, l, lane) with the batch trailing, in one of two lane orders per block:
check-indexed (lane r is check (b, r)) or var-indexed (lane q is var (l, q)).

The TPU layout moves between the orders with static slice+concat rolls,
because its compiler cannot take gathers inside loops.  On a GPU an indexed
gather is cheap, so each routing here is ONE ``index_select`` with an index
tensor built once per device and cached on the graph.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: identity hash
class CirculantGraph:
    """Static message-routing data for one PCM of a QC code."""

    B: int  # number of block rows (J for the X graph, K for the Z graph)
    L: int  # number of block columns (= vars per check, the check degree)
    P: int  # circulant size
    #: exponent table (B, L), entries in [0, P)
    table: np.ndarray
    #: (name, device) -> cached int64 index tensor
    _index: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)

    @staticmethod
    def from_table(table: np.ndarray, P: int) -> "CirculantGraph":
        table = np.asarray(table, dtype=np.int64) % P
        B, L = table.shape
        return CirculantGraph(B=B, L=L, P=P, table=table)

    @property
    def check_degree(self) -> int:
        """Edges per check = block columns."""
        return self.L

    @property
    def var_degree(self) -> int:
        """Edges per variable = block rows."""
        return self.B

    @property
    def num_checks(self) -> int:
        return self.B * self.P

    @property
    def num_vars(self) -> int:
        return self.L * self.P

    @property
    def num_edges(self) -> int:
        return self.B * self.L * self.P

    # -- cached index tensors --------------------------------------------------

    def _roll_index(self, shifts: np.ndarray) -> np.ndarray:
        """Row index of a per-block cyclic roll: out[i*P + q] reads
        in[i*P + (q + s_i) % P] for block i = b*L + l."""
        P = self.P
        q = np.arange(P)
        base = np.arange(self.B * self.L)[:, None] * P
        return (base + (q[None, :] + shifts.reshape(-1, 1)) % P).reshape(-1)

    def index(self, name: str, device: torch.device | str) -> torch.Tensor:
        """The ``(num_edges,)`` int64 routing index ``name`` on ``device``:

        * ``"to_var"``:   check-indexed -> var-indexed, out[q] = in[(q - C) % P]
        * ``"to_check"``: var-indexed -> check-indexed, out[r] = in[(r + C) % P]
        * ``"var_of_edge"``: the variable of each check-indexed edge,
          l*P + (C[b, l] + r) % P
        """
        device = torch.device(device)
        key = (name, device)
        idx = self._index.get(key)
        if idx is None:
            if name == "to_var":
                rows = self._roll_index((-self.table) % self.P)
            elif name == "to_check":
                rows = self._roll_index(self.table)
            elif name == "var_of_edge":
                rows = self._roll_index(self.table) % (self.L * self.P)
            else:
                raise ValueError(f"unknown routing index {name!r}")
            idx = torch.as_tensor(rows, dtype=torch.int64, device=device)
            self._index[key] = idx
        return idx

    # -- routing ---------------------------------------------------------------

    def to_var(self, x: torch.Tensor) -> torch.Tensor:
        """Check-indexed -> var-indexed: out[q] = in[(q - C) % P] per block."""
        return x.index_select(0, self.index("to_var", x.device))

    def to_check(self, x: torch.Tensor) -> torch.Tensor:
        """Var-indexed -> check-indexed: out[r] = in[(r + C) % P] per block."""
        return x.index_select(0, self.index("to_check", x.device))

    # -- graph-structured linear ops -------------------------------------------

    def syndrome(self, errors: torch.Tensor) -> torch.Tensor:
        """Mod-2 syndrome from errors (num_vars, batch) -> (num_checks, batch):
        S[b*P + r] = XOR_l errors[l*P + (C[b, l] + r) % P]."""
        per_edge = errors.index_select(0, self.index("var_of_edge", errors.device))
        acc = self.cn_view(per_edge).sum(dim=1, dtype=errors.dtype)
        return acc.reshape(self.num_checks, -1) % 2

    # -- flat <-> block views (free reshapes: memory is contiguous) ------------

    def cn_view(self, x: torch.Tensor) -> torch.Tensor:
        """(B*L*P, batch) -> (B, L, P*batch) for leave-one-out over L."""
        return x.reshape(self.B, self.L, -1)

    def vn_view(self, x: torch.Tensor) -> torch.Tensor:
        """(B*L*P, batch) -> (B, L*P, batch) for leave-one-out over B."""
        return x.reshape(self.B, self.L * self.P, -1)

    def expand_checks(self, s: torch.Tensor) -> torch.Tensor:
        """Per-check values (B*P, batch) -> per-edge rows (B*L*P, batch),
        replicating each block row's P lanes across its L blocks."""
        b_p = s.reshape(self.B, 1, self.P, -1)
        full = b_p.expand(self.B, self.L, self.P, s.shape[-1])
        return full.reshape(self.num_edges, -1)

    def expand_vars(self, g: torch.Tensor) -> torch.Tensor:
        """Per-variable values (L*P, batch) -> CHECK-indexed per-edge rows
        (B*L*P, batch): each edge takes its variable's value."""
        return g.index_select(0, self.index("var_of_edge", g.device))
