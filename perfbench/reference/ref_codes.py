"""Frozen copies of the two code constructions, as plain NumPy.

The benchmark builds the parity-check structure of every configuration
itself, from the configuration file, so that the plain reference takes
nothing the program made.  Two families:

  * ``qc``: the Hagiwara-Imai quasi-cyclic CSS codes (arXiv:quant-ph/0701020),
    exponent tables HC (J x L) and HD (K x L) over Z_P, each block a P x P
    circulant permutation;
  * ``bb``: the bivariate bicycle codes (arXiv:2308.07915), H_X = [A | B],
    H_Z = [B^T | A^T], A and B sums of monomials over Z_l x Z_m.

Both are described here as *lifted graphs*: a list of edge blocks (check
block, variable block, shift) over a lift group.  Edge block ``e`` joins
check lane ``r`` of its check block to variable lane ``r + shift`` of its
variable block.  The order of the edge blocks fixes the two orders the
decoders' floating-point reductions run in, and those orders are part of the
arithmetic the benchmark checks:

  * a check's positions are its check block's edge blocks in list order;
  * a variable's ranks are its variable block's edge blocks in list order
    (the list is kept sorted by check block, stably).
"""

from __future__ import annotations

import dataclasses

import numpy as np


# -- the qc family (frozen copy of the construction) --------------------------

def _mod_pow(base: int, exp: int, p: int) -> int:
    if exp >= 0:
        return pow(base, exp, p)
    return pow(pow(base, -1, p), -exp, p)


def qc_tables(J: int, K: int, L: int, P: int, sigma: int, tau: int
              ) -> tuple[np.ndarray, np.ndarray]:
    """(HC, HD): HC[j, l] = sigma^(l-j) for l < L/2, else P - tau*sigma^(j-1+l);
    HD[k, l] = tau*sigma^(l-k-1) for l < L/2, else P - sigma^(k+l); mod P."""
    half = L // 2
    hc = np.zeros((J, L), dtype=np.int64)
    hd = np.zeros((K, L), dtype=np.int64)
    for j in range(J):
        for l in range(L):
            hc[j, l] = (_mod_pow(sigma, l - j, P) if l < half
                        else (P - tau * _mod_pow(sigma, j - 1 + l, P)) % P)
    for k in range(K):
        for l in range(L):
            hd[k, l] = ((tau * _mod_pow(sigma, l - k - 1, P)) % P if l < half
                        else (P - _mod_pow(sigma, k + l, P)) % P)
    return hc % P, hd % P


# -- the bb family (frozen copy of the construction) --------------------------

def monomial(spec: str) -> tuple[int, int]:
    """'x3' -> (3, 0), 'y' -> (0, 1), 'x1y2' -> (1, 2), '1' -> (0, 0)."""
    spec = spec.strip()
    if spec == "1":
        return (0, 0)
    exps = {"x": 0, "y": 0}
    var, digits = None, ""
    for ch in spec + "\0":
        if ch in "xy\0":
            if var is not None:
                exps[var] = int(digits or 1)
            var, digits = ch, ""
        elif ch.isdigit() and var is not None:
            digits += ch
        else:
            raise ValueError(f"bad monomial {spec!r}")
    return (exps["x"], exps["y"])


# -- lifted graphs --------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Tanner:
    """One sector's Tanner graph with the decoders' reduction orders.

    ``var_of[j, c]``: the variable at position j of check c;
    ``check_of[i, v]``: the check at rank i of variable v;
    ``edge_of[i, v]``: that edge's row in the position-major check view
    (``j * num_checks + c``); ``kind``: "circulant" or "lifted", the graph
    class the program decodes it as (it selects the kernel)."""

    var_of: np.ndarray
    check_of: np.ndarray
    edge_of: np.ndarray
    kind: str
    P: int

    @property
    def num_checks(self) -> int:
        return self.var_of.shape[1]

    @property
    def num_vars(self) -> int:
        return self.check_of.shape[1]

    @property
    def check_degree(self) -> int:
        return self.var_of.shape[0]

    @property
    def var_degree(self) -> int:
        return self.check_of.shape[0]

    @property
    def num_edges(self) -> int:
        return self.var_of.size

    def dense(self) -> np.ndarray:
        h = np.zeros((self.num_checks, self.num_vars), dtype=np.uint8)
        for j in range(self.check_degree):
            h[np.arange(self.num_checks), self.var_of[j]] ^= 1
        return h


def lifted(group: tuple[int, ...], num_check_blocks: int,
           num_var_blocks: int, blocks: list, kind: str) -> Tanner:
    """A :class:`Tanner` graph from edge blocks (check block, var block,
    shift); shifts are tuples over ``group`` (lanes flattened row-major)."""
    blocks = sorted(blocks, key=lambda b: b[0])  # stable: list order kept
    P = int(np.prod(group))
    coords = np.unravel_index(np.arange(P), group)

    def lane(shift, sign):
        return np.ravel_multi_index(
            tuple((c + sign * s) % g for c, s, g in zip(coords, shift, group)),
            group)

    per_check = [[b for b in blocks if b[0] == cb] for cb in range(num_check_blocks)]
    per_var = [[b for b in blocks if b[1] == vb] for vb in range(num_var_blocks)]
    dc, dv = len(per_check[0]), len(per_var[0])
    if any(len(x) != dc for x in per_check) or any(len(x) != dv for x in per_var):
        raise ValueError("non-uniform degrees")
    m, n = num_check_blocks * P, num_var_blocks * P
    var_of = np.zeros((dc, m), dtype=np.int64)
    for cb, row in enumerate(per_check):
        for j, (_, vb, s) in enumerate(row):
            var_of[j, cb * P:(cb + 1) * P] = vb * P + lane(s, +1)
    check_of = np.zeros((dv, n), dtype=np.int64)
    edge_of = np.zeros((dv, n), dtype=np.int64)
    for vb, col in enumerate(per_var):
        for i, blk in enumerate(col):
            cb, _, s = blk
            checks = cb * P + lane(s, -1)
            j = per_check[cb].index(blk)
            check_of[i, vb * P:(vb + 1) * P] = checks
            edge_of[i, vb * P:(vb + 1) * P] = j * m + checks
    return Tanner(var_of=var_of, check_of=check_of, edge_of=edge_of,
                  kind=kind, P=P)


@dataclasses.dataclass(frozen=True)
class Code:
    """A CSS code as the benchmark sees it: ``x`` decodes the x-error
    syndrome, ``z`` the z-error syndrome; ``harmless_x`` / ``harmless_z``:
    the matrices whose rowspaces hold the residuals that are no logical
    error."""

    n: int
    x: Tanner
    z: Tanner
    harmless_x: np.ndarray
    harmless_z: np.ndarray


def build_code(cfg: dict) -> Code:
    """The code of a configuration file (``family`` "qc" or "bb")."""
    if cfg["family"] == "qc":
        J, K, L, P = cfg["J"], cfg["K"], cfg["L"], cfg["P"]
        hc, hd = qc_tables(J, K, L, P, cfg["sigma"], cfg["tau"])

        def graph(table):
            B = table.shape[0]
            return lifted((P,), B, L, [(b, l, (int(table[b, l]),))
                                       for b in range(B) for l in range(L)],
                          "circulant")
        gx, gz = graph(hc), graph(hd)
        # the reference's convention: a residual is harmless iff it lies in
        # the rowspace of the sector's own detecting matrix
        hx, hz = gx.dense(), gz.dense()
        return Code(n=L * P, x=gx, z=gz, harmless_x=hx, harmless_z=hz)
    if cfg["family"] == "bb":
        l, m = cfg["l"], cfg["m"]
        a = [monomial(t) for t in cfg["a"].split("+")]
        b = [monomial(t) for t in cfg["b"].split("+")]

        def t(terms):
            return [((-i) % l, (-j) % m) for i, j in terms]

        def norm(terms):
            return [(i % l, j % m) for i, j in terms]

        def graph(col0, col1):
            return lifted((l, m), 1, 2, [(0, 0, s) for s in col0]
                          + [(0, 1, s) for s in col1], "lifted")
        gx = graph(t(b), t(a))          # H_Z = [B^T | A^T] detects x errors
        gz = graph(norm(a), norm(b))    # H_X = [A | B] detects z errors
        # the physical convention: an x residual is harmless iff it lies in
        # the rowspace of the X-type stabilizers H_X
        return Code(n=2 * l * m, x=gx, z=gz, harmless_x=gz.dense(),
                    harmless_z=gx.dense())
    raise ValueError(f"unknown code family {cfg['family']!r}")


def gf2_rref(mat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(basis rows, pivot columns) of the reduced row-echelon form over
    GF(2), zero rows dropped."""
    a = np.asarray(mat, dtype=np.uint8).copy() % 2
    rows, cols = a.shape
    pivots, r = [], 0
    for c in range(cols):
        if r == rows:
            break
        hit = np.flatnonzero(a[r:, c])
        if hit.size == 0:
            continue
        p = r + hit[0]
        a[[r, p]] = a[[p, r]]
        others = np.flatnonzero(a[:, c])
        others = others[others != r]
        a[others] ^= a[r]
        pivots.append(c)
        r += 1
    return a[:r], np.asarray(pivots, dtype=np.int64)
