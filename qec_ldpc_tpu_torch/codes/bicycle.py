"""Bivariate bicycle (BB) quantum LDPC codes.

A second CSS model family beyond the reference's Hagiwara–Imai construction
(``QEC_LDPC_CSS.cu:26-131``): the IBM bivariate bicycle codes
(arXiv:2308.07915 — the "gross code" [[144,12,12]] family).  Where the
reference family's PCM blocks are single P x P circulant permutations, BB
blocks are SUMS of monomial permutations over the product group Z_l x Z_m:

    A = x^{i1} y^{j1} + x^{i2} y^{j2} + x^{i3} y^{j3}   (weight-3 typical)
    B = likewise,  with x = shift (1,0), y = shift (0,1) on Z_l x Z_m

    H_X = [A | B]          (lm x 2lm)  — X-type stabilizers
    H_Z = [B^T | A^T]      (lm x 2lm)  — Z-type stabilizers

CSS orthogonality H_X H_Z^T = AB + BA = 0 holds automatically because the
group algebra of Z_l x Z_m is commutative.

These codes map onto the port's lifted-graph layout
(:class:`qec_ldpc_tpu_torch.decoder.lifted.LiftedGraph`): one check block
row, two var blocks, one edge block per monomial, lift group (l, m) — so
flooding sum-product and min-sum (the lifted CUDA kernels), relay retries
and the Monte-Carlo loop run on them unchanged.

The port's copy of ``qec_ldpc_tpu/codes/bicycle.py`` (the same codes, bit
for bit); only the graph classes it builds are the port's.

Convention note (physical, NOT the reference's): X errors are detected by
the Z-type stabilizers (``pcm_x = H_Z``) and a residual X error is harmless
iff it lies in the rowspace of the X-type stabilizers (``H_X``) — so the
logical-test matrix is ``diag(ann(H_X), ann(H_Z))`` with the *opposite*
matrix annihilated relative to ``construction.build_i_minus_p``'s
reference-parity convention (which annihilates the detecting matrix itself,
matching the file-shipped ``iMinusP`` of the reference family, SURVEY §3.4).
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

from qec_ldpc_tpu_torch.codes import construction

Monomial = tuple[int, int]  # (x exponent, y exponent)


@dataclasses.dataclass(frozen=True)
class BicycleCode:
    """A bivariate bicycle CSS code BB(l, m, A, B)."""

    l: int
    m: int
    a_terms: tuple[Monomial, ...]
    b_terms: tuple[Monomial, ...]

    def __post_init__(self):
        object.__setattr__(
            self, "a_terms",
            tuple((int(i) % self.l, int(j) % self.m) for i, j in self.a_terms))
        object.__setattr__(
            self, "b_terms",
            tuple((int(i) % self.l, int(j) % self.m) for i, j in self.b_terms))
        if len(set(self.a_terms)) != len(self.a_terms):
            raise ValueError("duplicate monomials in A")
        if len(set(self.b_terms)) != len(self.b_terms):
            raise ValueError("duplicate monomials in B")

    # -- sizes ---------------------------------------------------------------

    @property
    def group(self) -> tuple[int, int]:
        return (self.l, self.m)

    @property
    def P(self) -> int:
        return self.l * self.m

    @property
    def n(self) -> int:
        return 2 * self.P

    @property
    def num_eqs_x(self) -> int:
        return self.P

    @property
    def num_eqs_z(self) -> int:
        return self.P

    @cached_property
    def k_logical(self) -> int:
        """True k = n - rank(H_X) - rank(H_Z) over GF(2) (the stabilizer
        matrices are rank-deficient by construction)."""
        rx = len(construction.gf2_rref(self.hx_stab)[1])
        rz = len(construction.gf2_rref(self.hz_stab)[1])
        return self.n - rx - rz

    # -- dense stabilizer matrices (tests, OSD, logical algebra) --------------

    def _expand(self, col0: tuple[Monomial, ...], col1: tuple[Monomial, ...]) -> np.ndarray:
        from qec_ldpc_tpu_torch.decoder.lifted import LiftedGraph

        edges = ([(0, 0, s) for s in col0] + [(0, 1, s) for s in col1])
        return LiftedGraph.build(1, 2, self.group, edges).dense_pcm()

    @staticmethod
    def _transpose(terms: tuple[Monomial, ...], l: int, m: int) -> tuple[Monomial, ...]:
        """Transpose of a sum of monomial permutations = negated exponents."""
        return tuple(((-i) % l, (-j) % m) for i, j in terms)

    @cached_property
    def hx_stab(self) -> np.ndarray:
        """X-type stabilizer matrix [A | B] (lm x 2lm)."""
        return self._expand(self.a_terms, self.b_terms)

    @cached_property
    def hz_stab(self) -> np.ndarray:
        """Z-type stabilizer matrix [B^T | A^T] (lm x 2lm)."""
        return self._expand(self._transpose(self.b_terms, self.l, self.m),
                            self._transpose(self.a_terms, self.l, self.m))

    # framework naming: pcm_x is the matrix whose syndrome DETECTS x errors
    # (Quantum_LDPC_Code.h:94-124 semantics) = the Z-type stabilizers
    @property
    def pcm_x(self) -> np.ndarray:
        return self.hz_stab

    @property
    def pcm_z(self) -> np.ndarray:
        return self.hx_stab

    @cached_property
    def i_minus_p(self) -> np.ndarray:
        """Logical-test matrix diag(ann(H_X), ann(H_Z)) over the doubled
        [x; z] space: residual x-error harmless iff in rowspace(H_X),
        residual z-error harmless iff in rowspace(H_Z)."""
        return construction.build_i_minus_p(self.hx_stab, self.hz_stab)

    def check_logical_error(self, errors_2n: np.ndarray) -> np.ndarray:
        """True where the doubled residual [ex; ez] has a logical component
        (same contract as QuantumLDPCCode.check_logical_error)."""
        prod = np.asarray(errors_2n) @ self.i_minus_p.T.astype(np.int64) % 2
        return prod.any(axis=-1)

    # -- graphs ---------------------------------------------------------------

    def build_graphs(self):
        """CodeGraphs with lifted X/Z Tanner graphs: graphs.x decodes the
        x-error syndrome (H_Z graph), graphs.z the z-error syndrome (H_X)."""
        from qec_ldpc_tpu_torch import tracing
        from qec_ldpc_tpu_torch.decoder.decode import CodeGraphs
        from qec_ldpc_tpu_torch.decoder.lifted import LiftedGraph

        def graph(col0, col1):
            edges = ([(0, 0, s) for s in col0] + [(0, 1, s) for s in col1])
            return LiftedGraph.build(1, 2, self.group, edges)

        with tracing.span("setup.graphs"):
            gx = graph(self._transpose(self.b_terms, self.l, self.m),
                       self._transpose(self.a_terms, self.l, self.m))
            gz = graph(self.a_terms, self.b_terms)
            return CodeGraphs(code=self, x=gx, z=gz)

    def __str__(self) -> str:
        a = "+".join(f"x{i}y{j}" for i, j in self.a_terms)
        b = "+".join(f"x{i}y{j}" for i, j in self.b_terms)
        return (f"[BB,l={self.l},m={self.m},A={a},B={b}]"
                f"[[n={self.n},k={self.k_logical}]]")


def _mono(spec: str) -> Monomial:
    """'x3' -> (3, 0); 'y2' -> (0, 2); '1' -> (0, 0); 'x1y2' -> (1, 2).

    Strict: anything but 'x'/'y' heads or digit exponents raises, so a typo
    in a polynomial spec fails loudly instead of silently building the
    constant monomial (and therefore a different code)."""
    spec = spec.strip()
    if spec == "1":
        return (0, 0)
    if not spec or spec[0] not in "xy":
        raise ValueError(f"bad monomial {spec!r}: expected '1', 'x<i>', "
                         f"'y<j>' or 'x<i>y<j>'")
    i = j = 0
    tok = ""
    var = None
    for ch in spec + "\0":
        if ch in "xy\0":
            if var == "x":
                i = int(tok or 1)
            elif var == "y":
                j = int(tok or 1)
            var, tok = ch, ""
        elif ch.isdigit():
            tok += ch
        else:
            raise ValueError(f"bad character {ch!r} in monomial {spec!r}")
    return (i, j)


def bicycle_code(l: int, m: int, a: str, b: str) -> BicycleCode:
    """Construct BB(l, m) from polynomial strings, e.g.
    ``bicycle_code(12, 6, "x3 + y + y2", "y3 + x + x2")`` (the gross code)."""
    return BicycleCode(
        l=l, m=m,
        a_terms=tuple(_mono(t) for t in a.split("+")),
        b_terms=tuple(_mono(t) for t in b.split("+")),
    )


#: Known instances from arXiv:2308.07915 (Table 3), keyed by [[n, k, d]].
KNOWN_CODES: dict[str, tuple[int, int, str, str]] = {
    "[[72,12,6]]": (6, 6, "x3 + y + y2", "y3 + x + x2"),
    "[[90,8,10]]": (15, 3, "x9 + y + y2", "1 + x2 + x7"),
    "[[108,8,10]]": (9, 6, "x3 + y + y2", "y3 + x + x2"),
    "[[144,12,12]]": (12, 6, "x3 + y + y2", "y3 + x + x2"),  # the gross code
    "[[288,12,18]]": (12, 12, "x3 + y2 + y7", "y3 + x + x2"),
    "[[360,12,24]]": (30, 6, "x9 + y + y2", "y3 + x25 + x26"),
    "[[756,16,34]]": (21, 18, "x3 + y10 + y17", "y5 + x3 + x19"),
}


def known_bicycle_code(name: str) -> BicycleCode:
    """Look up a published BB instance by its ``[[n,k,d]]`` label."""
    if name not in KNOWN_CODES:
        raise KeyError(f"unknown BB code {name!r}; have {sorted(KNOWN_CODES)}")
    l, m, a, b = KNOWN_CODES[name]
    return bicycle_code(l, m, a, b)


def lifted_has_4cycles(graph) -> bool:
    """4-cycle test on a lifted graph's edge-block structure, O(E^2).

    Checks (c1, r1) != (c2, r2) share the variable reached through edge
    block ``e`` of c1 iff some edge block ``f`` of c2 in the same var column
    satisfies r1 - r2 = shift_f - shift_e; for a fixed difference d the
    number of distinct shared variables equals the number of distinct ``e``
    with a match, so a 4-cycle exists iff two such ``e`` collide on one d
    (the lifted generalization of codes/analysis.qc_has_4cycles'
    alternating-sum condition; cross-checked against the exact BFS girth in
    tests)."""
    from collections import defaultdict

    C = graph.num_check_blocks
    group = graph.group
    zero = (0,) * len(group)
    by_check: list[list[int]] = [[] for _ in range(C)]
    for e, c in enumerate(graph.check_blocks):
        by_check[c].append(e)
    for c1 in range(C):
        for c2 in range(C):
            matches: dict[tuple[int, ...], set[int]] = defaultdict(set)
            for e in by_check[c1]:
                for f in by_check[c2]:
                    if graph.var_blocks[f] != graph.var_blocks[e]:
                        continue
                    d = tuple((sf - se) % g for sf, se, g in
                              zip(graph.shifts[f], graph.shifts[e], group))
                    if c1 == c2 and d == zero:
                        continue  # same check node
                    matches[d].add(e)
            if any(len(v) >= 2 for v in matches.values()):
                return True
    return False


def find_bicycle_codes(
    l: int,
    m: int,
    count: int = 1,
    min_k: int = 2,
    require_girth6: bool = True,
    max_candidates: int | None = None,
) -> list[BicycleCode]:
    """Search BB(l, m) instances with k >= min_k (the analog of
    construction.find_code_params for the bicycle family).

    Enumerates the common ansatz of arXiv:2308.07915: A = x^a + y^b + y^c
    with 0 < a < l, 0 < b < c < m, and B = y^d + x^e + x^f with 0 < d < m,
    0 < e < f < l.  Most published instances fit it (the exception in
    KNOWN_CODES is [[90,8,10]], whose B = 1 + x^2 + x^7 carries a constant
    term this scan does not enumerate).  ``require_girth6`` rejects Tanner
    graphs with 4-cycles via :func:`lifted_has_4cycles` BEFORE the dense
    GF(2)-rank k test (the 4-cycle test is O(E^2) on the edge blocks; the
    rank is two lm x 2lm eliminations).  Candidates are scanned in
    lexicographic order; ``max_candidates`` bounds the scan.  Sanity anchor:
    find_bicycle_codes(6, 6) recovers the published [[72,12,6]] parameters
    among its hits (asserted in tests)."""
    found: list[BicycleCode] = []
    tried = 0
    for a in range(1, l):
        for b in range(1, m):
            for c in range(b + 1, m):
                for d in range(1, m):
                    for e in range(1, l):
                        for f in range(e + 1, l):
                            if max_candidates is not None and tried >= max_candidates:
                                return found
                            tried += 1
                            code = BicycleCode(
                                l=l, m=m,
                                a_terms=((a, 0), (0, b), (0, c)),
                                b_terms=((0, d), (e, 0), (f, 0)))
                            # cheap structural filter first: H_X has 4-cycles
                            # iff H_Z does (AA^T + BB^T == A^TA + B^TB in the
                            # commutative group algebra), so one graph suffices
                            if require_girth6 and lifted_has_4cycles(
                                    code.build_graphs().z):
                                continue
                            if code.k_logical < min_k:
                                continue
                            found.append(code)
                            if len(found) >= count:
                                return found
    return found
