"""The quantum QC-LDPC CSS code object.

Capability parity with ``Quantum_LDPC_Code`` (``Quantum_LDPC_Code.h:7-150``):
parameters, parity-check matrices, syndrome computation, logical-error test,
and the ``[J=..][[n=..,k=..]]`` pretty-printing used for result-file naming
(``Quantum_LDPC_Code.h:145-150``).

Design difference from the reference: the primary representation is the
pair of exponent tables (J x L), (K x L) over Z_P — dense matrices are
derived, cached, and only used off the hot path (tests, logical check,
exports).  The port's copy of ``qec_ldpc_tpu/codes/css.py``.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

from qec_ldpc_tpu_torch.codes import construction


@dataclasses.dataclass(frozen=True)
class QuantumLDPCCode:
    J: int
    K: int
    L: int
    P: int
    sigma: int
    tau: int
    #: exponent tables: hc (J x L), hd (K x L), entries in [0, P)
    hc: np.ndarray = dataclasses.field(repr=False)
    hd: np.ndarray = dataclasses.field(repr=False)
    #: optional file-shipped matrices (kept for bit-parity checks); if None
    #: they are derived from the exponent tables / GF(2) algebra on demand.
    _pcm_x: np.ndarray | None = dataclasses.field(default=None, repr=False)
    _pcm_z: np.ndarray | None = dataclasses.field(default=None, repr=False)
    _i_minus_p: np.ndarray | None = dataclasses.field(default=None, repr=False)

    # -- derived sizes (ref Quantum_LDPC_Code.h:82-85) --
    @property
    def n(self) -> int:
        return self.L * self.P

    @property
    def num_eqs_x(self) -> int:
        return self.J * self.P

    @property
    def num_eqs_z(self) -> int:
        return self.K * self.P

    @property
    def k_logical(self) -> int:
        """The 'k' the reference prints: numEqsZ - numEqsX (Quantum_LDPC_Code.h:148)."""
        return self.num_eqs_z - self.num_eqs_x

    @cached_property
    def pcm_x(self) -> np.ndarray:
        if self._pcm_x is not None:
            return self._pcm_x
        return construction.expand_circulant(self.hc, self.P)

    @cached_property
    def pcm_z(self) -> np.ndarray:
        if self._pcm_z is not None:
            return self._pcm_z
        return construction.expand_circulant(self.hd, self.P)

    @cached_property
    def i_minus_p(self) -> np.ndarray:
        if self._i_minus_p is not None:
            return self._i_minus_p
        return construction.build_i_minus_p(self.pcm_x, self.pcm_z)

    @cached_property
    def i_minus_p_physical(self) -> np.ndarray:
        """Physically-correct logical-test matrix diag(ann(pcm_z), ann(pcm_x)).

        The reference's file-shipped ``iMinusP`` (reproduced by
        :attr:`i_minus_p`) annihilates the DETECTING matrix of each sector:
        a residual x-error counts as harmless iff it lies in
        rowspace(pcm_x).  Physically, x-errors are detected by Z-type
        stabilizers (pcm_x) but are stabilizer-equivalent iff they lie in the
        rowspace of the X-TYPE stabilizers — the opposite matrix, pcm_z.
        Verified on both shipped codes: a row of pcm_z (a genuine X-type
        stabilizer, zero x-syndrome) is classified LOGICAL by the reference
        convention and harmless by this one — i.e. the reference OVERCOUNTS
        logical errors.  Kept non-default for golden-corpus parity; select
        with ``logical_test=physical`` in the harness (codes/bicycle.py uses
        the physical convention unconditionally)."""
        return construction.build_i_minus_p(self.pcm_z, self.pcm_x)

    # -- reference-compatible math (NumPy; jnp versions live in decoder/) --

    def syndrome_x(self, errors: np.ndarray) -> np.ndarray:
        """Dense mod-2 syndrome (ref Quantum_LDPC_Code.h:94-108). errors: (..., n)."""
        return np.asarray(errors) @ self.pcm_x.T.astype(np.int64) % 2

    def syndrome_z(self, errors: np.ndarray) -> np.ndarray:
        return np.asarray(errors) @ self.pcm_z.T.astype(np.int64) % 2

    def check_logical_error(self, errors_2n: np.ndarray) -> np.ndarray:
        """True where the doubled residual [ex; ez] has a logical component
        (ref Quantum_LDPC_Code.h:126-142: any row of iMinusP @ e odd)."""
        prod = np.asarray(errors_2n) @ self.i_minus_p.T.astype(np.int64) % 2
        return prod.any(axis=-1)

    def __str__(self) -> str:
        # exact format of operator<< (Quantum_LDPC_Code.h:145-150)
        return (
            f"[J={self.J},K={self.K},L={self.L},P={self.P}"
            f",s={self.sigma},t={self.tau}]"
            f"[[n={self.n},k={self.k_logical}]]"
        )


def construct_code(J: int, K: int, L: int, P: int, sigma: int, tau: int) -> QuantumLDPCCode:
    """Programmatic construction from the circulant spec (ref QEC_LDPC_CSS.cu:26-131)."""
    hc, hd = construction.build_exponent_tables(J, K, L, P, sigma, tau)
    return QuantumLDPCCode(J=J, K=K, L=L, P=P, sigma=sigma, tau=tau, hc=hc, hd=hd)


def exponents_from_pcm(pcm: np.ndarray, B: int, L: int, P: int) -> np.ndarray:
    """Recover the exponent table from a dense PCM of circulant permutation blocks.

    Row b*P of block-row b has its 1 in block-col l at column c + l*P, c = table[b,l]
    (inverse of construction.expand_circulant with r = 0).
    Raises if the matrix is not in exact circulant-permutation form.
    """
    table = np.zeros((B, L), dtype=np.int64)
    for b in range(B):
        row0 = pcm[b * P]
        for l in range(L):
            block = row0[l * P : (l + 1) * P]
            ones = np.nonzero(block)[0]
            if ones.size != 1:
                raise ValueError(f"block ({b},{l}) top row has {ones.size} ones")
            table[b, l] = ones[0]
    # verify every row, not just r=0
    if not np.array_equal(construction.expand_circulant(table, P), pcm % 2):
        raise ValueError("PCM is not a circulant-permutation block matrix")
    return table
