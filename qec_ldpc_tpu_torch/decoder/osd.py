"""Ordered-statistics decoding (OSD) post-processing for BP failures.

The port of ``qec_ldpc_tpu/decoder/osd.py``.  When BP's hard decision
violates the syndrome, OSD ranks the variables by BP's soft output (smaller
= more likely in error), takes the first linearly independent parity-check
columns in that order and solves ``H_S e_S = s`` exactly over GF(2), which
gives a syndrome-satisfying correction for every decodable syndrome.  The
combination sweep (``lam > 0``) also tries flipping each single and pair of
the first ``lam`` non-pivot columns and keeps the lightest solution.

Routes (:class:`OSDecoder`):

  * ``lam == 0`` (``device="auto"``): :class:`~qec_ldpc_tpu_torch.decoder.
    osd_device.DeviceOSD0` on the tensors' own device — K7 for CUDA tensors,
    its plain version for CPU tensors;
  * ``lam > 0`` or ``device="host"``: the host C++ solver
    (``native/gf2.cpp::qec_osd_batch``, OpenMP over lanes), with the lanes
    copied to the host and the corrections back to their device.

Both give the same OSD-0 corrections bit for bit.  There is no NumPy
fallback: :func:`_osd_one_np` is the single-lane plain version the tests
hold the native solver to.  Pair OSD with an LLR-domain decoder
(``"min-sum"`` or ``"layered-min-sum"``): saturated sum-product messages
flatten the ranking.
"""

from __future__ import annotations

import numpy as np
import torch

from qec_ldpc_tpu_torch import native
from qec_ldpc_tpu_torch.decoder.decode import (
    SYNDROME_FAIL_X,
    SYNDROME_FAIL_Z,
    CodeGraphs,
    DecodeResult,
)
from qec_ldpc_tpu_torch.decoder.osd_device import DeviceOSD0, ranking

#: the JAX package's third value, "device", is what "auto" does here
DEVICES = ("auto", "host")


def _osd_one_np(cols_bits: np.ndarray, syndrome: np.ndarray,
                order: np.ndarray, lam: int) -> tuple[np.ndarray, bool]:
    """Single-lane reference implementation (columns as (n, m) bit rows).

    Mirrors the native solver exactly: incremental RREF basis over reduced
    columns with coefficient tracking, OSD-0 solve, then a weight<=2
    combination sweep over the first ``lam`` non-pivot columns.
    """
    n, m = cols_bits.shape
    basis: list[np.ndarray] = []      # reduced columns, unique pivots
    coef: list[np.ndarray] = []       # expansion over accepted columns
    pivot_of: list[int] = []
    accepted: list[int] = []
    np_coef: list[np.ndarray] = []
    np_col: list[int] = []
    for c in order:
        if len(basis) >= m and len(np_coef) >= lam:
            break
        v = cols_bits[c].copy()
        vc = np.zeros(m, dtype=np.uint8)
        for j, p in enumerate(pivot_of):
            if v[p]:
                v ^= basis[j]
                vc ^= coef[j]
        nz = np.nonzero(v)[0]
        if nz.size == 0:
            if len(np_coef) < lam:
                np_coef.append(vc)
                np_col.append(int(c))
            continue
        p = int(nz[0])
        vc[len(basis)] ^= 1
        for j in range(len(basis)):
            if basis[j][p]:
                basis[j] = basis[j] ^ v
                coef[j] = coef[j] ^ vc
        basis.append(v)
        coef.append(vc)
        pivot_of.append(p)
        accepted.append(int(c))
    s = np.asarray(syndrome, dtype=np.uint8).copy()
    sc = np.zeros(m, dtype=np.uint8)
    for j, p in enumerate(pivot_of):
        if s[p]:
            s ^= basis[j]
            sc ^= coef[j]
    e = np.zeros(n, dtype=np.uint8)
    if s.any():
        return e, False
    best_w, best = int(sc.sum()), (None, None)
    for i in range(len(np_coef)):
        w1 = 1 + int((sc ^ np_coef[i]).sum())
        if w1 < best_w:
            best_w, best = w1, (i, None)
        for j in range(i + 1, len(np_coef)):
            w2 = 2 + int((sc ^ np_coef[i] ^ np_coef[j]).sum())
            if w2 < best_w:
                best_w, best = w2, (i, j)
    for idx in best:
        if idx is not None:
            sc = sc ^ np_coef[idx]
            e[np_col[idx]] = 1
    for j in range(len(basis)):
        if sc[j]:
            e[accepted[j]] = 1
    return e, True


class OSDecoder:
    """Batched OSD solver for one parity-check matrix.

    ``device``: "auto" (OSD-0 on the tensors' device when ``lam == 0``) or
    "host" (always the C++ solver)."""

    def __init__(self, h_dense: np.ndarray, lam: int = 0,
                 device: str = "auto"):
        if device not in DEVICES:
            raise ValueError(f"device must be one of {DEVICES}, got {device!r}")
        if lam < 0:
            raise ValueError(f"lam={lam}")
        self.h = np.ascontiguousarray(np.asarray(h_dense, dtype=np.uint8) % 2)
        self.m, self.n = self.h.shape
        self.lam = int(lam)
        self._dev = None
        if self.lam == 0 and device == "auto":
            self._dev = DeviceOSD0(self.h)
        else:  # (n, w) uint64 packed columns over the m check bits
            self.packed_cols, _ = native.pack_rows(self.h.T)

    def to(self, device: torch.device | str) -> "OSDecoder":
        """Place the device solver's constants on ``device`` now."""
        if self._dev is not None:
            self._dev.to(device)
        return self

    def decode(self, syndromes, reliability) -> tuple[torch.Tensor, torch.Tensor]:
        """syndromes (m, B) 0/1; reliability (n, B): per-variable soft output
        from BP (smaller = more likely in error; only the per-lane ranking
        matters).  Tensors or arrays; arrays are taken as CPU tensors.
        Returns ((n, B) uint8 corrections, (B,) bool solved) on the inputs'
        device."""
        syndromes = torch.as_tensor(syndromes)
        reliability = torch.as_tensor(reliability)
        lanes = torch.arange(syndromes.shape[1], device=syndromes.device)
        return self.decode_lanes(syndromes, reliability, lanes)

    def decode_lanes(self, syndromes: torch.Tensor, reliability: torch.Tensor,
                     lanes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Solve the lanes ``lanes`` (an index tensor) of ``syndromes (m, Bc)``
        and ``reliability (n, Bc)``.  Returns ((n, K) uint8, (K,) bool) on
        their device."""
        if self._dev is not None:
            return self._dev.decode_device(syndromes, reliability, lanes)
        device = syndromes.device
        syn = syndromes.index_select(1, lanes).cpu().numpy()
        order = ranking(reliability.index_select(1, lanes).cpu()).numpy()
        if syn.shape[1] == 0:
            return (torch.zeros((self.n, 0), dtype=torch.uint8, device=device),
                    torch.zeros(0, dtype=torch.bool, device=device))
        packed_syn, _ = native.pack_rows(syn.T)
        e, ok = native.osd_batch(self.packed_cols, self.m, order, packed_syn,
                                 self.lam)
        return (torch.from_numpy(np.ascontiguousarray(e.T)).to(device),
                torch.from_numpy(ok).to(device))


def splice(osd: OSDecoder, decisions: torch.Tensor, error_code: torch.Tensor,
           bit: int, syndrome: torch.Tensor, soft: torch.Tensor,
           failed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve lanes ``failed`` with ``osd`` and put each solved lane's
    correction into ``decisions``, clearing ``bit`` in its error code.
    Returns the new (decisions, error_code)."""
    e, ok = osd.decode_lanes(syndrome, soft, failed)
    decisions = decisions.clone()
    decisions[:, failed] = torch.where(ok[None, :], e.to(decisions.dtype),
                                       decisions[:, failed])
    error_code = error_code.clone()
    error_code[failed] = torch.where(ok, error_code[failed] & ~bit,
                                     error_code[failed])
    return decisions, error_code


class CSSPostprocessor:
    """OSD post-processing pair for a CSS code (X and Z graphs)."""

    def __init__(self, graphs: CodeGraphs, lam: int = 0,
                 device: str = "auto"):
        self.graphs = graphs
        self.x = OSDecoder(graphs.code.pcm_x, lam=lam, device=device)
        self.z = OSDecoder(graphs.code.pcm_z, lam=lam, device=device)

    def to(self, device: torch.device | str) -> "CSSPostprocessor":
        self.x.to(device)
        self.z.to(device)
        return self

    def apply(
        self,
        syndrome_x: torch.Tensor,  # (num_x_checks, batch)
        syndrome_z: torch.Tensor,  # (num_z_checks, batch)
        res: DecodeResult,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Replace the decisions of syndrome-failed lanes with OSD solutions.

        Requires ``res.soft_x/soft_z`` (decode with ``return_soft=True``).
        Returns (decisions_x, decisions_z, error_code) on ``res``'s device
        with SYNDROME_FAIL bits cleared on every lane OSD solved;
        convergence-fail bits keep their meaning.  Finding the failed lanes
        reads the error codes once per sector."""
        if res.soft_x is None or res.soft_z is None:
            raise ValueError("decode with BPConfig(return_soft=True) before OSD")
        dx, dz, ec = res.decisions_x, res.decisions_z, res.error_code
        syndrome_x = torch.as_tensor(syndrome_x, device=ec.device)
        syndrome_z = torch.as_tensor(syndrome_z, device=ec.device)
        failed = torch.nonzero((ec & SYNDROME_FAIL_X) != 0).flatten()
        dx, ec = splice(self.x, dx, ec, SYNDROME_FAIL_X, syndrome_x,
                        res.soft_x, failed)
        failed = torch.nonzero((ec & SYNDROME_FAIL_Z) != 0).flatten()
        dz, ec = splice(self.z, dz, ec, SYNDROME_FAIL_Z, syndrome_z,
                        res.soft_z, failed)
        return dx, dz, ec
