"""Per-sample outcome classification and counter reduction (PyTorch).

The port of ``qec_ldpc_tpu/sampling/classify.py``, the reference's
classification lattice:

  1. syndrome-fail X / Z counters increment independently;
  2. only if NEITHER syndrome failed, the residual (e + e_hat mod 2) in the
     doubled [x; z] space is tested for a logical component -> logical
     error, else corrected;
  3. convergence-fail X / Z counters increment orthogonally.

The GF(2) products are float32 matmuls of 0/1 values, exact while sums stay
below 2^24 provided the matmul runs in full float32: on a GPU keep
``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default).
:func:`classify_batch_np` is the host (NumPy) mirror, whose logical test
runs through the packed GF(2) matvec of the port's host library (native/).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from qec_ldpc_tpu_torch import native, tracing
from qec_ldpc_tpu_torch.codes import gf2_rref
from qec_ldpc_tpu_torch.decoder.decode import (
    CONVERGENCE_FAIL_X,
    CONVERGENCE_FAIL_Z,
    SYNDROME_FAIL_X,
    SYNDROME_FAIL_Z,
)

# Counter vector layout (see harness/stats.py for the record mapping)
NUM_COUNTERS = 9
(C_TESTED, C_X_TESTED, C_Z_TESTED, C_CORRECTED, C_SYN_X, C_SYN_Z,
 C_LOGICAL, C_CONV_X, C_CONV_Z) = range(NUM_COUNTERS)


class RankBasisTest(NamedTuple):
    """Rank-basis logical-error test: per sector the RREF basis ``G``
    (rank x n) of the harmless rowspace and its pivot columns.  A residual
    ``r`` lies in rowspace(G) iff ``r == G^T r[pivots] (mod 2)``."""

    basis_x: torch.Tensor   # (rank_x, n) int8
    pivots_x: torch.Tensor  # (rank_x,) int64
    basis_z: torch.Tensor   # (rank_z, n) int8
    pivots_z: torch.Tensor  # (rank_z,) int64


def rank_basis_test(space_for_x, space_for_z,
                    device: torch.device | str) -> RankBasisTest:
    """Build a :class:`RankBasisTest` on ``device`` from the two GF(2)
    matrices whose rowspaces define harmless residuals (x, z sector)."""
    gx, px = gf2_rref(space_for_x)
    gz, pz = gf2_rref(space_for_z)
    return RankBasisTest(
        basis_x=torch.as_tensor(gx, dtype=torch.int8, device=device),
        pivots_x=torch.as_tensor(px, dtype=torch.int64, device=device),
        basis_z=torch.as_tensor(gz, dtype=torch.int8, device=device),
        pivots_z=torch.as_tensor(pz, dtype=torch.int64, device=device),
    )


def make_rank_basis_test(code, device: torch.device | str,
                         logical_test: str = "reference") -> RankBasisTest:
    """Rank-basis test equivalent to ``code.i_minus_p`` for any code
    family the port builds.

    * QC-CSS codes (codes/css.py): ``"reference"`` reproduces the shipped
      ``iMinusP`` (x residual harmless iff in rowspace(pcm_x), the
      detecting matrix); ``"physical"`` uses the same-Pauli-type
      stabilizers.
    * Bivariate bicycle and hypergraph-product codes (codes/bicycle.py,
      codes/hypergraph.py) follow the physical convention under either
      name: the sectors are ``hx_stab`` and ``hz_stab``.
    """
    if logical_test not in ("reference", "physical"):
        raise ValueError(f"unknown logical_test {logical_test!r}")
    with tracing.span("setup.logical"):
        if hasattr(code, "hx_stab"):  # lifted families: one convention
            return rank_basis_test(code.hx_stab, code.hz_stab, device)
        if logical_test == "physical":
            return rank_basis_test(code.pcm_z, code.pcm_x, device)
        return rank_basis_test(code.pcm_x, code.pcm_z, device)


def _sector_logical(basis: torch.Tensor, pivots: torch.Tensor,
                    r: torch.Tensor) -> torch.Tensor:
    """(n, batch) residual -> (batch,) bool: r not in rowspace(basis)."""
    coeff = r[pivots].to(torch.float32)                        # (rank, batch)
    recon = basis.T.to(torch.float32) @ coeff                  # (n, batch)
    diff = torch.remainder(recon + r.to(torch.float32), 2.0)
    return (diff > 0.5).any(dim=0)


def logical_error_mask_basis(test: RankBasisTest,
                             residual_2n: torch.Tensor) -> torch.Tensor:
    """(2n, batch) residual -> (batch,) bool logical mask, rank-basis form."""
    n = test.basis_x.shape[1]
    return (_sector_logical(test.basis_x, test.pivots_x, residual_2n[:n])
            | _sector_logical(test.basis_z, test.pivots_z, residual_2n[n:]))


def logical_error_mask(i_minus_p: torch.Tensor,
                       residual_2n: torch.Tensor) -> torch.Tensor:
    """(2n, batch) residual -> (batch,) bool: any row of iMinusP @ e odd."""
    prod = i_minus_p.to(torch.float32) @ residual_2n.to(torch.float32)
    return (torch.remainder(prod, 2.0) > 0.5).any(dim=0)


def classify_batch(
    i_minus_p: torch.Tensor | RankBasisTest,
    x_errors: torch.Tensor,      # (n, batch) true errors
    z_errors: torch.Tensor,
    x_decoded: torch.Tensor,     # (n, batch) hard decisions
    z_decoded: torch.Tensor,
    error_code: torch.Tensor,    # (batch,) bitmask from decode_batch
    valid: torch.Tensor | None = None,  # (batch,) bool lane mask
) -> torch.Tensor:
    """Returns the int32 counter vector (NUM_COUNTERS,) summed over the batch,
    on the inputs' device.  Lanes where ``valid`` is False are left out of
    every counter, the tested counts included."""
    batch = error_code.shape[0]
    x_tested = (x_errors != 0).any(dim=0)
    z_tested = (z_errors != 0).any(dim=0)
    syn_x = (error_code & SYNDROME_FAIL_X) != 0
    syn_z = (error_code & SYNDROME_FAIL_Z) != 0
    conv_x = (error_code & CONVERGENCE_FAIL_X) != 0
    conv_z = (error_code & CONVERGENCE_FAIL_Z) != 0
    undetected = ~(syn_x | syn_z)
    residual = torch.cat([(x_errors + x_decoded) % 2,
                          (z_errors + z_decoded) % 2], dim=0)
    if isinstance(i_minus_p, RankBasisTest):
        logical = logical_error_mask_basis(i_minus_p, residual)
    else:
        logical = logical_error_mask(i_minus_p, residual)
    logical_cnt = undetected & logical
    corrected_cnt = undetected & ~logical

    masks = [x_tested, z_tested, corrected_cnt, syn_x, syn_z, logical_cnt,
             conv_x, conv_z]
    if valid is None:
        tested = torch.full((), batch, dtype=torch.int32,
                            device=error_code.device)
    else:
        tested = valid.sum(dtype=torch.int32)
        masks = [m & valid for m in masks]
    return torch.stack([tested, *(m.sum(dtype=torch.int32) for m in masks)])


def _host(a) -> np.ndarray:
    """A tensor (on any device) or array-like as a NumPy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def classify_batch_np(i_minus_p, x_errors, z_errors, x_decoded, z_decoded,
                      error_code) -> np.ndarray:
    """Host (NumPy) mirror of :func:`classify_batch`, the same counters as
    an int64 array, for paths that splice corrections on the host.  Takes
    arrays or tensors on any device; ``i_minus_p`` a dense (2n x 2n) matrix
    or a :class:`RankBasisTest`.  The logical test runs through the host
    library's packed GF(2) matvec (``native.gf2_matvec``)."""
    x_errors, z_errors = _host(x_errors), _host(z_errors)
    error_code = _host(error_code)
    batch = error_code.shape[0]
    x_tested = (x_errors != 0).any(axis=0)
    z_tested = (z_errors != 0).any(axis=0)
    syn_x = (error_code & SYNDROME_FAIL_X) != 0
    syn_z = (error_code & SYNDROME_FAIL_Z) != 0
    conv_x = (error_code & CONVERGENCE_FAIL_X) != 0
    conv_z = (error_code & CONVERGENCE_FAIL_Z) != 0
    undetected = ~(syn_x | syn_z)
    residual = np.concatenate(
        [(x_errors + _host(x_decoded)) % 2,
         (z_errors + _host(z_decoded)) % 2], axis=0).astype(np.uint8)
    if isinstance(i_minus_p, RankBasisTest):
        n = i_minus_p.basis_x.shape[1]

        def sector(basis, pivots, r):
            basis, pivots = _host(basis), _host(pivots)
            if basis.shape[0] == 0:
                return r.astype(bool).any(axis=0)
            coeff = r[pivots]                      # (rank, batch) 0/1
            recon = native.gf2_matvec(basis.T, coeff.T)
            return ((recon ^ r) != 0).any(axis=0)

        logical = (sector(i_minus_p.basis_x, i_minus_p.pivots_x, residual[:n])
                   | sector(i_minus_p.basis_z, i_minus_p.pivots_z,
                            residual[n:]))
    else:
        logical = native.gf2_matvec(_host(i_minus_p), residual.T).astype(
            bool).any(axis=0)
    logical_cnt = undetected & logical
    corrected_cnt = undetected & ~logical
    return np.array([
        batch, x_tested.sum(), z_tested.sum(), corrected_cnt.sum(),
        syn_x.sum(), syn_z.sum(), logical_cnt.sum(), conv_x.sum(),
        conv_z.sum(),
    ], dtype=np.int64)
