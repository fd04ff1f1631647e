"""Device OSD-0: batched GF(2) elimination of BP-failed lanes on the GPU.

The port of ``qec_ldpc_tpu/decoder/osd_device.py``.  :class:`DeviceOSD0`
solves OSD-0 (``lam == 0``) for one parity-check matrix: it gathers the
lanes to solve, ranks each lane's variables by a stable argsort of their
reliabilities, and hands ``(H's packed columns, syndromes, order)`` to
``kernels/osd0_cuda.osd0_solve`` (K7), which builds each lane's ordered
system, runs the Gauss-Jordan walk and reads off the correction in the
original variable order.  On a CPU tensor the same call runs the kernel's
plain version.

Bit equivalence with the host solver (``native/gf2.cpp::qec_osd_batch``):
row operations keep every linear relation among the columns, so the greedy
first-linearly-independent column set is the host's (a function of the
column order alone), and the OSD-0 solution over those columns is unique.
So corrections and solved flags match bit for bit whenever the ranking
does.  The ranking key maps -0.0 to +0.0 and every NaN to one positive NaN
before the stable sort: that is how NumPy and JAX order them (-0.0 ties
+0.0, NaN last), and it leaves a radix sort on the card no sign bit to
split them by.

Not ported (TPU-only, invisible in the results): the power-of-two lane
buckets ``_SLICE``/``_SLICE_SMALL`` that bounded the number of compiled
shapes, and the per-tile VMEM sizing.  Here a launch takes exactly the lanes
it is given.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from qec_ldpc_tpu_torch import tracing
from qec_ldpc_tpu_torch.codes import gf2_rref
from qec_ldpc_tpu_torch.kernels import osd0_cuda


def ranking(reliability: torch.Tensor) -> torch.Tensor:
    """(n, K) reliabilities -> (K, n) int32 orders, most likely in error
    (smallest) first: a stable argsort with -0.0 taken as +0.0 and NaN
    last."""
    key = torch.where(reliability.isnan(), math.nan, reliability + 0.0)
    order = torch.argsort(key, dim=0, stable=True)
    return order.T.to(torch.int32).contiguous()


class DeviceOSD0:
    """Batched OSD-0 for one parity-check matrix, on the device of the
    tensors it is given.  Same contract as the host
    :class:`~qec_ldpc_tpu_torch.decoder.osd.OSDecoder` at ``lam == 0``."""

    def __init__(self, h_dense: np.ndarray):
        h = np.ascontiguousarray(np.asarray(h_dense, dtype=np.uint8) % 2)
        self.m, self.n = h.shape
        self.rank = len(gf2_rref(h)[1])
        self._hcols_np = osd0_cuda.pack_columns(h)
        self._hcols: dict[torch.device, torch.Tensor] = {}

    def to(self, device: torch.device | str) -> "DeviceOSD0":
        """Place H's packed columns on ``device`` now (a host-to-device copy)
        rather than at the first solve there."""
        self.columns(torch.device(device))
        return self

    def columns(self, device: torch.device | str) -> torch.Tensor:
        """H's packed columns (``osd0_cuda.pack_columns``) on ``device``."""
        device = torch.device(device)
        cols = self._hcols.get(device)
        if cols is None:
            cols = torch.as_tensor(self._hcols_np, device=device)
            # "cuda" and "cuda:0" name one device: keep both keys
            self._hcols[device] = self._hcols[cols.device] = cols
        return cols

    def decode(self, syndromes: torch.Tensor, order: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """syndromes (m, B) 0/1; order (B, n) most-likely-in-error first.
        Returns ((n, B) uint8 corrections, (B,) bool solved) on the
        syndromes' device."""
        device = syndromes.device
        hcols = self.columns(device)
        syn = syndromes.to(torch.int32).contiguous()
        order = order.to(device=device, dtype=torch.int32).contiguous()
        with tracing.span("mc.launch"):
            e, solved, *_ = osd0_cuda.osd0_solve(hcols, syn, order, self.m,
                                                 self.n, self.rank)
        return e, solved

    def decode_device(self, syndromes: torch.Tensor, reliability: torch.Tensor,
                      failed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Solve lanes ``failed`` (an index tensor on the same device) of
        ``syndromes (m, Bc)`` and ``reliability (n, Bc)``: gather, rank and
        solve without leaving the device.  Returns ((n, K) uint8, (K,) bool)
        on that device.  (JAX's ``decode_device_arrays`` stripped the lane
        buckets' padding from this; with no buckets the outputs are already
        exactly the K lanes, so the one entry point serves both.)"""
        syn = syndromes.index_select(1, failed)
        order = ranking(reliability.index_select(1, failed))
        return self.decode(syn, order)
