"""Batched GF(2) OSD-0 through the hand-written CUDA kernel (csrc/osd0.cu).

The port of ``qec_ldpc_tpu/kernels/osd0_pallas.py::osd0_eliminate_pallas``
(K7), fused with the column gather, bit packing and read-off the JAX package
runs around it (``decoder/osd_device.py::_solver``).  Two plain PyTorch
versions stand beside the kernel:

  * :func:`osd0_eliminate` — the packed core with the Pallas kernel's
    contract: ``packed (B, w+1, m)`` int32 (``w = ceil(n/32)`` little-endian
    words of the ordered columns per row, plus a syndrome plane) ->
    ``(s_final, used, pivcol)``;
  * :func:`osd0_solve_plain` — the fused function the kernel computes, built
    on :func:`ordered_system` and :func:`osd0_eliminate`.

:func:`osd0_solve` checks its arguments and launches the kernel on the
current CUDA stream for CUDA tensors; for CPU tensors it runs
:func:`osd0_solve_plain`.  There is no fallback: a CUDA tensor either runs
the kernel or raises.  :func:`plan` sizes the CTA (its threads, the rows
each lane of the walk warp holds, its shared memory) from m, n and the
device's opt-in limit.  ``launches`` counts kernel launches (never the
plain path).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from qec_ldpc_tpu_torch.kernels import build, launch, placement

SOURCES = ("osd0.cu",)

#: the kernel's row limit (kMaxRows): the walk warp holds up to 32 rows a lane
MAX_ROWS = 1024

#: number of kernel launches made by :func:`osd0_solve` in this process
launches = 0


def pack_columns(h: np.ndarray) -> np.ndarray:
    """(m, n) 0/1 matrix -> (n, ceil(m/32)) int32: column c's bits over the
    rows, bit r of word r // 32 (little-endian)."""
    h = np.asarray(h, dtype=np.uint8) % 2
    m, n = h.shape
    mw = -(-m // 32)
    by = np.zeros((n, 4 * mw), dtype=np.uint8)
    by[:, :-(-m // 8)] = np.packbits(h.T, axis=1, bitorder="little")
    return by.view("<u4").astype(np.uint32).view(np.int32)


def ordered_system(hcols: torch.Tensor, syndromes: torch.Tensor,
                   order: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """The packed system of each lane: ``(K, w+1, m)`` int32 with word k of
    row r holding ``H[r, order[b, 32k + j]]`` at bit j and plane w the
    syndrome bit (the JAX package's ``_pack_rows_words`` layout)."""
    lanes = order.shape[0]
    w = -(-n // 32)
    rows = torch.arange(m, device=hcols.device)
    hbits = ((hcols[:, rows // 32] >> (rows % 32)) & 1).to(torch.uint8)  # (n, m)
    ordered = torch.zeros((lanes, 32 * w, m), dtype=torch.uint8,
                          device=hcols.device)
    ordered[:, :n] = hbits[order.long()]
    ordered = ordered.reshape(lanes, w, 32, m)
    words = torch.zeros((lanes, w, m), dtype=torch.int64, device=hcols.device)
    for j in range(32):
        words |= ordered[:, :, j].to(torch.int64) << j
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    return torch.cat([words, syndromes.T.to(torch.int32)[:, None, :]], dim=1)


def osd0_eliminate(packed: torch.Tensor, m: int, n: int, rank: int,
                   work: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain swap-free Gauss-Jordan walk over the packed ordered columns.

    Returns ``(s_final (B, m) bool, used (B, m) bool, pivcol (B, m) int32)``:
    the reduced syndrome bits, the pivot-row mask, and each pivot row's
    ordered column index (``n + 1`` where unused), equal to
    ``osd0_eliminate_pallas`` bit for bit.  Per column, each lane's pivot is
    the lowest-index unused row with the bit set; it is XORed into every
    other row with the bit set.  The walk ends once every lane has ``rank``
    pivots (tested every 32 columns; later columns change nothing).

    ``work``, a ``(B,)`` int64 tensor if given, gains each lane's needed
    integer operations: in every column before its ``rank``-th pivot, 2 per
    row (the bit test and the candidate pick), plus ``planes - c // 32`` XORs
    (words ``c // 32`` to the syndrome plane; earlier words of the pivot row
    are 0) in each row that takes the pivot row."""
    lanes, planes, _ = packed.shape
    device = packed.device
    ms = packed.clone()
    used = torch.zeros((lanes, m), dtype=torch.bool, device=device)
    pivcol = torch.full((lanes, m), n + 1, dtype=torch.int32, device=device)
    idx = torch.arange(lanes, device=device)
    rows = torch.arange(m, device=device)
    for c in range(n):
        if c % 32 == 0 and bool((used.sum(dim=1) >= rank).all()):
            break
        bits = ((ms[:, c // 32] >> (c % 32)) & 1).bool()     # (B, m)
        cand = bits & ~used
        has = cand.any(dim=1)
        p = cand.to(torch.int32).argmax(dim=1)                # first maximum
        onehot = (rows[None, :] == p[:, None]) & has[:, None]
        pivot_row = ms[idx, :, p]                             # (B, planes)
        elim = bits & ~onehot & has[:, None]
        if work is not None:
            walking = used.sum(dim=1) < rank
            work += torch.where(walking, 2 * m + (planes - c // 32)
                                * elim.sum(dim=1), 0)
        ms ^= torch.where(elim[:, None, :], pivot_row[:, :, None], 0)
        pivcol = torch.where(onehot, c, pivcol)
        used |= onehot
    return ms[:, planes - 1] == 1, used, pivcol


def read_off(s_final: torch.Tensor, used: torch.Tensor, pivcol: torch.Tensor,
             order: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(e (n, K) uint8, solved (K,) bool)``: a lane is solved when no
    unused row keeps a syndrome bit; then variable ``order[pivcol[r]]`` takes
    row r's syndrome bit for every used row r."""
    lanes = order.shape[0]
    solved = ~(~used & s_final).any(dim=1)
    ones = used & s_final & solved[:, None]
    var = order.long().gather(1, torch.where(ones, pivcol, 0).long())
    var = torch.where(ones, var, n)  # everything else lands in a dump column
    e = torch.zeros((lanes, n + 1), dtype=torch.uint8, device=order.device)
    e.scatter_(1, var, ones.to(torch.uint8))
    return e[:, :n].T.contiguous(), solved


def osd0_solve_plain(hcols: torch.Tensor, syndromes: torch.Tensor,
                     order: torch.Tensor, m: int, n: int, rank: int):
    """The plain version of the fused kernel: :func:`ordered_system`, then
    :func:`osd0_eliminate`, then :func:`read_off`."""
    packed = ordered_system(hcols, syndromes, order, m, n)
    s_final, used, pivcol = osd0_eliminate(packed, m, n, rank)
    e, solved = read_off(s_final, used, pivcol, order, n)
    return e, solved, s_final, used, pivcol


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel's CTA for an (m, n) system: what the launcher is given."""

    threads: int
    rows_per_lane: int   # rows of word k each lane of the walk warp holds
    smem_bytes: int      # dynamic shared memory per CTA


def plan(m: int, n: int, smem_limit: int) -> Plan:
    """The kernel's CTA for an (m, n) system on a device whose CTA may take
    ``smem_limit`` bytes of shared memory (its opt-in limit, 227 KB on an
    H100).  One lane's system lives in shared memory, plane-major: ``w + 1``
    words per row (``w = ceil(n/32)``, the syndrome plane last), each row's
    panel mask and pivot column, and a panel's table of pivot-row xors (8
    groups of 16 words per trailing word).  The walk warp holds
    ``ceil(m/32)`` rows a lane, rounded up to even (the kernel's template
    instances); threads: one per row, a multiple of 32 in [64, 256], so
    that several CTAs share an SM.  Raises ``ValueError`` for a system the
    kernel cannot hold."""
    w = -(-n // 32)
    smem = 4 * ((w + 1) * m + 2 * m + 128 * w)
    if m > MAX_ROWS or smem > smem_limit:
        raise ValueError(f"an (m={m}, n={n}) system exceeds the kernel's "
                         f"{MAX_ROWS} rows or the device's {smem_limit} "
                         f"bytes of shared memory")
    return Plan(min(256, max(64, 32 * -(-m // 32))), 2 * -(-m // 64), smem)


#: the C types of ``qec_osd0``'s parameters, in order
ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
    ctypes.c_longlong, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built library with the launcher's C signature declared."""
    lib = build.load("qec_osd0", SOURCES)
    lib.qec_osd0.argtypes = ARGTYPES
    lib.qec_osd0.restype = ctypes.c_int
    return lib


def _check_args(hcols, syndromes, order, m, n, rank) -> None:
    lanes = order.shape[0] if order.dim() == 2 else -1
    if (hcols.dtype, syndromes.dtype, order.dtype) != (torch.int32,) * 3:
        raise TypeError(f"hcols, syndromes and order must be int32, got "
                        f"{hcols.dtype}, {syndromes.dtype}, {order.dtype}")
    if (tuple(hcols.shape) != (n, -(-m // 32))
            or tuple(order.shape) != (lanes, n)
            or tuple(syndromes.shape) != (m, lanes)):
        raise ValueError(f"shapes hcols {tuple(hcols.shape)}, syndromes "
                         f"{tuple(syndromes.shape)}, order {tuple(order.shape)} "
                         f"do not fit m={m}, n={n}")
    if not 0 <= rank <= m:
        raise ValueError(f"rank {rank} outside [0, {m}]")
    if not hcols.device == syndromes.device == order.device:
        raise ValueError("hcols, syndromes and order lie on different devices")


def osd0_solve(
    hcols: torch.Tensor,      # (n, ceil(m/32)) int32: pack_columns(H)
    syndromes: torch.Tensor,  # (m, K) int32 in {0, 1}
    order: torch.Tensor,      # (K, n) int32, most-likely-in-error first
    m: int,
    n: int,
    rank: int,                # GF(2) rank of H
):
    """OSD-0 of K lanes.  Returns ``(e (n, K) uint8, solved (K,) bool,
    s_final (K, m) bool, used (K, m) bool, pivcol (K, m) int32)``, the
    kernel's equal to :func:`osd0_solve_plain`'s bit for bit."""
    global launches
    _check_args(hcols, syndromes, order, m, n, rank)
    if syndromes.device.type == "cpu":
        return osd0_solve_plain(hcols, syndromes, order, m, n, rank)
    for t in (hcols, syndromes, order):
        launch.check_device(t)
    device = syndromes.device
    pl = plan(m, n, placement.smem_optin(device.index))
    lanes = order.shape[0]
    e = torch.empty((n, lanes), dtype=torch.uint8, device=device)
    solved = torch.empty((lanes,), dtype=torch.uint8, device=device)
    s_final = torch.empty((lanes, m), dtype=torch.uint8, device=device)
    used = torch.empty((lanes, m), dtype=torch.uint8, device=device)
    pivcol = torch.empty((lanes, m), dtype=torch.int32, device=device)
    if lanes == 0:
        return e, solved.bool(), s_final.bool(), used.bool(), pivcol
    lib = _library()
    with torch.cuda.device(device):
        err = lib.qec_osd0(hcols.data_ptr(), syndromes.data_ptr(),
                           order.data_ptr(), e.data_ptr(), solved.data_ptr(),
                           s_final.data_ptr(), used.data_ptr(),
                           pivcol.data_ptr(), m, n, rank, lanes,
                           pl.threads, pl.rows_per_lane, pl.smem_bytes,
                           launch.stream_of(device))
    launch.raise_on_error("qec_osd0", err)
    launches += 1
    return (e, solved.view(torch.bool), s_final.view(torch.bool),
            used.view(torch.bool), pivcol)
