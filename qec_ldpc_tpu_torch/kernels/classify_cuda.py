"""Decide -> classify of the counting chunk through the hand-written CUDA
kernel (csrc/decide_classify.cu).

From the final messages of the X and Z decodes (sum-product or min-sum, as
the decode kernels return them) to the chunk's nine classification
counters and its two lane-iteration sums in one launch, added into the
caller's int64 accumulators: what ``decode.decide`` per graph, the
error-code bits, ``classify_batch`` and the ``lane_iters`` sums compute,
without their ~110 small device operations.  The logical test is the
rank-basis one (``RankBasisTest``), run in GF(2) on packed rows.

:func:`prepare` makes what the kernel reads besides a chunk's tensors (each
sector's basis packed into 32-bit words, the row of each pivot column, the
graphs' routing indices), and keeps the last tables it made, so a point's
chunks, which share one logical test, reuse its set-up's.
:func:`decide_classify` launches the kernel on the current CUDA stream and
raises for any other tensors: there is no fallback.
:func:`decide_classify_plain` is the plain version, the composition the
kernel replaces, on any device.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from qec_ldpc_tpu_torch.decoder import decode
from qec_ldpc_tpu_torch.decoder.min_sum import f32, np_log_band
from qec_ldpc_tpu_torch.decoder.sum_product import BPConfig
from qec_ldpc_tpu_torch.kernels import build, launch
from qec_ldpc_tpu_torch.sampling.classify import (
    NUM_COUNTERS,
    RankBasisTest,
    classify_batch,
)

SOURCES = ("decide_classify.cu",)

#: the decoders whose decisions come from their final messages
ALGORITHMS = ("sum-product", "min-sum")

#: the kernel's variable-degree limit (kMaxVarDegree), every decode kernel's
MAX_VAR_DEGREE = 8

#: number of kernel launches made by :func:`decide_classify` in this process
launches = 0

#: the tables :func:`prepare` made last (they hold its graphs and test)
_last_tables = None

#: the C types of ``qec_decide_classify``'s parameters, in order
ARGTYPES = [*([ctypes.c_void_p] * 16), *([ctypes.c_int] * 11),
            *([ctypes.c_float] * 4), ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]


class Tables(NamedTuple):
    """What the kernel reads besides a chunk's tensors, for one code and
    logical test: per sector (X, Z) the basis rows packed into int32 words
    (``(rank, ceil(n/32))``, bit j of row t at bit j % 32 of word j // 32)
    and ``row_of`` ``(n,)`` int32, the row whose pivot is column j or -1;
    per graph its ``to_var`` and ``var_of_edge`` routing indices."""

    graphs: decode.CodeGraphs
    test: RankBasisTest
    basis: tuple[torch.Tensor, torch.Tensor]
    row_of: tuple[torch.Tensor, torch.Tensor]
    to_var: tuple[torch.Tensor, torch.Tensor]
    var_of_edge: tuple[torch.Tensor, torch.Tensor]


def pack_rows(basis: torch.Tensor) -> torch.Tensor:
    """(rank, n) 0/1 -> (rank, ceil(n/32)) int32 packed rows, on the
    basis's device with no host copy."""
    rank, n = basis.shape
    words = -(-n // 32)
    padded = torch.zeros((rank, 32 * words), dtype=torch.int64,
                         device=basis.device)
    padded[:, :n] = basis
    shifts = torch.arange(32, dtype=torch.int64, device=basis.device)
    packed = (padded.view(rank, words, 32) << shifts).sum(dim=2)
    # bit 31 set: the word's int32 value is 2^32 below its unsigned one
    return (packed - ((packed >> 31) << 32)).to(torch.int32)


def prepare(graphs: decode.CodeGraphs, test: RankBasisTest) -> Tables:
    """The :class:`Tables` of ``graphs`` and ``test``, on the test's device:
    the basis packed and ``row_of`` by device operations (no host copy), the
    routing indices from the graphs' per-device caches.  The same objects
    as the last call's return its tables again, with no device work, so a
    chunk under CUDA-graph capture may call it after its point's set-up."""
    global _last_tables
    last = _last_tables
    if last is not None and last.graphs is graphs and last.test is test:
        return last
    device = test.basis_x.device
    n = graphs.code.n
    if graphs.x.num_vars != n or graphs.z.num_vars != n:
        raise ValueError(f"graphs of {graphs.x.num_vars} and "
                         f"{graphs.z.num_vars} variables for a code of {n}")
    basis, row_of = [], []
    for rows, pivots in ((test.basis_x, test.pivots_x),
                         (test.basis_z, test.pivots_z)):
        if rows.shape[1] != n:
            raise ValueError(f"a basis of {rows.shape[1]} columns for a code "
                             f"of {n}")
        basis.append(pack_rows(rows))
        of = torch.full((n,), -1, dtype=torch.int32, device=device)
        of[pivots] = torch.arange(pivots.shape[0], dtype=torch.int32,
                                  device=device)
        row_of.append(of)
    graph_pair = (graphs.x, graphs.z)
    _last_tables = Tables(
        graphs, test, tuple(basis), tuple(row_of),
        tuple(g.index("to_var", device) for g in graph_pair),
        tuple(g.index("var_of_edge", device) for g in graph_pair))
    return _last_tables


def decide_classify_plain(tables: Tables, cfg: BPConfig, messages,
                          syndromes, errors, lane_iters):
    """The plain version: ``decode.decide`` per graph, the error-code bits,
    ``classify_batch`` and the lane-iteration sums.  ``messages``,
    ``syndromes``, ``errors`` and ``lane_iters`` are (X, Z) pairs as in
    :func:`decide_classify`.  Returns (counters (NUM_COUNTERS,) int32,
    iters (2,) int64)."""
    graphs = tables.graphs
    (dx, cfx, sfx), (dz, cfz, sfz) = (
        decode.decide(g, v, s, cfg)
        for g, v, s in zip((graphs.x, graphs.z), messages, syndromes))
    counters = classify_batch(tables.test, *errors, dx.to(torch.int32),
                              dz.to(torch.int32),
                              decode.error_code(sfx, sfz, cfx, cfz))
    return counters, torch.stack([it.sum() for it in lane_iters])


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built library with the launcher's C signature declared."""
    lib = build.load("qec_decide_classify", SOURCES)
    lib.qec_decide_classify.argtypes = ARGTYPES
    lib.qec_decide_classify.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} shape {tuple(t.shape)}, expected {shape}")
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, not {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def decide_classify(tables: Tables, cfg: BPConfig, messages, syndromes,
                    errors, lane_iters, counters: torch.Tensor,
                    iters: torch.Tensor) -> None:
    """Add one chunk into ``counters`` ((NUM_COUNTERS,) int64, the counter
    layout of ``classify_batch``) and ``iters`` ((2,) int64, executed
    lane-iterations of X and Z).

    Each argument is an (X, Z) pair: ``messages`` the final check-indexed
    messages ``(num_edges, batch)`` float32 of ``cfg.algorithm``
    (probabilities for sum-product, LLRs for min-sum), ``syndromes`` the
    int32 ``(num_checks, batch)`` syndromes they decoded, ``errors`` the
    int32 ``(n, batch)`` true errors, ``lane_iters`` each lane's executed
    iterations ``(batch,)`` int32, all on one CUDA device.  The counters
    equal :func:`decide_classify_plain`'s exactly (integer and compare-only
    arithmetic)."""
    global launches
    if cfg.algorithm not in ALGORITHMS:
        raise ValueError(f"decide_classify takes {ALGORITHMS}, not "
                         f"{cfg.algorithm!r}")
    device = messages[0].device
    launch.check_device(messages[0])
    graphs = (tables.graphs.x, tables.graphs.z)
    n = tables.graphs.code.n
    batch = messages[0].shape[1]
    for side, g, v, s, e, it in zip("XZ", graphs, messages, syndromes, errors,
                                    lane_iters):
        if g.var_degree > MAX_VAR_DEGREE:
            raise ValueError(f"graph {side}: variable degree {g.var_degree} "
                             f"exceeds the kernel's {MAX_VAR_DEGREE}")
        _check(f"messages {side}", v, torch.float32, (g.num_edges, batch),
               device)
        _check(f"syndrome {side}", s, torch.int32, (g.num_checks, batch),
               device)
        _check(f"errors {side}", e, torch.int32, (n, batch), device)
        _check(f"lane_iters {side}", it, torch.int32, (batch,), device)
    _check("counters", counters, torch.int64, (NUM_COUNTERS,), device)
    _check("iters", iters, torch.int64, (2,), device)
    for t in (*tables.basis, *tables.row_of):
        if t.device != device:
            raise ValueError(f"the tables lie on {t.device}, not {device}")
    lib = _library()
    ptr = [t.data_ptr() for t in (
        *messages, *tables.to_var, *tables.var_of_edge, *syndromes, *errors,
        *lane_iters, tables.basis[0], tables.row_of[0], tables.basis[1],
        tables.row_of[1])]
    shape = [d for g in graphs
             for d in (g.var_degree, g.num_checks, g.check_degree, g.P)]
    with torch.cuda.device(device):
        err = lib.qec_decide_classify(
            *ptr, *shape, n, batch, int(cfg.algorithm == "min-sum"),
            f32(cfg.hard_threshold), f32(cfg.conv_low), f32(cfg.conv_high),
            f32(np_log_band(cfg.conv_low)), counters.data_ptr(),
            iters.data_ptr(), launch.stream_of(device))
    launch.raise_on_error("qec_decide_classify", err)
    launches += 1
