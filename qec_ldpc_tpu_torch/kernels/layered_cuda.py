"""Layered min-sum through the hand-written CUDA kernel
(csrc/layered_min_sum.cu).

The port of ``qec_ldpc_tpu/kernels/layered_pallas.py::layered_run_pallas``:
the whole layered decode of one circulant graph in one launch, one lane per
CTA.  :func:`layered_run` checks its arguments, allocates the outputs and
the scratch, and launches the kernel on the current CUDA stream for a CUDA
tensor; for a CPU tensor it runs the plain version,
``decoder/layered.layered_min_sum_run``.  There is no fallback: a CUDA
tensor either runs the kernel or raises (a launch the card refuses, for
shared memory or threads, raises too).  :func:`plan` owns the launch shape
and decides per graph and device which of a lane's arrays fit in shared
memory and which go to a per-lane slab of global scratch.  ``launches``
counts kernel launches (never the plain path).

The kernel keeps r, the check->var messages, as the min-sum kernels'
compressed check state (12 bytes per check) plus the sign bit of each
edge's t in the same word, so a lane of the P <= 1051 codes lives in shared
memory whole.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from qec_ldpc_tpu_torch.decoder import layered
from qec_ldpc_tpu_torch.decoder.layout import CirculantGraph
from qec_ldpc_tpu_torch.decoder.min_sum import f32
from qec_ldpc_tpu_torch.kernels import build, launch, placement

#: the kernel's compile-time degree limits (kMaxB / kMaxL in the source)
MAX_VAR_DEGREE = 8
MAX_CHECK_DEGREE = 16

SOURCES = ("layered_min_sum.cu",)

#: number of kernel launches made by :func:`layered_run` in this process
launches = 0


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch's shape and where one lane's arrays live: what the launcher
    is given (the kernel lays the arrays out in :func:`plan`'s order)."""

    threads: int
    q_shared: bool
    state_shared: bool
    smem_bytes: int      # dynamic shared memory per CTA (one lane)
    slab_floats: int     # float32 global scratch per lane


def lane_arrays(graph: CirculantGraph) -> tuple[int, int, int]:
    """The bytes of one lane's syndrome bits, q (4 per variable) and check
    state ({min1, min2} and the meta word: 12 per check), each 16-byte
    aligned."""
    checks = graph.num_checks
    return (_align16(checks), _align16(4 * graph.num_vars),
            _align16(8 * checks) + _align16(4 * checks))


def plan(graph: CirculantGraph, smem_limit: int) -> Plan:
    """The kernel's launch shape and placement for ``graph`` on a device
    whose CTA may take ``smem_limit`` bytes of shared memory (its opt-in
    limit, 227 KB on an H100): the syndrome bits always in shared memory,
    then, while they fit, q and the check state; the rest in the lane's
    global slab.  One lane per CTA, one thread per row of a layer (a
    multiple of 32 up to 1024)."""
    syn_bytes, q_bytes, state_bytes = lane_arrays(graph)
    used, slab_bytes = syn_bytes, 0
    placed = []
    for nbytes in (q_bytes, state_bytes):
        fits = used + nbytes <= smem_limit
        used += nbytes if fits else 0
        slab_bytes += 0 if fits else nbytes
        placed.append(fits)
    threads = min(1024, max(32, -(-graph.P // 32) * 32))
    return Plan(threads, *placed, used, slab_bytes // 4)


#: the C types of ``qec_layered_min_sum``'s parameters, in order
ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.POINTER(ctypes.c_int32),
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built library with the launcher's C signature declared."""
    lib = build.load("qec_layered", SOURCES)
    lib.qec_layered_min_sum.argtypes = ARGTYPES
    lib.qec_layered_min_sum.restype = ctypes.c_int
    return lib


def layered_run(
    graph: CirculantGraph,
    syndrome: torch.Tensor,   # (num_checks, batch) int32 in {0, 1}
    prior_llr: float,         # float32 channel prior LLR (min_sum.prior_llr)
    max_iters: int,
    check_every: int = 1,
    alpha: float = 0.75,
    shape: Plan | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(q_final (num_vars, batch) f32 posterior LLRs, iters
    (batch,) int32)``.

    Per lane, ``q_final`` equals the plain ``layered.layered_min_sum_run``
    bit for bit.  ``iters``: on the kernel, each lane's own executed sweeps,
    which is what the plain loop counts for that lane run alone
    (``layered.layered_min_sum_run_lanes``); its maximum is the plain loop's
    count for the batch.  (JAX's Pallas kernel counts per tile of lanes.)
    On a CPU tensor every lane gets the plain loop's count, as JAX's XLA
    path does.  ``shape``: the kernel's launch shape and placement, by
    default :func:`plan`'s for the device (a measurement may pass
    another)."""
    global launches
    # the layered schedule needs variable-disjoint block-row layers, which
    # lifted graphs do not have
    launch.check_run_args(graph, syndrome, max_iters, check_every,
                          CirculantGraph)
    batch = syndrome.shape[1]
    if syndrome.device.type == "cpu":
        q, n = layered.layered_min_sum_run(graph, syndrome, prior_llr,
                                           max_iters, check_every, alpha)
        return q, n.expand(batch).clone()
    launch.check_cuda_args(graph, syndrome, MAX_VAR_DEGREE, MAX_CHECK_DEGREE)
    lib = _library()
    pl = (plan(graph, placement.smem_optin(syndrome.device.index))
          if shape is None else shape)
    q = torch.empty((graph.num_vars, batch), dtype=torch.float32,
                    device=syndrome.device)
    scratch = (torch.empty((batch * pl.slab_floats,), dtype=torch.float32,
                           device=syndrome.device) if pl.slab_floats else None)
    iters = torch.empty((batch,), dtype=torch.int32, device=syndrome.device)
    with torch.cuda.device(syndrome.device):
        err = lib.qec_layered_min_sum(
            syndrome.data_ptr(), q.data_ptr(),
            None if scratch is None else scratch.data_ptr(), iters.data_ptr(),
            launch.shift_table(graph), graph.B, graph.L, graph.P, batch,
            f32(prior_llr), max_iters, check_every, f32(alpha), pl.threads,
            pl.q_shared, pl.state_shared, pl.smem_bytes, pl.slab_floats,
            launch.stream_of(syndrome.device))
    launch.raise_on_error("qec_layered_min_sum", err)
    launches += 1
    return q, iters
