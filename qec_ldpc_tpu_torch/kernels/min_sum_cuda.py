"""Normalized min-sum through the hand-written CUDA kernel (csrc/min_sum.cu).

The port of two TPU kernels that compute one function:

  * ``qec_ldpc_tpu/kernels/min_sum_pallas.py::min_sum_run_pallas`` — the
    route :func:`min_sum_run` takes for ``P < WIDE_MIN_P``;
  * ``qec_ldpc_tpu/kernels/min_sum_wide_pallas.py::min_sum_run_wide_pallas``
    — the route :func:`min_sum_run_wide`, which :func:`min_sum_run` hands
    ``P >= WIDE_MIN_P`` to, as the JAX kernel does.  On the TPU it is a
    transposed layout for VMEM's sake; here both routes launch the same
    kernel, one lane per CTA, and ``placement.plan`` decides per graph and
    device which of a lane's arrays fit in shared memory and which go to a
    per-lane slab of global scratch.

Each wrapper checks its arguments, allocates the outputs and the scratch and
launches the kernel on the current CUDA stream for a CUDA tensor; for a CPU
tensor it runs the plain version, ``decoder/min_sum.min_sum_run``.  There is
no fallback: a CUDA tensor either runs the kernel or raises (a launch the
card refuses, for shared memory or threads, raises too).  A ``LiftedGraph``
goes to ``lifted_min_sum_cuda.lifted_min_sum_run`` (K5's kernel) before the
large-P test, as the JAX dispatch does.  ``launches`` and ``wide_launches``
count each route's kernel launches (never the plain path).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from qec_ldpc_tpu_torch.decoder import min_sum
from qec_ldpc_tpu_torch.decoder.layout import CirculantGraph
from qec_ldpc_tpu_torch.decoder.lifted import LiftedGraph
from qec_ldpc_tpu_torch.kernels import (build, launch, lifted_min_sum_cuda,
                                       placement)

#: the kernel's compile-time degree limits (kMaxB / kMaxL in the source)
MAX_VAR_DEGREE = 8
MAX_CHECK_DEGREE = 16

#: circulant sizes from which the JAX package dispatches to its wide-lane
#: kernel (``min_sum_pallas.WIDE_MIN_P``); the same split here
WIDE_MIN_P = 768

SOURCES = ("min_sum.cu",)

#: kernel launches by :func:`min_sum_run` (P < WIDE_MIN_P) in this process
launches = 0
#: kernel launches by :func:`min_sum_run_wide` (P >= WIDE_MIN_P)
wide_launches = 0


#: the C types of ``qec_min_sum``'s parameters, in order
ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_float,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built library with the launcher's C signature declared."""
    lib = build.load("qec_min_sum", SOURCES)
    lib.qec_min_sum.argtypes = ARGTYPES
    lib.qec_min_sum.restype = ctypes.c_int
    return lib


def _run(graph: CirculantGraph, syndrome: torch.Tensor, prior_llr: float,
         max_iters: int, check_every: int, conv_low: float, alpha: float,
         damping: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor, bool]:
    """Both routes, after ``launch.check_run_args``: returns
    ``(v, iters, launched)``."""
    batch = syndrome.shape[1]
    launch.check_damping(damping, graph.num_edges, syndrome)
    if syndrome.device.type == "cpu":
        v, n = min_sum.min_sum_run(graph, syndrome, prior_llr, max_iters,
                                   check_every, conv_low, alpha, damping)
        return v, n.expand(batch).clone(), False
    launch.check_cuda_args(graph, syndrome, MAX_VAR_DEGREE, MAX_CHECK_DEGREE)
    if damping is not None and not damping.is_contiguous():
        raise ValueError("damping must be contiguous")
    lib = _library()
    pl = placement.plan(graph, damping is not None,
                        placement.smem_optin(syndrome.device.index))
    v = torch.empty((graph.num_edges, batch), dtype=torch.float32,
                    device=syndrome.device)
    scratch = (torch.empty((batch * pl.slab_floats,), dtype=torch.float32,
                           device=syndrome.device) if pl.slab_floats else None)
    iters = torch.empty((batch,), dtype=torch.int32, device=syndrome.device)
    with torch.cuda.device(syndrome.device):
        err = lib.qec_min_sum(
            syndrome.data_ptr(), v.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            None if damping is None else damping.data_ptr(), iters.data_ptr(),
            launch.shift_table(graph), graph.B, graph.L, graph.P, batch,
            min_sum.f32(prior_llr), max_iters, check_every,
            min_sum.f32(min_sum.np_log_band(conv_low)), min_sum.f32(alpha),
            pl.threads, pl.v_shared, pl.state_shared, pl.damping_shared,
            pl.smem_bytes, pl.slab_floats, launch.stream_of(syndrome.device))
    launch.raise_on_error("qec_min_sum", err)
    return v, iters, True


def min_sum_run(
    graph: CirculantGraph | LiftedGraph,
    syndrome: torch.Tensor,    # (num_checks, batch) int32 in {0, 1}
    prior_llr: float,          # float32 channel prior LLR (min_sum.prior_llr)
    max_iters: int,
    check_every: int = 10,
    conv_low: float = 0.01,
    alpha: float = 0.75,
    damping: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(v_final (num_edges, batch) f32 LLRs, iters (batch,) int32)``.

    Per lane, ``v_final`` equals the plain ``min_sum.min_sum_run`` bit for
    bit, damped or not.  ``iters``: on the kernel, each lane's own executed
    iterations, which is what the plain loop counts for that lane run alone
    (``min_sum.min_sum_run_lanes``); its maximum is the plain loop's count
    for the batch.  (JAX's Pallas kernel counts per 128-lane tile.)  On a CPU
    tensor every lane gets the plain loop's count, as JAX's XLA path does.
    Lifted graphs go to ``lifted_min_sum_cuda.lifted_min_sum_run``, and
    circulant graphs with ``P >= WIDE_MIN_P`` to :func:`min_sum_run_wide`."""
    global launches
    if isinstance(graph, LiftedGraph):
        return lifted_min_sum_cuda.lifted_min_sum_run(
            graph, syndrome, prior_llr, max_iters, check_every, conv_low,
            alpha, damping)
    launch.check_run_args(graph, syndrome, max_iters, check_every,
                          CirculantGraph)
    if graph.P >= WIDE_MIN_P:
        return min_sum_run_wide(graph, syndrome, prior_llr, max_iters,
                                check_every, conv_low, alpha, damping)
    v, iters, launched = _run(graph, syndrome, prior_llr, max_iters,
                              check_every, conv_low, alpha, damping)
    launches += launched
    return v, iters


def min_sum_run_wide(
    graph: CirculantGraph,
    syndrome: torch.Tensor,
    prior_llr: float,
    max_iters: int,
    check_every: int = 10,
    conv_low: float = 0.01,
    alpha: float = 0.75,
    damping: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The large-P route (the counterpart of ``min_sum_run_wide_pallas``):
    the same contract as :func:`min_sum_run`, counted in ``wide_launches``."""
    global wide_launches
    launch.check_run_args(graph, syndrome, max_iters, check_every,
                          CirculantGraph)
    v, iters, launched = _run(graph, syndrome, prior_llr, max_iters,
                              check_every, conv_low, alpha, damping)
    wide_launches += launched
    return v, iters
