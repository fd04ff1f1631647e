"""Normalized min-sum through the hand-written CUDA kernel (csrc/min_sum.cu).

The port of two TPU kernels that compute one function:

  * ``qec_ldpc_tpu/kernels/min_sum_pallas.py::min_sum_run_pallas`` — the
    route :func:`min_sum_run` takes for ``P < WIDE_MIN_P``;
  * ``qec_ldpc_tpu/kernels/min_sum_wide_pallas.py::min_sum_run_wide_pallas``
    — the route :func:`min_sum_run_wide`, which :func:`min_sum_run` hands
    ``P >= WIDE_MIN_P`` to, as the JAX kernel does.  On the TPU it is a
    transposed layout for VMEM's sake; here messages live in global memory,
    so both routes launch the same kernel and only their counts differ.

Each wrapper checks its arguments, allocates the outputs and launches the
kernel on the current CUDA stream for a CUDA tensor; for a CPU tensor it runs
the plain version, ``decoder/min_sum.min_sum_run``.  There is no fallback: a
CUDA tensor either runs the kernel or raises.  A ``LiftedGraph`` goes to
``lifted_min_sum_cuda.lifted_min_sum_run`` (K5's kernel) before the large-P
test, as the JAX dispatch does.  ``launches`` and
``wide_launches`` count each route's kernel launches (never the plain path).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from qec_ldpc_tpu_torch.decoder import min_sum
from qec_ldpc_tpu_torch.decoder.layout import CirculantGraph
from qec_ldpc_tpu_torch.decoder.lifted import LiftedGraph
from qec_ldpc_tpu_torch.kernels import build, launch, lifted_min_sum_cuda

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


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built library with the launcher's C signature declared."""
    lib = build.load("qec_min_sum", SOURCES)
    fn = lib.qec_min_sum
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
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
    v = torch.empty((graph.num_edges, batch), dtype=torch.float32,
                    device=syndrome.device)
    e = torch.empty_like(v)
    iters = torch.empty((batch,), dtype=torch.int32, device=syndrome.device)
    with torch.cuda.device(syndrome.device):
        err = lib.qec_min_sum(
            syndrome.data_ptr(), v.data_ptr(), e.data_ptr(),
            None if damping is None else damping.data_ptr(), iters.data_ptr(),
            launch.shift_table(graph), graph.B, graph.L, graph.P, batch,
            min_sum.f32(prior_llr), max_iters, check_every,
            min_sum.f32(min_sum.np_log_band(conv_low)), min_sum.f32(alpha),
            launch.stream_of(syndrome.device))
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
    bit, damped or not.  ``iters`` is each lane's executed iteration count:
    the kernel early-exits per tile of lanes, so a lane counts its tile's
    iterations; the maximum over lanes is the plain loop's count.  Lifted
    graphs go to ``lifted_min_sum_cuda.lifted_min_sum_run``, and circulant
    graphs with ``P >= WIDE_MIN_P`` to :func:`min_sum_run_wide`."""
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
