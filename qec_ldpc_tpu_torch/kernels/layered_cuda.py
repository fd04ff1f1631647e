"""Layered min-sum through the hand-written CUDA kernel
(csrc/layered_min_sum.cu).

The port of ``qec_ldpc_tpu/kernels/layered_pallas.py::layered_run_pallas``:
the whole layered decode of one circulant graph in one launch.
:func:`layered_run` checks its arguments, allocates the outputs and launches
the kernel on the current CUDA stream for a CUDA tensor; for a CPU tensor it
runs the plain version, ``decoder/layered.layered_min_sum_run``.  There is
no fallback: a CUDA tensor either runs the kernel or raises.  ``launches``
counts kernel launches (never the plain path).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from qec_ldpc_tpu_torch.decoder import layered
from qec_ldpc_tpu_torch.decoder.layout import CirculantGraph
from qec_ldpc_tpu_torch.decoder.min_sum import f32
from qec_ldpc_tpu_torch.kernels import build, launch

#: the kernel's compile-time degree limits (kMaxB / kMaxL in the source)
MAX_VAR_DEGREE = 8
MAX_CHECK_DEGREE = 16

SOURCES = ("layered_min_sum.cu",)

#: number of kernel launches made by :func:`layered_run` in this process
launches = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built library with the launcher's C signature declared."""
    lib = build.load("qec_layered", SOURCES)
    fn = lib.qec_layered_min_sum
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def layered_run(
    graph: CirculantGraph,
    syndrome: torch.Tensor,   # (num_checks, batch) int32 in {0, 1}
    prior_llr: float,         # float32 channel prior LLR (min_sum.prior_llr)
    max_iters: int,
    check_every: int = 1,
    alpha: float = 0.75,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(q_final (num_vars, batch) f32 posterior LLRs, iters
    (batch,) int32)``.

    Per lane, ``q_final`` equals the plain ``layered.layered_min_sum_run``
    bit for bit.  ``iters`` is each lane's executed sweep count: the kernel
    early-exits per tile of lanes, so a lane counts its tile's sweeps; the
    maximum over lanes is the plain loop's count."""
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
    q = torch.empty((graph.num_vars, batch), dtype=torch.float32,
                    device=syndrome.device)
    r = torch.empty((graph.num_edges, batch), dtype=torch.float32,
                    device=syndrome.device)
    iters = torch.empty((batch,), dtype=torch.int32, device=syndrome.device)
    with torch.cuda.device(syndrome.device):
        err = lib.qec_layered_min_sum(
            syndrome.data_ptr(), q.data_ptr(), r.data_ptr(), iters.data_ptr(),
            launch.shift_table(graph), graph.B, graph.L, graph.P, batch,
            f32(prior_llr), max_iters, check_every, f32(alpha),
            launch.stream_of(syndrome.device))
    launch.raise_on_error("qec_layered_min_sum", err)
    launches += 1
    return q, iters
