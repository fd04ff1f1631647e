"""Sum-product BP through the hand-written CUDA kernel (csrc/bp_sum_product.cu).

The port of ``qec_ldpc_tpu/kernels/bp_pallas.py::bp_run_pallas``: the whole
BP loop of one circulant graph in one launch, one lane per CTA.
:func:`bp_run` checks its arguments, allocates the outputs and the scratch,
and launches the kernel on the current CUDA stream for a CUDA tensor; for a
CPU tensor it runs the plain version, ``decoder/sum_product.bp_run``.  There
is no fallback: a CUDA tensor either runs the kernel or raises (a launch the
card refuses, for shared memory or threads, raises too).
``placement.bp_plan`` decides per graph and device which of a lane's message
arrays fit in shared memory and which go to a per-lane slab of global
scratch.  A ``LiftedGraph`` goes to ``lifted_bp_cuda.lifted_bp_run`` (K6's
kernel, placed by the same plan), as the JAX dispatch does.

``launches`` counts kernel launches (never the plain path), so a run can
show that its decodes went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from qec_ldpc_tpu_torch.decoder import sum_product
from qec_ldpc_tpu_torch.decoder.layout import CirculantGraph
from qec_ldpc_tpu_torch.decoder.lifted import LiftedGraph
from qec_ldpc_tpu_torch.kernels import build, launch, lifted_bp_cuda, placement

#: the kernel's compile-time degree limits (kMaxB / kMaxL in the source)
MAX_VAR_DEGREE = 8
MAX_CHECK_DEGREE = 16

SOURCES = ("bp_sum_product.cu",)

#: number of kernel launches made by :func:`bp_run` in this process
launches = 0


#: the C types of ``qec_bp_sum_product``'s parameters, in order
ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.POINTER(ctypes.c_int32),
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_float,
    ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built library with the launcher's C signature declared."""
    lib = build.load("qec_bp", SOURCES)
    lib.qec_bp_sum_product.argtypes = ARGTYPES
    lib.qec_bp_sum_product.restype = ctypes.c_int
    return lib


def bp_run(
    graph: CirculantGraph | LiftedGraph,
    syndrome: torch.Tensor,   # (num_checks, batch) int32 in {0, 1}
    prior: float,             # channel prior (already 2/3-scaled), float32
    max_iters: int,
    check_every: int = 10,
    conv_low: float = 0.01,
    conv_high: float = 0.99,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(v_final (num_edges, batch) f32, iters (batch,) int32)``.

    Per lane, ``v_final`` equals the plain ``sum_product.bp_run`` bit for
    bit.  ``iters``: on the kernel, each lane's own executed iterations,
    which is what the plain loop counts for that lane run alone
    (``sum_product.bp_run_lanes``); its maximum is the plain loop's count for
    the batch.  (JAX's Pallas kernel counts per 128-lane tile.)  On a CPU
    tensor every lane gets the plain loop's count, as JAX's XLA path does.
    Lifted graphs go to ``lifted_bp_cuda.lifted_bp_run``."""
    global launches
    if isinstance(graph, LiftedGraph):
        return lifted_bp_cuda.lifted_bp_run(graph, syndrome, prior, max_iters,
                                            check_every, conv_low, conv_high)
    launch.check_run_args(graph, syndrome, max_iters, check_every,
                          CirculantGraph)
    prior32 = np.float32(prior)
    batch = syndrome.shape[1]
    if syndrome.device.type == "cpu":
        v, n = sum_product.bp_run(graph, syndrome, torch.tensor(prior32),
                                  max_iters, check_every, conv_low, conv_high)
        return v, n.expand(batch).clone()
    launch.check_cuda_args(graph, syndrome, MAX_VAR_DEGREE, MAX_CHECK_DEGREE)
    lib = _library()
    pl = placement.bp_plan(graph,
                           placement.smem_optin(syndrome.device.index))
    v = torch.empty((graph.num_edges, batch), dtype=torch.float32,
                    device=syndrome.device)
    scratch = (torch.empty((batch * pl.slab_floats,), dtype=torch.float32,
                           device=syndrome.device) if pl.slab_floats else None)
    iters = torch.empty((batch,), dtype=torch.int32, device=syndrome.device)
    with torch.cuda.device(syndrome.device):
        err = lib.qec_bp_sum_product(
            syndrome.data_ptr(), v.data_ptr(),
            None if scratch is None else scratch.data_ptr(), iters.data_ptr(),
            launch.shift_table(graph), graph.B, graph.L, graph.P, batch,
            float(prior32), max_iters, check_every,
            float(np.float32(conv_low)), float(np.float32(conv_high)),
            pl.threads, pl.v_shared, pl.e_shared, pl.smem_bytes,
            pl.slab_floats, launch.stream_of(syndrome.device))
    launch.raise_on_error("qec_bp_sum_product", err)
    launches += 1
    return v, iters
