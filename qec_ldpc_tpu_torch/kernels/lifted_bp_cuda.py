"""Sum-product BP on a lifted graph through the hand-written CUDA kernel
(csrc/lifted_bp.cu).

The port of ``qec_ldpc_tpu/kernels/lifted_bp_pallas.py::lifted_bp_run_pallas``:
the whole probability-domain BP loop of one ``LiftedGraph`` (bivariate
bicycle, hypergraph-product and toric codes) in one launch, one lane per
CTA.  The update is the sum-product kernel's (K1, csrc/bp_sum_product.cu),
and so is the placement: ``placement.bp_plan`` puts a lane's syndrome bits,
V and E in shared memory while they fit in the device's opt-in limit, the
rest in a per-lane slab of global scratch.  ``bp_cuda.bp_run`` hands every
``LiftedGraph`` here, as the JAX dispatch does.

:func:`lifted_bp_run` checks its arguments, allocates the outputs and
launches the kernel on the current CUDA stream for a CUDA tensor; for a CPU
tensor it runs the plain version, ``decoder/sum_product.bp_run``.  There is
no fallback: a CUDA tensor either runs the kernel or raises (a launch the
card refuses, for shared memory or threads, raises too).  ``launches``
counts kernel launches (never the plain path).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from qec_ldpc_tpu_torch.decoder import sum_product
from qec_ldpc_tpu_torch.decoder.lifted import LiftedGraph
from qec_ldpc_tpu_torch.kernels import build, launch, placement

SOURCES = ("lifted_bp.cu",)

#: number of kernel launches made by :func:`lifted_bp_run` in this process
launches = 0


#: the C types of ``qec_lifted_bp``'s parameters, in order
ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    *launch.LIFTED_ARGTYPES,
    ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_float,
    ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built library with the launcher's C signature declared."""
    lib = build.load("qec_lifted_bp", SOURCES)
    lib.qec_lifted_bp.argtypes = ARGTYPES
    lib.qec_lifted_bp.restype = ctypes.c_int
    return lib


def lifted_bp_run(
    graph: LiftedGraph,
    syndrome: torch.Tensor,   # (num_checks, batch) int32 in {0, 1}
    prior: float,             # channel prior (already 2/3-scaled), float32
    max_iters: int,
    check_every: int = 10,
    conv_low: float = 0.01,
    conv_high: float = 0.99,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(v_final (num_edges, batch) f32 probabilities in
    check-major check-indexed order, iters (batch,) int32)``.

    Per lane, ``v_final`` equals the plain ``sum_product.bp_run`` on the
    same graph bit for bit.  ``iters``: on the kernel, each lane's own
    executed iterations, which is what the plain loop counts for that lane
    run alone (``sum_product.bp_run_lanes``); its maximum is the plain
    loop's count for the batch.  On a CPU tensor every lane gets the plain
    loop's count."""
    global launches
    launch.check_run_args(graph, syndrome, max_iters, check_every,
                          LiftedGraph)
    prior32 = np.float32(prior)
    batch = syndrome.shape[1]
    if syndrome.device.type == "cpu":
        v, n = sum_product.bp_run(graph, syndrome, torch.tensor(prior32),
                                  max_iters, check_every, conv_low, conv_high)
        return v, n.expand(batch).clone()
    launch.check_lifted_cuda_args(graph, syndrome)
    lib = _library()
    pl = placement.bp_plan(graph, placement.smem_optin(syndrome.device.index))
    v = torch.empty((graph.num_edges, batch), dtype=torch.float32,
                    device=syndrome.device)
    scratch = (torch.empty((batch * pl.slab_floats,), dtype=torch.float32,
                           device=syndrome.device) if pl.slab_floats else None)
    iters = torch.empty((batch,), dtype=torch.int32, device=syndrome.device)
    with torch.cuda.device(syndrome.device):
        err = lib.qec_lifted_bp(
            syndrome.data_ptr(), v.data_ptr(),
            None if scratch is None else scratch.data_ptr(), iters.data_ptr(),
            *launch.lifted_description(graph), batch,
            float(prior32), max_iters, check_every,
            float(np.float32(conv_low)), float(np.float32(conv_high)),
            pl.threads, pl.v_shared, pl.e_shared, pl.smem_bytes,
            pl.slab_floats, launch.stream_of(syndrome.device))
    launch.raise_on_error("qec_lifted_bp", err)
    launches += 1
    return v, iters
