"""Normalized min-sum on a lifted graph through the hand-written CUDA kernel
(csrc/lifted_min_sum.cu).

The port of ``qec_ldpc_tpu/kernels/lifted_min_sum_pallas.py::
lifted_min_sum_run_pallas``: the whole flooding min-sum loop of one
``LiftedGraph`` (bivariate bicycle, hypergraph-product and toric codes) in
one launch, one lane per CTA, with the optional damping operand of the relay
decoder.  The check update is the min-sum kernel's (K2, csrc/min_sum.cu), and
so is the placement: ``placement.plan`` puts a lane's syndrome bits, V,
compressed check state and damping in shared memory while they fit in the
device's opt-in limit, the rest in a per-lane slab of global scratch.
``min_sum_cuda.min_sum_run`` hands every ``LiftedGraph`` here before its
large-P test, as the JAX dispatch does, so relay reaches this kernel
unchanged and a large toric code never takes the circulant wide route.

:func:`lifted_min_sum_run` checks its arguments, allocates the outputs and
launches the kernel on the current CUDA stream for a CUDA tensor; for a CPU
tensor it runs the plain version, ``decoder/min_sum.min_sum_run``.  There is
no fallback: a CUDA tensor either runs the kernel or raises (a launch the
card refuses, for shared memory or threads, raises too).  ``launches``
counts kernel launches (never the plain path).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from qec_ldpc_tpu_torch.decoder import min_sum
from qec_ldpc_tpu_torch.decoder.lifted import LiftedGraph
from qec_ldpc_tpu_torch.kernels import build, launch, placement

SOURCES = ("lifted_min_sum.cu",)

#: number of kernel launches made by :func:`lifted_min_sum_run` in this process
launches = 0


#: the C types of ``qec_lifted_min_sum``'s parameters, in order
ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, *launch.LIFTED_ARGTYPES,
    ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_float,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built library with the launcher's C signature declared."""
    lib = build.load("qec_lifted_min_sum", SOURCES)
    lib.qec_lifted_min_sum.argtypes = ARGTYPES
    lib.qec_lifted_min_sum.restype = ctypes.c_int
    return lib


def lifted_min_sum_run(
    graph: LiftedGraph,
    syndrome: torch.Tensor,    # (num_checks, batch) int32 in {0, 1}
    prior_llr: float,          # float32 channel prior LLR (min_sum.prior_llr)
    max_iters: int,
    check_every: int = 10,
    conv_low: float = 0.01,
    alpha: float = 0.75,
    damping: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(v_final (num_edges, batch) f32 LLRs in check-major
    check-indexed order, iters (batch,) int32)``.

    Per lane, ``v_final`` equals the plain ``min_sum.min_sum_run`` on the
    same graph bit for bit, damped or not.  ``iters``: on the kernel, each
    lane's own executed iterations, which is what the plain loop counts for
    that lane run alone (``min_sum.min_sum_run_lanes``); its maximum is the
    plain loop's count for the batch.  On a CPU tensor every lane gets the
    plain loop's count."""
    global launches
    launch.check_run_args(graph, syndrome, max_iters, check_every,
                          LiftedGraph)
    launch.check_damping(damping, graph.num_edges, syndrome)
    batch = syndrome.shape[1]
    if syndrome.device.type == "cpu":
        v, n = min_sum.min_sum_run(graph, syndrome, prior_llr, max_iters,
                                   check_every, conv_low, alpha, damping)
        return v, n.expand(batch).clone()
    launch.check_lifted_cuda_args(graph, syndrome)
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
        err = lib.qec_lifted_min_sum(
            syndrome.data_ptr(), v.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            None if damping is None else damping.data_ptr(), iters.data_ptr(),
            *launch.lifted_description(graph), batch,
            min_sum.f32(prior_llr), max_iters, check_every,
            min_sum.f32(min_sum.np_log_band(conv_low)), min_sum.f32(alpha),
            pl.threads, pl.v_shared, pl.state_shared, pl.damping_shared,
            pl.smem_bytes, pl.slab_floats, launch.stream_of(syndrome.device))
    launch.raise_on_error("qec_lifted_min_sum", err)
    launches += 1
    return v, iters
