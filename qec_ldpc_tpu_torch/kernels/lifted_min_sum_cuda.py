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

:func:`lifted_min_sum_pair_run` decodes both sectors of a chunk, X and Z, in
ONE launch of the same kernel: the grid interleaves the two sectors' lanes,
so the few lanes of each that run on to ``max_iters`` overlap with each
other and with the other sector's bulk, where two launches would pay that
tail twice.  It takes the pair only where :func:`pair_plan` holds (both
graphs lifted, of one ``Dv`` and one plan with every array in shared
memory, undamped), and raises otherwise: the caller decides first
(``decoder/decode.py::paired_path``) and runs two one-sector launches where
the pair does not hold.  Each lane's messages and ``iters`` are
those of a one-sector launch, bit for bit.
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


#: the C types of ``qec_lifted_min_sum_pair``'s parameters, in order: each
#: sector's syndrome, messages, iteration counts and description, then what
#: the two share
_SECTOR_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    *launch.LIFTED_ARGTYPES]
PAIR_ARGTYPES = [
    *_SECTOR_ARGTYPES, *_SECTOR_ARGTYPES,
    ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_float,
    ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_void_p,
]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built library with the launchers' C signatures declared."""
    lib = build.load("qec_lifted_min_sum", SOURCES)
    lib.qec_lifted_min_sum.argtypes = ARGTYPES
    lib.qec_lifted_min_sum.restype = ctypes.c_int
    lib.qec_lifted_min_sum_pair.argtypes = PAIR_ARGTYPES
    lib.qec_lifted_min_sum_pair.restype = ctypes.c_int
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


def pair_plan(graphs, damped: bool,
              device: torch.device) -> placement.Plan | None:
    """The plan both sectors of one launch share, or None where the pair
    does not hold: a CUDA ``device``, two ``LiftedGraph`` of one variable
    degree (the kernel's ``kDv``), undamped, and one ``placement.plan`` for
    both with every array in shared memory (no slab).  Each condition is
    one the call can see in its input; the device's shared-memory limit is
    read only once the graphs pass."""
    device = torch.device(device)
    if (device.type != "cuda" or damped
            or not all(isinstance(g, LiftedGraph) for g in graphs)
            or len({g.var_degree for g in graphs}) != 1):
        return None
    index = torch.cuda.current_device() if device.index is None else device.index
    limit = placement.smem_optin(index)
    px, pz = (placement.plan(g, False, limit) for g in graphs)
    return px if px == pz and px.slab_floats == 0 else None


def _sector_args(graph: LiftedGraph, syndrome: torch.Tensor, v: torch.Tensor,
                 iters: torch.Tensor) -> tuple:
    return (syndrome.data_ptr(), v.data_ptr(), iters.data_ptr(),
            *launch.lifted_description(graph))


def lifted_min_sum_pair_run(
    graphs,                    # (X graph, Z graph), both LiftedGraph
    syndromes,                 # (sx, sz), each (num_checks, batch) int32
    prior_llr: float,
    max_iters: int,
    check_every: int = 10,
    conv_low: float = 0.01,
    alpha: float = 0.75,
) -> tuple[tuple[torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]:
    """Both sectors in one launch: ``((v_x, iters_x), (v_z, iters_z))``,
    each what :func:`lifted_min_sum_run` returns for that sector alone on
    the card, bit for bit.  Raises where :func:`pair_plan` does not hold or
    the syndromes are not contiguous CUDA tensors of one device and one
    batch; counts one launch."""
    global launches
    (gx, gz), (sx, sz) = graphs, syndromes
    for g, s in ((gx, sx), (gz, sz)):
        launch.check_run_args(g, s, max_iters, check_every, LiftedGraph)
        launch.check_lifted_cuda_args(g, s)
    if sx.device != sz.device or sx.shape[1] != sz.shape[1]:
        raise ValueError("the two sectors lie on different devices or hold "
                         "different batches")
    pl = pair_plan(graphs, False, sx.device)
    if pl is None:
        raise ValueError("these two graphs cannot share one launch "
                         "(pair_plan): decode them one sector at a time")
    lib = _library()
    batch = sx.shape[1]
    outs = [(torch.empty((g.num_edges, batch), dtype=torch.float32,
                         device=sx.device),
             torch.empty((batch,), dtype=torch.int32, device=sx.device))
            for g in graphs]
    with torch.cuda.device(sx.device):
        err = lib.qec_lifted_min_sum_pair(
            *_sector_args(gx, sx, *outs[0]), *_sector_args(gz, sz, *outs[1]),
            batch, min_sum.f32(prior_llr), max_iters, check_every,
            min_sum.f32(min_sum.np_log_band(conv_low)), min_sum.f32(alpha),
            pl.threads, pl.v_shared, pl.state_shared, pl.smem_bytes,
            launch.stream_of(sx.device))
    launch.raise_on_error("qec_lifted_min_sum_pair", err)
    launches += 1
    return outs[0], outs[1]
