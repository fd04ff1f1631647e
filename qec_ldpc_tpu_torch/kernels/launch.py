"""Argument checks and launch helpers shared by the kernel wrappers.

Every kernel of the port takes one graph, an int32 syndrome
``(num_checks, batch)`` with the batch trailing, the graph's description by
value and PyTorch's current stream; its C launcher returns a
``cudaError_t``.  A circulant graph is described by its exponent table
(:func:`shift_table`); a lifted graph by its edge blocks and rank table
(:func:`lifted_description`).
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING

import numpy as np
import torch

if TYPE_CHECKING:  # annotations only: the decoder imports the kernels
    from qec_ldpc_tpu_torch.decoder.layout import CirculantGraph
    from qec_ldpc_tpu_torch.decoder.lifted import LiftedGraph


def check_run_args(graph: CirculantGraph | LiftedGraph, syndrome: torch.Tensor,
                   max_iters: int, check_every: int, graph_type: type) -> None:
    """Raise on what no kernel (and no plain version) takes, and on a graph
    that is not the wrapper's ``graph_type``."""
    if not isinstance(graph, graph_type):
        raise TypeError(f"expected a {graph_type.__name__}, got "
                        f"{type(graph).__name__}")
    if syndrome.dtype != torch.int32:
        raise TypeError(f"syndrome must be int32, got {syndrome.dtype}")
    if syndrome.dim() != 2 or syndrome.shape[0] != graph.num_checks:
        raise ValueError(f"syndrome shape {tuple(syndrome.shape)} does not "
                         f"match ({graph.num_checks}, batch)")
    if max_iters < 0 or check_every < 1:
        raise ValueError(f"max_iters={max_iters} check_every={check_every}")


def check_device(syndrome: torch.Tensor) -> None:
    """Raise unless ``syndrome`` is a contiguous CUDA tensor."""
    if syndrome.device.type != "cuda":
        raise ValueError(f"unsupported device {syndrome.device}")
    if not syndrome.is_contiguous():
        raise ValueError("syndrome must be contiguous")


def check_cuda_args(graph: CirculantGraph, syndrome: torch.Tensor,
                    max_var_degree: int, max_check_degree: int) -> None:
    """Raise unless ``syndrome`` is a contiguous CUDA tensor and the
    circulant graph's degrees fit the kernel's compile-time limits."""
    check_device(syndrome)
    if graph.B > max_var_degree or graph.L > max_check_degree:
        raise ValueError(f"graph degrees B={graph.B}, L={graph.L} exceed the "
                         f"kernel's {max_var_degree}, {max_check_degree}")


def check_damping(damping: torch.Tensor | None, num_edges: int,
                  syndrome: torch.Tensor) -> None:
    """Raise unless ``damping`` is None or a float32 (num_edges, batch)
    tensor on the syndrome's device."""
    if damping is None:
        return
    batch = syndrome.shape[1]
    if damping.dtype != torch.float32:
        raise TypeError(f"damping must be float32, got {damping.dtype}")
    if tuple(damping.shape) != (num_edges, batch):
        raise ValueError(f"damping shape {tuple(damping.shape)} does not "
                         f"match ({num_edges}, {batch})")
    if damping.device != syndrome.device:
        raise ValueError("damping and syndrome lie on different devices")


def shift_table(graph: CirculantGraph) -> ctypes.Array:
    """The (B, L) exponent table as a host int32 array the launcher copies
    into the kernel's by-value graph argument."""
    return (ctypes.c_int32 * (graph.B * graph.L))(
        *graph.table.astype(np.int32).ravel().tolist())


#: the lifted kernels' compile-time limits (kMaxEdgeBlocks, kMaxDc, kMaxDv
#: in csrc/lifted.cuh)
LIFTED_MAX_EDGE_BLOCKS = 64
LIFTED_MAX_CHECK_DEGREE = 16
LIFTED_MAX_VAR_DEGREE = 8


def check_lifted_cuda_args(graph: LiftedGraph, syndrome: torch.Tensor) -> None:
    """Raise unless the lifted graph fits the lifted kernels' compile-time
    limits and ``syndrome`` is a contiguous CUDA tensor."""
    if (graph.num_edge_blocks > LIFTED_MAX_EDGE_BLOCKS
            or graph.check_degree > LIFTED_MAX_CHECK_DEGREE
            or graph.var_degree > LIFTED_MAX_VAR_DEGREE):
        raise ValueError(
            f"lifted graph with {graph.num_edge_blocks} edge blocks, degrees "
            f"Dc={graph.check_degree}, Dv={graph.var_degree} exceeds the "
            f"kernel's {LIFTED_MAX_EDGE_BLOCKS}, {LIFTED_MAX_CHECK_DEGREE}, "
            f"{LIFTED_MAX_VAR_DEGREE}")
    if len(graph.group) not in (1, 2):
        raise ValueError(f"lift group {graph.group} is neither Z_P nor "
                         f"Z_l x Z_m")
    check_device(syndrome)


def lifted_description(graph: LiftedGraph):
    """The by-value description the lifted kernels read, as host int32
    arrays and ints: ``(edges, ranks, l, m, C, V, Dc, Dv, E)``.

    ``edges`` holds (check block, var block, a, b) per edge block in
    check-major order, with the shift normalised to [0, l) x [0, m) and a
    1-D group (P,) taken as (P, 1); ``ranks`` is the (Dv, V) table of edge
    ids, ``ranks[i*V + v]`` = var block v's rank-i edge block."""
    l, m = graph.group if len(graph.group) == 2 else (graph.group[0], 1)
    rows = []
    for c, v, shift in zip(graph.check_blocks, graph.var_blocks, graph.shifts):
        a, b = shift if len(shift) == 2 else (shift[0], 0)
        rows += [c, v, a % l, b % m]
    E = graph.num_edge_blocks
    edges = (ctypes.c_int32 * (4 * E))(*rows)
    ranks = (ctypes.c_int32 * E)(*graph._var_rank_edges)
    return (edges, ranks, l, m, graph.num_check_blocks, graph.num_var_blocks,
            graph.check_degree, graph.var_degree, E)


#: the C types of :func:`lifted_description`'s items, for ``argtypes``
LIFTED_ARGTYPES = [ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                   *([ctypes.c_int] * 7)]


def stream_of(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as the launcher's
    ``void*``."""
    return torch.cuda.current_stream(device).cuda_stream


def raise_on_error(name: str, err: int) -> None:
    """A launcher's ``cudaError_t`` -> an exception (never a fallback)."""
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError_t {err}")
