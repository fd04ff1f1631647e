"""Argument checks and launch helpers shared by the kernel wrappers.

Every kernel of the port takes one circulant graph, an int32 syndrome
``(num_checks, batch)`` with the batch trailing, the exponent table by value
and PyTorch's current stream; its C launcher returns a ``cudaError_t``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from qec_ldpc_tpu_torch.decoder.layout import CirculantGraph


def check_run_args(graph: CirculantGraph, syndrome: torch.Tensor,
                   max_iters: int, check_every: int) -> None:
    """Raise on what no kernel (and no plain version) takes."""
    if not isinstance(graph, CirculantGraph):
        raise TypeError(f"expected a CirculantGraph, got {type(graph).__name__}")
    if syndrome.dtype != torch.int32:
        raise TypeError(f"syndrome must be int32, got {syndrome.dtype}")
    if syndrome.dim() != 2 or syndrome.shape[0] != graph.num_checks:
        raise ValueError(f"syndrome shape {tuple(syndrome.shape)} does not "
                         f"match ({graph.num_checks}, batch)")
    if max_iters < 0 or check_every < 1:
        raise ValueError(f"max_iters={max_iters} check_every={check_every}")


def check_cuda_args(graph: CirculantGraph, syndrome: torch.Tensor,
                    max_var_degree: int, max_check_degree: int) -> None:
    """Raise unless ``syndrome`` is a contiguous CUDA tensor and the graph's
    degrees fit the kernel's compile-time limits."""
    if syndrome.device.type != "cuda":
        raise ValueError(f"unsupported device {syndrome.device}")
    if not syndrome.is_contiguous():
        raise ValueError("syndrome must be contiguous")
    if graph.B > max_var_degree or graph.L > max_check_degree:
        raise ValueError(f"graph degrees B={graph.B}, L={graph.L} exceed the "
                         f"kernel's {max_var_degree}, {max_check_degree}")


def shift_table(graph: CirculantGraph) -> ctypes.Array:
    """The (B, L) exponent table as a host int32 array the launcher copies
    into the kernel's by-value graph argument."""
    return (ctypes.c_int32 * (graph.B * graph.L))(
        *graph.table.astype(np.int32).ravel().tolist())


def stream_of(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as the launcher's
    ``void*``."""
    return torch.cuda.current_stream(device).cuda_stream


def raise_on_error(name: str, err: int) -> None:
    """A launcher's ``cudaError_t`` -> an exception (never a fallback)."""
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError_t {err}")
