"""A float32 issue-rate probe through a hand-written CUDA kernel
(csrc/peak_chain.cu), for the roofline benchmark.

Not a port of a Pallas kernel: the counterpart of the peak-reality
experiment of ``benchmarks/roofline_breakdown.py`` (``chain_rate``, an XLA
loop), which ``benchmarks_torch/roofline_breakdown.py`` runs on the card.
Each element of ``x`` runs ``reps * depth`` dependent applications of one
operation in registers: "fma" (``y = fma(y, a, b)``, one rounding), "mul"
(``y = y * a``) or "min" (``y = min(y * a, b)``).

:func:`peak_chain` launches the kernel on the current CUDA stream for a
CUDA tensor and runs :func:`peak_chain_plain` for a CPU tensor; there is no
fallback.  The two agree bit for bit (the fma through
``sum_product.fma_f32``, XLA's and the kernel's single rounding).
``launches`` counts kernel launches (never the plain path).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from qec_ldpc_tpu_torch.decoder.min_sum import f32
from qec_ldpc_tpu_torch.decoder.sum_product import fma_f32
from qec_ldpc_tpu_torch.kernels import build, launch

SOURCES = ("peak_chain.cu",)
#: the operations, by the launcher's code
OPS = {"fma": 0, "mul": 1, "min": 2}
#: float operations per application of each
FLOPS_PER_OP = {"fma": 2, "mul": 1, "min": 2}

#: number of kernel launches made by :func:`peak_chain` in this process
launches = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load("qec_peak_chain", SOURCES)
    lib.qec_peak_chain.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    lib.qec_peak_chain.restype = ctypes.c_int
    return lib


def peak_chain_plain(x: torch.Tensor, op: str, depth: int, reps: int,
                     a: float, b: float) -> torch.Tensor:
    """The plain PyTorch version: one elementwise call per application."""
    a_t = torch.full_like(x, f32(a))
    b_t = torch.full_like(x, f32(b))
    y = x
    for _ in range(reps * depth):
        if op == "fma":
            y = fma_f32(y, a_t, b_t)
        elif op == "mul":
            y = y * a_t
        else:
            y = torch.minimum(y * a_t, b_t)
    return y


def peak_chain(x: torch.Tensor, op: str, depth: int, reps: int, a: float,
               b: float) -> torch.Tensor:
    """``op`` applied ``reps * depth`` times to every element of the 1-D
    float32 ``x`` (a new tensor)."""
    global launches
    if op not in OPS:
        raise ValueError(f"op must be one of {sorted(OPS)}, got {op!r}")
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x must be a contiguous 1-D float32 tensor")
    if depth < 0 or reps < 0:
        raise ValueError(f"depth={depth}, reps={reps}")
    if x.device.type == "cpu":
        return peak_chain_plain(x, op, depth, reps, a, b)
    launch.check_device(x)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _library().qec_peak_chain(
            x.data_ptr(), out.data_ptr(), x.numel(), depth, reps, f32(a),
            f32(b), OPS[op], launch.stream_of(x.device))
    launch.raise_on_error("qec_peak_chain", err)
    launches += 1
    return out
