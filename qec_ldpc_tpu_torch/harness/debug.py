"""Debug array dumps and profiling hooks (PyTorch port).

The port of ``qec_ldpc_tpu/harness/debug.py``:

* ``ArrayOutput.h:6-96``: append-mode whitespace dumps of 1-d and 2-d int or
  float arrays, used to trace BP internals.  :func:`write_array` writes the
  same bytes as the JAX package's: a 2-d array one row per line,
  space-separated, then a blank line; a 1-d array as one row.
* The reference's per-phase timers (``QEC_LDPC_CSS.cu:316-328,460-473``,
  ``:393-412``): :func:`trace` records a ``torch.profiler`` trace with the
  port's spans in it, and their self times and counters
  (qec_ldpc_tpu_torch/tracing.py).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from qec_ldpc_tpu_torch import tracing


def write_array(path: str, arr, fmt: str | None = None) -> None:
    """Append a 1-d or 2-d array (NumPy or a tensor on any device) in the
    reference ArrayOutput format."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    a = np.asarray(arr)
    if a.ndim == 1:
        a = a[None, :]
    if a.ndim != 2:
        raise ValueError(f"write_array supports 1d/2d arrays, got shape {a.shape}")
    if fmt is None:
        fmt = "%g" if np.issubdtype(a.dtype, np.floating) else "%d"
    with open(path, "a") as f:
        for row in a:
            f.write(" ".join(fmt % x for x in row) + "\n")
        f.write("\n")


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Record a ``torch.profiler`` trace of the block (the CPU, and the CUDA
    device when one is present) and write it under ``log_dir`` as
    ``<host>_<pid>.<time>.pt.trace.json``, a Chrome trace that Perfetto and
    TensorBoard's PyTorch profiler plugin read, with the port's spans as
    ranges.  Yields the block's :class:`~qec_ldpc_tpu_torch.tracing.Recording`
    (its ``report()``: self time per span, and the counters).  No-op
    yielding None when ``log_dir`` is None."""
    if log_dir is None:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with tracing.recording() as spans, torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield spans
