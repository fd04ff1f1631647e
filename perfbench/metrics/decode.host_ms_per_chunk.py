"""Host self time per chunk (ms) of decoding around the kernels:
``mc.decode`` per graph (casts, decide, the syndrome check, the error-code
bits) and ``mc.relay`` (the retries' draws and decisions), in the profiled
stretch (the profiler slows the host)."""

from pb_spans import host_ms_per_chunk


def read(summary: dict) -> float | None:
    return host_ms_per_chunk(summary, "decode")
