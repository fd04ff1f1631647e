"""Host self time per chunk (ms) of the kernel wrappers: ``mc.launch``
(argument checks, the plan, ``shift_table`` / ``lifted_description``, the
ctypes call), in the profiled stretch (the profiler slows the host)."""

from pb_spans import host_ms_per_chunk


def read(summary: dict) -> float | None:
    return host_ms_per_chunk(summary, "launch")
