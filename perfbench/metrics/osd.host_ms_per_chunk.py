"""Host self time per chunk (ms) of OSD: ``mc.osd`` (the failed lanes'
solve, splice and classification), in the profiled stretch (the profiler
slows the host)."""

from pb_spans import host_ms_per_chunk


def read(summary: dict) -> float | None:
    return host_ms_per_chunk(summary, "osd")
