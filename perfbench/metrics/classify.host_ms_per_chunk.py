"""Host self time per chunk (ms) of classification: ``mc.classify``
(``classify_batch``; the quality mode's compaction), in the profiled stretch
(the profiler slows the host)."""

from pb_spans import host_ms_per_chunk


def read(summary: dict) -> float | None:
    return host_ms_per_chunk(summary, "classify")
