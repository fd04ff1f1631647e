"""Host self time per chunk (ms) of the blocking reads: ``mc.fetch`` (the
group's ``.cpu()``, ``_Fetch.get()``, relay's flag), the host waiting on the
device, in the profiled stretch (the profiler slows the host)."""

from pb_spans import host_ms_per_chunk


def read(summary: dict) -> float | None:
    return host_ms_per_chunk(summary, "fetch")
