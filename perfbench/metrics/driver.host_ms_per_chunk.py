"""Host self time per chunk (ms) of the Monte-Carlo driver's own Python and
accumulators: the self time of ``mc.point``, ``mc.group`` and ``mc.chunk``
(``torch.zeros``, ``+=``, ``cat``, the quality mode's pipeline), in the
profiled stretch (the profiler slows the host)."""

from pb_spans import host_ms_per_chunk


def read(summary: dict) -> float | None:
    return host_ms_per_chunk(summary, "driver")
