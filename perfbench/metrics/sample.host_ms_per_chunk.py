"""Host self time per chunk (ms) of sampling: ``mc.sample``
(``chunk_generator``'s seeding of a device generator, the error draws, the
syndromes), in the profiled stretch (the profiler slows the host)."""

from pb_spans import host_ms_per_chunk


def read(summary: dict) -> float | None:
    return host_ms_per_chunk(summary, "sample")
