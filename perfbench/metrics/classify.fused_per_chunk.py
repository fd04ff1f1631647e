"""Chunks whose counters came from the fused decide/classify kernel, per
chunk of the profiled stretch (counter ``classify.fused``): 1 where every
chunk's decisions and classification run as that one kernel, 0 where the
counting path runs them as separate operations (the CPU, relay, layered
min-sum); None where nothing counts it (the quality mode, a program
without the kernel)."""

from pb_spans import counter_per_chunk


def read(summary: dict) -> float | None:
    return counter_per_chunk(summary, "classify.fused")
