"""Chunks whose two graphs, X and Z, were decoded by one kernel launch, per
chunk of the profiled stretch (counter ``decode.paired``): 1 where every
chunk's min-sum decode runs both lifted sectors as one K5 launch, 0 where
each sector takes a launch of its own (the CPU, circulant codes,
sum-product, graphs that cannot share a launch); None where nothing counts
it (a program without the paired launch)."""

from pb_spans import counter_per_chunk


def read(summary: dict) -> float | None:
    return counter_per_chunk(summary, "decode.paired")
