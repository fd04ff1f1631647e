"""Device operations per chunk the host launched in classification
(``mc.classify``: ``classify_batch``, the quality mode's compaction), its
kernels included."""

from pb_spans import device_ops_per_chunk


def read(summary: dict) -> float | None:
    return device_ops_per_chunk(summary, "classify")
