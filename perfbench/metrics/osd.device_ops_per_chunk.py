"""Device operations per chunk the host launched in OSD (``mc.osd``:
ranking, gathers, the splice, the repaired lanes' classification), its
kernels included."""

from pb_spans import device_ops_per_chunk


def read(summary: dict) -> float | None:
    return device_ops_per_chunk(summary, "osd")
