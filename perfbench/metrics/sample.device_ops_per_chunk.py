"""Device operations per chunk the host launched in sampling (``mc.sample``:
the error draws and the syndromes), its kernels included."""

from pb_spans import device_ops_per_chunk


def read(summary: dict) -> float | None:
    return device_ops_per_chunk(summary, "sample")
