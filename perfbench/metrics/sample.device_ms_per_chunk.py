"""Device time per chunk (ms) of the operations the host launched in
sampling (``mc.sample``: the error draws and the syndromes), the
hand-written kernels left out; with the other layers' it splits
``aux_device_ms_per_chunk``."""

from pb_spans import device_ms_per_chunk


def read(summary: dict) -> float | None:
    return device_ms_per_chunk(summary, "sample")
