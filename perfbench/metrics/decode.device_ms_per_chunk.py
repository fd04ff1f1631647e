"""Device time per chunk (ms) of the operations the host launched in
decoding (``mc.decode``, ``mc.relay`` and the launches in them: lane sort,
decide, the syndrome check, the error-code bits), the hand-written kernels
left out; with the other layers' it splits ``aux_device_ms_per_chunk``."""

from pb_spans import device_ms_per_chunk


def read(summary: dict) -> float | None:
    return device_ms_per_chunk(summary, "decode")
