"""Device operations per chunk the host launched in decoding (``mc.decode``,
``mc.relay`` and the launches in them: lane sort, decide, the syndrome
check, the error-code bits), its kernels included."""

from pb_spans import device_ops_per_chunk


def read(summary: dict) -> float | None:
    return device_ops_per_chunk(summary, "decode")
