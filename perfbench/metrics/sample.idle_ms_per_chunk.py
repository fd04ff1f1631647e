"""Device idle time per chunk (ms) while the host was in ``mc.sample``: each
gap between device operations goes to the span covering its midpoint."""

from pb_spans import idle_ms_per_chunk


def read(summary: dict) -> float | None:
    return idle_ms_per_chunk(summary, "sample")
