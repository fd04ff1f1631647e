"""Lanes handed to OSD per chunk (counter ``osd.lanes``: the X- and Z-failed
lanes, from the counts already on the host)."""

from pb_spans import counter_per_chunk


def read(summary: dict) -> float | None:
    return counter_per_chunk(summary, "osd.lanes")
