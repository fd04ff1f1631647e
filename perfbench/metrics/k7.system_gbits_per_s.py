"""K7 (``osd0_kernel``, decoder/osd_device.py) in bits of work per second:
the bits of the augmented systems ``[H_pi | s]`` that OSD-0 eliminated in
the profiled stretch (counter ``osd.system_bits``: lanes x m x (n + 1),
summed over the sectors), over K7's device time, in Gbit/s.  Per bit of
work, so comparable across codes and however many lanes BP leaves.  None
where either is missing: no K7 event (the CPU), no counter (a program
without it), or no lane handed to OSD."""

import re

from pb_spans import profiled

KERNEL = re.compile(r"(?<![A-Za-z0-9_])osd0_kernel(?![A-Za-z0-9_])")


def read(summary: dict) -> float | None:
    s = sum(v["s"] for k, v in summary["device_events"].items()
            if KERNEL.search(k))
    rec = profiled(summary)
    bits = None if rec is None else rec.counters.get("osd.system_bits")
    if s <= 0 or not bits:
        return None
    return bits / s / 1e9
