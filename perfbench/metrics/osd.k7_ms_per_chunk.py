"""K7 (``osd0_kernel``, decoder/osd_device.py) device time per chunk."""

import re

KERNEL = re.compile(r"(?<![A-Za-z0-9_])osd0_kernel(?![A-Za-z0-9_])")


def read(summary: dict) -> float | None:
    s = sum(v["s"] for k, v in summary["device_events"].items()
            if KERNEL.search(k))
    if s <= 0 or not summary["chunks"]:
        return None
    return 1e3 * s / summary["chunks"]
