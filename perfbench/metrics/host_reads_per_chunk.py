"""Device-to-host copies per chunk in the profiled stretch: the driver's
counter fetches and relay's one flag read per retry."""


def read(summary: dict) -> float | None:
    if not summary["device_events"] or not summary["chunks"]:
        return None
    return summary["memcpy_dtoh"] / summary["chunks"]
