"""Device operations (kernels, copies, fills) per chunk in the profiled
stretch: the launch count of the Monte-Carlo driver's host path."""


def read(summary: dict) -> float | None:
    ops = sum(v["count"] for v in summary["device_events"].values())
    if not ops or not summary["chunks"]:
        return None
    return ops / summary["chunks"]
