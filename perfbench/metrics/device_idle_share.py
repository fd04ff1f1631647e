"""Share of the wall time in which the device runs nothing: one minus the
device busy time per chunk (profiled stretch) over the wall time per chunk
of the unprofiled window of the same run (the profiler slows the host)."""


def read(summary: dict) -> float | None:
    busy = summary["device_busy_s"]
    if busy <= 0 or not summary["chunks"]:
        return None
    return 100.0 * (1.0 - busy / summary["chunks"]
                    / summary["unprofiled_s_per_chunk"])
