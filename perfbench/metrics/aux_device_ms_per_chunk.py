"""Device time per chunk outside the decode and OSD kernels: sampling,
syndromes, decisions, classification and the quality mode's compaction."""

import re

#: the port's hand-written decode and OSD kernels, by the names the
#: profiler shows
KERNELS = re.compile(
    r"(?<![A-Za-z0-9_])(bp_sum_product_kernel|min_sum_kernel|"
    r"layered_min_sum_kernel|lifted_min_sum_kernel|lifted_bp_kernel|"
    r"osd0_kernel|sharded_step_kernel)(?![A-Za-z0-9_])")


def read(summary: dict) -> float | None:
    if not summary["device_events"] or not summary["chunks"]:
        return None
    kernels = sum(v["s"] for k, v in summary["device_events"].items()
                  if KERNELS.search(k))
    return 1e3 * (summary["device_busy_s"] - kernels) / summary["chunks"]
