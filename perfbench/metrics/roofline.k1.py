"""K1 (``bp_sum_product_kernel``, kernels/bp_cuda.py) against its roofline.

The work is counted from the algorithm, never from the kernel: the plain
sum-product's 18 float operations per edge and iteration, times the graph's
edges, times the lane-iterations that the profiled chunks' inputs need at
the configuration's check cadence (the reference counts them).  The bytes
are each launch's inputs read once and outputs written once: the syndrome
(int32 per check and lane), the final messages (float32 per edge and lane)
and each lane's iteration count.  Share = max(ops / peak FLOP/s, bytes /
peak bytes/s) over K1's device time, against the published peaks
(``pb_trace.roofline``)."""

import re

from pb_trace import roofline

KERNEL = re.compile(r"(?<![A-Za-z0-9_])bp_sum_product_kernel(?![A-Za-z0-9_])")
OPS_PER_EDGE_ITERATION = 18


def launches(summary: dict) -> list[dict]:
    return [r for r in summary["decodes"]
            if r["algorithm"] == "sum-product" and r["graph"] == "circulant"]


def ops(r: dict) -> float:
    return OPS_PER_EDGE_ITERATION * r["edges"] * r["lane_iters"]


def bytes_moved(r: dict) -> float:
    return 4.0 * r["lanes"] * (r["checks"] + r["edges"] + 1)


def read(summary: dict) -> float | None:
    return roofline(summary, KERNEL, launches, ops, bytes_moved)
