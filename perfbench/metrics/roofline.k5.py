"""K5 (``lifted_min_sum_kernel``, kernels/lifted_min_sum_cuda.py) against
its roofline, plain and damped launches together.

The work is counted from the algorithm, never from the kernel: the plain
min-sum's 15 float operations per edge and iteration (19 damped: the
blend ``fma(1 - d, V_new, d * V_old)`` adds a subtraction, a product and a
fused multiply-add), times the graph's edges, times the lane-iterations
that the profiled chunks' inputs need (the reference counts them).  The
bytes are each launch's inputs read once and outputs written once: the
syndrome (int32 per check and lane), the damping when damped and the final
messages (float32 per edge and lane), and each lane's iteration count."""

import re

from pb_trace import roofline

KERNEL = re.compile(r"(?<![A-Za-z0-9_])lifted_min_sum_kernel(?![A-Za-z0-9_])")
OPS_PER_EDGE_ITERATION = 15
DAMPED_OPS_PER_EDGE_ITERATION = 19


def launches(summary: dict) -> list[dict]:
    return [r for r in summary["decodes"]
            if r["algorithm"] == "min-sum" and r["graph"] == "lifted"]


def ops(r: dict) -> float:
    per = DAMPED_OPS_PER_EDGE_ITERATION if r["damped"] else OPS_PER_EDGE_ITERATION
    return per * r["edges"] * r["lane_iters"]


def bytes_moved(r: dict) -> float:
    edges = r["edges"] * (2 if r["damped"] else 1)
    return 4.0 * r["lanes"] * (r["checks"] + edges + 1)


def read(summary: dict) -> float | None:
    return roofline(summary, KERNEL, launches, ops, bytes_moved)
