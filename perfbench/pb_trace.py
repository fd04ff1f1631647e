"""From a ``torch.profiler`` trace of a stretch of chunks to the fixed
summary the per-layer readers (``metrics/<name>.py``) take, and to the
result line's ``breakdown``.

The arithmetic is ``profile_cells.py``'s: device busy is taken from the
device operations (kernels, copies, fills) alone, and the idle share sets
that against the wall time of unprofiled chunks, since the profiler slows
the host.  Busy here is the union of the operations' intervals, so two
operations that overlap count once.  An idle gap is labelled by the host
operation in flight at its midpoint: the innermost profiled CPU operation
that covers it."""

from __future__ import annotations

import bisect
from collections import defaultdict

from torch.autograd import DeviceType

TOP = 10
NAME_CHARS = 160


def _intervals(prof):
    """(device [(start_us, end_us, name)], cpu [...]) of a finished trace."""
    dev, cpu = [], []
    for e in prof.events():
        tr = e.time_range
        item = (float(tr.start), float(tr.end), e.name)
        if e.device_type == DeviceType.CUDA:
            dev.append(item)
        elif e.device_type == DeviceType.CPU:
            cpu.append(item)
    dev.sort()
    cpu.sort()
    return dev, cpu


def _merge(dev):
    busy = []
    for s, e, _ in dev:
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    return busy


def _label(cpu, starts, mid: float) -> str:
    """The innermost CPU operation covering ``mid`` (the latest started);
    where the host runs Python between operations, "after" the operation
    that ended last before ``mid``."""
    i = bisect.bisect_right(starts, mid) - 1
    last, last_end = None, -1.0
    for j in range(i, max(-1, i - 256), -1):
        s, e, name = cpu[j]
        if e >= mid:
            return name
        if e > last_end:
            last, last_end = name, e
    return f"after {last}" if last else "host, no profiled operation"


def summarize(prof, chunks: int, wall_s: float) -> tuple[dict, dict]:
    """(summary, breakdown) of a profiled stretch of ``chunks`` chunks that
    took ``wall_s`` seconds on the host clock (the window where the trace
    holds no event)."""
    dev, cpu = _intervals(prof)
    events = defaultdict(lambda: {"s": 0.0, "count": 0})
    for s, e, name in dev:
        events[name]["s"] += (e - s) * 1e-6
        events[name]["count"] += 1
    busy = _merge(dev)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    # the traced window on the trace's own clock: from its first event to
    # its last, device work queued before the stretch began included
    every = dev + cpu
    window_s = wall_s
    if every:
        span_s = (max(e for _, e, _ in every)
                  - min(s for s, _, _ in every)) * 1e-6
        window_s = span_s if span_s > 0 else wall_s
    starts = [c[0] for c in cpu]
    gaps = defaultdict(float)
    for (_, a), (b, _) in zip(busy, busy[1:]):
        gaps[_label(cpu, starts, 0.5 * (a + b))[:NAME_CHARS]] += (b - a) * 1e-6
    summary = {
        "chunks": chunks,
        "window_s": window_s,
        "device_busy_s": busy_s,
        "device_events": dict(events),
        "memcpy_dtoh": sum(v["count"] for k, v in events.items()
                           if "DtoH" in k),
    }
    breakdown = {
        "device_ops": [[k[:NAME_CHARS], v["s"]] for k, v in sorted(
            events.items(), key=lambda kv: -kv[1]["s"])[:TOP]],
        "idle_gaps": [[k, v] for k, v in sorted(
            gaps.items(), key=lambda kv: -kv[1])[:TOP]],
    }
    return summary, breakdown


def roofline(summary: dict, kernel, launches, ops, bytes_moved) -> float | None:
    """A kernel's share of its roofline, in %: its bound, max(operations /
    peak FLOP/s, bytes / peak bytes/s) summed over ``launches(summary)``,
    over the device time of the events whose names match ``kernel``.  None
    where the stretch ran no such launch."""
    seconds = sum(v["s"] for k, v in summary["device_events"].items()
                  if kernel.search(k))
    work = launches(summary)
    if seconds <= 0 or not work:
        return None
    peaks = summary["peaks"]
    bound = max(sum(map(ops, work)) / peaks["fp32_flops_per_s"],
                sum(map(bytes_moved, work)) / peaks["hbm_bytes_per_s"])
    return 100.0 * bound / seconds
