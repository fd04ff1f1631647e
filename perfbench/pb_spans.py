"""The program's spans and counters (``qec_ldpc_tpu_torch/tracing.py``) by
layer, for the per-layer readers (``metrics/<layer>.<quantity>.py``).

Host self time and counters come from the recording of the profiled stretch
(its host times slowed by the profiler): in a ``run.py --trace 1`` run, what
the program recorded while the profiler ran (``tracing.profiled()``); in
``layers.py``, the stretch recorded inside ``tracing.recording()``, which
also reads a stretch recorded with no profiler.  A program without
spans has no ``tracing`` module, and the readers return None there.

Device time, device operations and idle time by layer come from the
profiler's events (:func:`device_layers`): each device operation goes to
the program span in which the host launched it (the CUDA runtime call with
the operation's correlation id), each idle gap to the span the host was in
at the gap's midpoint; ``mc.launch`` and ``mc.fetch`` count for the layer
around them, and time in no program span, or in ``outside``, is "outside".
"""

from __future__ import annotations

import bisect
import importlib.util
from pathlib import Path

from torch.autograd import DeviceType

import pb_trace

HERE = Path(__file__).resolve().parent

#: the layer of each program span of the hot path
LAYER_OF = {"mc.point": "driver", "mc.point_setup": "driver",
            "mc.group": "driver", "mc.chunk": "driver", "mc.sample": "sample",
            "mc.decode": "decode", "mc.relay": "decode",
            "mc.classify": "classify", "mc.osd": "osd", "outside": "outside"}
#: spans that count for the layer around them
TRANSPARENT = ("mc.launch", "mc.fetch")
#: host self time: the spans each quantity adds up (point set-up apart)
HOST_SPANS = {"driver": ("mc.point", "mc.group", "mc.chunk"),
              "sample": ("mc.sample",), "decode": ("mc.decode", "mc.relay"),
              "launch": ("mc.launch",), "classify": ("mc.classify",),
              "fetch": ("mc.fetch",), "osd": ("mc.osd",)}


def _kernels():
    """The hand-written kernels' name pattern, as
    ``aux_device_ms_per_chunk`` reads it."""
    path = HERE / "metrics" / "aux_device_ms_per_chunk.py"
    spec = importlib.util.spec_from_file_location("aux_reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.KERNELS


KERNELS = _kernels()


def profiled(summary: dict):
    """The recording of the profiled stretch: ``summary["spans"]`` where the
    harness recorded the stretch itself (``layers.py``), else what the
    program recorded under the profiler; None where there is none (a
    program without spans)."""
    rec = summary.get("spans")
    if rec is None:
        try:
            from qec_ldpc_tpu_torch import tracing
        except ImportError:
            return None
        rec = tracing.profiled()
    return rec if rec.spans else None


def host_ms(rec, names) -> float | None:
    """Self milliseconds of the spans named ``names`` in ``rec``; None where
    there is none."""
    if rec is None:
        return None
    own = [ns for s, ns in zip(rec.spans, rec.self_ns()) if s[0] in names]
    return 1e-6 * sum(own) if own else None


def host_ms_per_chunk(summary: dict, layer: str) -> float | None:
    """A reader: the layer's host self time per chunk of the profiled
    stretch."""
    ms = host_ms(profiled(summary), HOST_SPANS[layer])
    if ms is None or not summary["chunks"]:
        return None
    return ms / summary["chunks"]


def counter_per_chunk(summary: dict, name: str) -> float | None:
    """A reader: a counter of the profiled stretch per chunk."""
    rec = profiled(summary)
    if rec is None or name not in rec.counters or not summary["chunks"]:
        return None
    return rec.counters[name] / summary["chunks"]


def device_ms_per_chunk(summary: dict, layer: str) -> float | None:
    """A reader: the layer's device time outside the hand-written kernels
    per chunk (``summary["device_layers"]``, from :func:`device_layers`)."""
    d = summary.get("device_layers", {}).get(layer)
    return None if d is None else 1e3 * d["aux_s"] / summary["chunks"]


def device_ops_per_chunk(summary: dict, layer: str) -> float | None:
    """A reader: the layer's device operations per chunk."""
    d = summary.get("device_layers", {}).get(layer)
    return None if d is None else d["count"] / summary["chunks"]


def idle_ms_per_chunk(summary: dict, layer: str) -> float | None:
    """A reader: the idle time per chunk while the host was in the layer."""
    if "idle_layers" not in summary:
        return None
    return 1e3 * summary["idle_layers"].get(layer, 0.0) / summary["chunks"]


class _Spans:
    """The program's spans in a trace, on its clock: the layer at a time."""

    def __init__(self, cpu_events):
        # by start, the enclosing span first where two start together
        spans = sorted(((e.time_range.start, e.time_range.end, e.name)
                        for e in cpu_events
                        if e.name in LAYER_OF or e.name in TRANSPARENT),
                       key=lambda x: (x[0], -x[1]))
        self.starts, self.items = [], []
        stack = []
        for s, e, name in spans:
            while stack and stack[-1][1] <= s:
                stack.pop()
            layer = LAYER_OF.get(name) or (stack[-1][2] if stack
                                           else "outside")
            stack.append((s, e, layer))
            self.starts.append(s)
            self.items.append((s, e, layer))

    def __bool__(self) -> bool:
        return bool(self.items)

    def layer_at(self, t: float) -> str:
        """The layer of the innermost span covering ``t``."""
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, -1, -1):
            s, e, layer = self.items[j]
            if e >= t:
                return layer
        return "outside"


def without_annotations(events) -> list:
    """The events less the device-side annotations a profiler adds for each
    span (a range on the device's timeline named as the span), which are no
    device operations."""
    return [e for e in events
            if not (e.device_type == DeviceType.CUDA
                    and (e.name in LAYER_OF or e.name in TRANSPARENT))]


def device_layers(events) -> tuple[dict, dict, int] | None:
    """(device time and operations by layer, idle seconds by layer, device
    operations launched in no program span) of a profiled stretch's events;
    None where the trace holds no program span."""
    cpu, launches, dev = [], {}, []
    for e in without_annotations(events):
        if e.device_type == DeviceType.CUDA:
            dev.append(e)
        elif e.device_type == DeviceType.CPU:
            cpu.append(e)
            if e.name.startswith("cu"):  # a CUDA runtime or driver call
                launches[e.id] = e.time_range.start
    spans = _Spans(cpu)
    if not spans:
        return None
    layers, unclaimed = {}, 0
    for d in dev:
        t = launches.get(d.id)
        layer = "outside" if t is None else spans.layer_at(t)
        unclaimed += layer == "outside"
        acc = layers.setdefault(layer, {"aux_s": 0.0, "s": 0.0, "count": 0})
        s = (d.time_range.end - d.time_range.start) * 1e-6
        acc["s"] += s
        acc["aux_s"] += 0.0 if KERNELS.search(d.name) else s
        acc["count"] += 1
    busy = pb_trace._merge(sorted((d.time_range.start, d.time_range.end,
                                   d.name) for d in dev))
    idle = {}
    for (_, a), (b, _) in zip(busy, busy[1:]):
        layer = spans.layer_at(0.5 * (a + b))
        idle[layer] = idle.get(layer, 0.0) + (b - a) * 1e-6
    return layers, idle, unclaimed
