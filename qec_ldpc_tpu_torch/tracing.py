"""Spans and counters inside the port's hot path.

A span is a named interval of the host's clock around one layer's work: the
Monte-Carlo driver (``mc.point``, ``mc.group``, ``mc.chunk``), sampling
(``mc.sample``), decoding (``mc.decode``, ``mc.relay``), a kernel wrapper
call (``mc.launch``), classification (``mc.classify``), OSD (``mc.osd``),
a blocking read of the device (``mc.fetch``) and set-up (``setup.graphs``,
``setup.logical``, ``kernels.load``).  A counter adds up values already on
the host (``relay.retries``, ``osd.lanes``, ``osd.system_bits``: the bits of
the augmented systems OSD eliminates, ``kernels.builds``, and the
driver's ``mc.graph_captures``, ``mc.graph_replays``, ``classify.fused``,
the chunks counted by the fused decide/classify kernel, and
``decode.paired``, the chunks whose two graphs decode in one launch).
Neither adds a device operation or a host read.

Recording is off by default: :func:`span` then returns one shared no-op
object and :func:`count` returns at once, so the off path costs a global
load and a flag test.  It is on

* inside :func:`recording`, which yields the :class:`Recording` of the
  block;
* while a ``torch.profiler`` runs, outside any :func:`recording`: the spans
  go to :func:`profiled`, which holds every profiled stretch since it was
  last cleared, and leave the profiler's trace as it would be without
  them.

Inside :func:`recording`, while a profiler runs, each span also opens
``torch.profiler.record_function(name)``, so the layers show in its trace on
its own clock, and each device operation lies under the span that launched
it (the profiler then also shows each range on the device's timeline, as
an annotation).

A span records ``[name, t0_ns, t1_ns, parent, chunk]``: the
``time.perf_counter_ns`` of its entry and exit, the index of the enclosing
span (None at the top) and the global chunk id the spans of one chunk share
(inherited from the enclosing span when not given).  Callers' code that runs between spans, such as the
driver's progress callback, sits in a span named ``outside``.
"""

from __future__ import annotations

import contextlib
import time

import torch

#: the spans that are not the program's own work
OUTSIDE = "outside"


class _NoSpan:
    """The shared span of recording off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP = _NoSpan()


class Recording:
    """Spans and counters of one recorded stretch."""

    def __init__(self) -> None:
        #: ``[name, t0_ns, t1_ns, parent, chunk]`` in the order they opened
        self.spans: list[list] = []
        self.counters: dict[str, int] = {}
        self._open: list[int] = []

    def clear(self) -> None:
        self.spans.clear()
        self.counters.clear()

    def self_ns(self) -> list[int]:
        """Each span's self time: its duration less its children's."""
        out = [t1 - t0 for _, t0, t1, _, _ in self.spans]
        for _, t0, t1, parent, _ in self.spans:
            if parent is not None:
                out[parent] -= t1 - t0
        return out

    def report(self) -> str:
        """Self milliseconds and calls per span name, then the counters."""
        totals: dict[str, float] = {}
        calls: dict[str, int] = {}
        for (name, *_), ns in zip(self.spans, self.self_ns()):
            totals[name] = totals.get(name, 0.0) + ns * 1e-6
            calls[name] = calls.get(name, 0) + 1
        lines = [f"{name}: {totals[name]:.2f} ms over {calls[name]} call(s)"
                 for name in sorted(totals)]
        lines += [f"{name}: {self.counters[name]}"
                  for name in sorted(self.counters)]
        return "\n".join(lines)


class _Span:
    __slots__ = ("rec", "name", "chunk", "annotate", "index", "rf")

    def __init__(self, rec: Recording, name: str, chunk: int | None,
                 annotate: bool):
        self.rec, self.name, self.chunk = rec, name, chunk
        self.annotate, self.rf = annotate, None

    def __enter__(self):
        rec = self.rec
        parent = rec._open[-1] if rec._open else None
        chunk = self.chunk
        if chunk is None and parent is not None:
            chunk = rec.spans[parent][4]
        self.index = len(rec.spans)
        rec.spans.append([self.name, 0, 0, parent, chunk])
        rec._open.append(self.index)
        if self.annotate and torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        rec.spans[self.index][1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.rec._open.pop()
        self.rec.spans[self.index][2] = t1
        return False


_active: Recording | None = None
_profiled = Recording()


def span(name: str, chunk: int | None = None):
    """A context manager around one layer's work (see the module's
    docstring)."""
    rec = _active
    if rec is None:
        if not torch.autograd._profiler_enabled():
            return NOOP
        return _Span(_profiled, name, chunk, False)
    return _Span(rec, name, chunk, True)


def count(name: str, n: int = 1) -> None:
    """Add ``n``, a value already on the host, to counter ``name``."""
    rec = _active
    if rec is None:
        if not torch.autograd._profiler_enabled():
            return
        rec = _profiled
    rec.counters[name] = rec.counters.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Record every span and counter of the block; yields the Recording."""
    global _active
    prev, rec = _active, Recording()
    _active = rec
    try:
        yield rec
    finally:
        _active = prev


def profiled() -> Recording:
    """What was recorded while a ``torch.profiler`` ran outside any
    :func:`recording`, since its last ``clear()``."""
    return _profiled
