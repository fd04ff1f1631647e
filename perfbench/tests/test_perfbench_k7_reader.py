"""The reader ``k7.system_gbits_per_s`` on planted summaries: the counter
``osd.system_bits`` over K7's device seconds, and nothing where either is
missing."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))
import run  # noqa: E402

from qec_ldpc_tpu_torch import tracing  # noqa: E402

READER = HERE / "metrics" / "k7.system_gbits_per_s.py"
K7 = "void (anonymous namespace)::osd0_kernel<25>(int const*, int)"
OTHER = {"void lifted_min_sum_kernel<3, true>(int)": {"s": 0.5, "count": 4}}


def summary(k7_s: float | None) -> dict:
    events = dict(OTHER)
    if k7_s is not None:
        events[K7] = {"s": k7_s, "count": 2}
    return {"chunks": 2, "device_events": events}


@pytest.fixture
def recorded():
    rec = tracing.profiled()
    rec.clear()
    rec.spans += [["mc.group", 0, 1, None, None]]
    yield rec
    rec.clear()


@pytest.mark.parametrize("bits,k7_s,want", [
    (6_000_000_000, 2.0, 3.0),       # 6 Gbit in 2 s of K7
    (378 * 757 * 100, 1e-3, 378 * 757 * 100 / 1e-3 / 1e9),
    (None, 2.0, None),                # no counter: a program without it
    (0, 2.0, None),                   # no lane handed to OSD
    (6_000_000_000, None, None),      # no K7 event: the CPU
])
def test_k7_reader(recorded, bits, k7_s, want):
    if bits is not None:
        recorded.counters["osd.system_bits"] = bits
    got = run.load(READER).read(summary(k7_s))
    assert got == (None if want is None else pytest.approx(want))


def test_k7_reader_without_spans_reads_nothing():
    tracing.profiled().clear()
    assert run.load(READER).read(summary(2.0)) is None
