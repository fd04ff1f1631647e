"""The readers of the program's spans (``pb_spans.py``, the
``metrics/<layer>.*`` readers) on synthetic events and recordings, and
``layers.py`` and ``run.py --trace 1`` on the CPU at a tiny size."""

from __future__ import annotations

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))
import layers  # noqa: E402
import pb_spans  # noqa: E402
import run  # noqa: E402
from test_perfbench_run import SEED, tiny  # noqa: E402

from qec_ldpc_tpu_torch import tracing  # noqa: E402

BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
SPAN_READERS = sorted(p.stem for p in (HERE / "metrics").glob("*.py")
                      if p.stem.split(".")[0] in
                      ("driver", "sample", "decode", "launch", "classify",
                       "fetch", "osd") and p.stem != "osd.k7_ms_per_chunk")


def event(name, start, end, device=DeviceType.CPU, id=0):
    return SimpleNamespace(name=name, device_type=device, id=id,
                           time_range=SimpleNamespace(start=start, end=end))


def kernel(name, start, end, id):
    return event(name, start, end, DeviceType.CUDA, id)


#: a chunk on the profiler's clock (us): a sample span launching one
#: operation, a decode span whose launch span starts a decode kernel, a
#: fetch after the chunk in the group span, and a callback outside
EVENTS = [
    event("mc.group", 0, 200), event("mc.chunk", 0, 100),
    event("mc.sample", 10, 20), event("cudaLaunchKernel", 12, 13, id=1),
    event("aten::add", 11, 14),
    event("mc.decode", 30, 60), event("mc.launch", 40, 50),
    event("cudaLaunchKernel", 45, 46, id=2),
    event("mc.classify", 70, 90), event("cudaLaunchKernel", 72, 73, id=3),
    event("mc.fetch", 120, 180), event("cudaMemcpyAsync", 121, 122, id=4),
    event("outside", 200, 300), event("cudaLaunchKernel", 250, 251, id=5),
    kernel("elementwise_kernel", 15, 18, 1),
    kernel("void bp_sum_product_kernel<4>(int)", 50, 70, 2),
    kernel("reduce_kernel", 74, 80, 3),
    kernel("Memcpy DtoH (Device -> Pinned)", 122, 123, 4),
    kernel("fill_kernel", 260, 262, 5),
    kernel("not_launched_kernel", 280, 281, 99),
]


def test_device_operations_go_to_the_span_that_launched_them():
    layers_, idle, unclaimed = pb_spans.device_layers(EVENTS)
    assert layers_["sample"] == pytest.approx(
        {"aux_s": 3e-6, "s": 3e-6, "count": 1})
    # the launch span counts for decode; K1 is not aux time
    assert layers_["decode"] == pytest.approx(
        {"aux_s": 0.0, "s": 20e-6, "count": 1})
    assert layers_["classify"]["count"] == 1
    # the group's fetch counts for the driver
    assert layers_["driver"]["count"] == 1
    # launched in the callback, or with no launch found
    assert layers_["outside"]["count"] == 2 and unclaimed == 2
    # gaps: 18-50 (mid 34, decode), 70-74 (72, classify), 80-122 (101,
    # group: driver), 123-260 (191.5, group), 262-280 (271, outside)
    assert idle == pytest.approx({"decode": 32e-6, "classify": 4e-6,
                                  "driver": 42e-6 + 137e-6,
                                  "outside": 18e-6})


def test_no_program_span_reads_nothing():
    assert pb_spans.device_layers([e for e in EVENTS
                                   if not e.name.startswith("mc.")
                                   and e.name != "outside"]) is None


@pytest.fixture
def recorded():
    """A profiled stretch of two chunks, as the program records it."""
    rec = tracing.profiled()
    rec.clear()
    ms = 1_000_000
    rec.spans += [["mc.group", 0, 20 * ms, None, None]]
    for c in range(2):
        t = 10 * c * ms
        rec.spans += [
            ["mc.chunk", t, t + 9 * ms, 0, c],
            ["mc.sample", t + ms, t + 2 * ms, len(rec.spans), c],
            ["mc.decode", t + 2 * ms, t + 5 * ms, len(rec.spans), c],
            ["mc.launch", t + 3 * ms, t + 4 * ms, len(rec.spans) + 2, c],
            ["mc.classify", t + 5 * ms, t + 6 * ms, len(rec.spans), c],
            ["mc.osd", t + 6 * ms, t + 8 * ms, len(rec.spans), c],
        ]
    rec.spans += [["mc.fetch", 19 * ms, 20 * ms, 0, None]]
    rec.counters["osd.lanes"] = 30
    yield rec
    rec.clear()


def test_host_readers(recorded):
    summary = {"chunks": 2}
    read = {name: run.load(HERE / "metrics" / f"{name}.py").read(summary)
            for name in SPAN_READERS if ".host_" in name or ".lanes" in name}
    # each chunk's 9 ms less its children's 7 (the launch is the
    # decode's), and the group's 1 ms left over by the chunks and the fetch
    assert read == pytest.approx({
        "driver.host_ms_per_chunk": (2.0 + 2.0 + 1.0) / 2,
        "sample.host_ms_per_chunk": 1.0,
        "decode.host_ms_per_chunk": 2.0, "launch.host_ms_per_chunk": 1.0,
        "classify.host_ms_per_chunk": 1.0, "osd.host_ms_per_chunk": 2.0,
        "fetch.host_ms_per_chunk": 0.5, "osd.lanes_per_chunk": 15.0})


def test_host_readers_without_spans_read_nothing():
    tracing.profiled().clear()
    for name in SPAN_READERS:
        assert run.load(HERE / "metrics" / f"{name}.py").read(
            {"chunks": 2}) is None, name


def test_device_readers():
    found, idle, _ = pb_spans.device_layers(EVENTS)
    summary = {"chunks": 2, "device_layers": found, "idle_layers": idle}
    read = {name: run.load(HERE / "metrics" / f"{name}.py").read(summary)
            for name in SPAN_READERS
            if ".device_" in name or ".idle_" in name}
    # no OSD span launched anything
    assert read.pop("osd.device_ms_per_chunk") is None
    assert read.pop("osd.device_ops_per_chunk") is None
    assert read == pytest.approx({
        "sample.device_ms_per_chunk": 1.5e-3,
        "decode.device_ms_per_chunk": 0.0,
        "classify.device_ms_per_chunk": 3e-3,
        "sample.device_ops_per_chunk": 0.5,
        "decode.device_ops_per_chunk": 0.5,
        "classify.device_ops_per_chunk": 0.5,
        "driver.idle_ms_per_chunk": 179e-3 / 2,
        "sample.idle_ms_per_chunk": 0.0,
        "decode.idle_ms_per_chunk": 16e-3,
        "classify.idle_ms_per_chunk": 2e-3})


def test_benchmark_lists_only_readers_the_run_feeds():
    """A ``run.py --trace 1`` run feeds the host readers and the counter
    (the program's profiled recording); the device split needs a summary
    that only ``layers.py`` builds."""
    listed = {m["name"] for m in BENCH["per_layer"]}
    assert {n for n in SPAN_READERS if ".host_" in n or ".lanes" in n} \
        <= listed
    assert not {n for n in SPAN_READERS
                if ".device_" in n or ".idle_" in n} & listed


@pytest.mark.parametrize("workload", ["gross-ms-p01", "hi610-osd-w40"])
def test_traced_run_reports_the_span_metrics(workload):
    tracing.profiled().clear()
    bench, entry, cell, config = tiny(workload)
    out = run.run_cell(bench, entry, cell, config, SEED, 0.5, True, "cpu")
    tracing.profiled().clear()
    assert out["correct"]
    want = {m["name"] for m in BENCH["per_layer"]
            if m["source"] in ("program_span", "program_counter")
            and workload in m["workloads"]}
    assert want <= set(out["metrics"])
    for name in want:
        assert out["metrics"][name]["value"] >= 0


@pytest.mark.parametrize("workload", ["hi610-sp-w15", "hi610-osd-w40"])
def test_layers_on_the_cpu(workload):
    _, _, cell, config = tiny(workload)
    out = layers.layers(cell, config, SEED, 0.3, 1, "cpu")
    host = out["host_ms_per_chunk_no_profiler"]
    for layer in ("driver", "sample", "decode", "launch", "classify",
                  "fetch"):
        assert host[layer] > 0, layer
    assert (host["osd"] > 0) == (cell["osd_lam"] is not None)
    assert out["checks"]["late_loads_and_builds"] == 0
    # the CPU has no device operations: nothing to claim or split
    assert out["checks"]["unclaimed_device_ops"] == 0
    assert out["device_layers"] == {}
    assert "driver.host_ms_per_chunk" in out["metrics"]
    json.dumps(out)
