"""The port's spans and counters (qec_ldpc_tpu_torch/tracing.py) in its
Monte-Carlo driver, on the CPU at a small size: nothing recorded with
recording off; with it on, each chunk's spans, their parents, self times
that add up, the relay and OSD counters against what the driver computes;
the same counters and lane-iterations with recording off, on and under a
profiler."""

import numpy as np
import pytest
import torch

from qec_ldpc_tpu_torch import construct_code, tracing
from qec_ldpc_tpu_torch.decoder import BPConfig, CodeGraphs
from qec_ldpc_tpu_torch.parallel import montecarlo
from qec_ldpc_tpu_torch.parallel.montecarlo import (
    run_monte_carlo,
    run_monte_carlo_osd,
)

torch.set_num_threads(1)

BATCH, COUNT, SEED = 64, 256, 11
#: spans a chunk holds, each with the chunk's id (relay and OSD add theirs):
#: one ``mc.decode`` for both graphs, one ``mc.launch`` a graph (the CPU
#: never pairs the two)
PER_CHUNK = {"mc.chunk": 1, "mc.sample": 2, "mc.decode": 1, "mc.launch": 2,
             "mc.classify": 1}
#: spans whose children belong to several chunks
SHARED = {"mc.point", "mc.point_setup", "mc.group"}


@pytest.fixture(scope="module")
def graphs():
    return CodeGraphs.build(construct_code(3, 3, 6, 7, 2, 3))


def plain(graphs, progress=None):
    return run_monte_carlo(graphs, 3, COUNT, 0.02, BPConfig(max_iters=20),
                           seed=SEED, batch_size=BATCH, steps_per_call=2,
                           progress=progress, device="cpu")


def relay(graphs):
    return run_monte_carlo(graphs, 5, COUNT, 0.02,
                           BPConfig(max_iters=20, algorithm="min-sum"),
                           seed=SEED, batch_size=BATCH, relay_retries=2,
                           device="cpu")


def osd(graphs):
    return run_monte_carlo_osd(graphs, 5, COUNT, 0.02,
                               BPConfig(max_iters=20, algorithm="min-sum"),
                               seed=SEED, batch_size=BATCH, lam=0,
                               progress=lambda *a: None, device="cpu")


def by_chunk(rec):
    out = {}
    for name, _, _, _, chunk in rec.spans:
        if chunk is not None:
            out.setdefault(chunk, {}).setdefault(name, 0)
            out[chunk][name] += 1
    return out


def check_tree(rec):
    """Parents of the same chunk or shared; every span closed; self times
    non-negative and adding up to the roots' durations."""
    for name, t0, t1, parent, chunk in rec.spans:
        assert t1 >= t0 > 0, name
        if parent is not None:
            p = rec.spans[parent]
            assert p[1] <= t0 and t1 <= p[2], (name, p[0])
            assert p[4] == chunk or p[0] in SHARED, (name, p[0])
    own = rec.self_ns()
    assert min(own) >= 0
    roots = sum(t1 - t0 for _, t0, t1, parent, _ in rec.spans
                if parent is None)
    assert sum(own) == roots


def test_off_records_nothing(graphs):
    tracing.profiled().clear()
    assert tracing.span("mc.chunk", 0) is tracing.NOOP
    assert tracing.span("mc.decode") is tracing.span("mc.osd")
    with tracing.span("mc.chunk", 0):
        tracing.count("osd.lanes", 3)
    plain(graphs)
    assert not tracing.profiled().spans and not tracing.profiled().counters


def test_plain_run_spans(graphs):
    calls = []
    with tracing.recording() as rec:
        plain(graphs, lambda *a: calls.append(a))
    check_tree(rec)
    names = [s[0] for s in rec.spans]
    groups = len(calls)
    assert names.count("mc.point") == names.count("mc.point_setup") == 1
    assert names.count("mc.group") == groups == 2
    assert names.count("mc.fetch") == groups
    assert names.count(tracing.OUTSIDE) == groups
    assert "setup.logical" in names
    chunks = by_chunk(rec)
    assert sorted(chunks) == list(range(COUNT // BATCH))
    for spans in chunks.values():
        assert spans == PER_CHUNK
    # the progress callback's time lies in no program span
    for name, _, _, parent, _ in rec.spans:
        if name == tracing.OUTSIDE:
            assert rec.spans[parent][0] == "mc.point"
    # the CPU runs every chunk eagerly: no capture, no replay, no fused
    # classification and no paired decode
    assert rec.counters == {"mc.graph_replays": 0, "classify.fused": 0,
                            "decode.paired": 0}


def test_relay_counts_its_retries(graphs, monkeypatch):
    orig = montecarlo.relay_decode_batch
    used = []

    def counted(*args, **kwargs):
        res, rx, rz = orig(*args, **kwargs)
        used.append(rx + rz)
        return res, rx, rz

    monkeypatch.setattr(montecarlo, "relay_decode_batch", counted)
    with tracing.recording() as rec:
        relay(graphs)
    check_tree(rec)
    assert sum(used) > 0
    assert rec.counters == {"relay.retries": sum(used),
                            "mc.graph_replays": 0, "classify.fused": 0,
                            "decode.paired": 0}
    for c, spans in sorted(by_chunk(rec).items()):
        assert spans["mc.relay"] == 2
        # one kernel call per retry, one flag read per retry and graph
        # unless the retries ran out
        assert spans["mc.launch"] == 2 + used[c]
        assert used[c] <= spans["mc.fetch"] <= used[c] + 2


def test_osd_counts_its_lanes(graphs, monkeypatch):
    orig = montecarlo._repair_and_classify
    lanes, solves, bits = [], [], []

    def counted(post, i_minus_p, counts, bundle):
        lanes.append(int(counts[1]) + int(counts[2]))
        solves.append(int(counts[1] > 0) + int(counts[2] > 0))
        # the augmented systems [H_pi | s] of the lanes handed to OSD
        bits.append(sum(int(k) * h.shape[0] * (h.shape[1] + 1)
                        for k, h in ((counts[1], graphs.code.pcm_x),
                                     (counts[2], graphs.code.pcm_z))))
        return orig(post, i_minus_p, counts, bundle)

    monkeypatch.setattr(montecarlo, "_repair_and_classify", counted)
    with tracing.recording() as rec:
        osd(graphs)
    check_tree(rec)
    assert sum(lanes) > 0
    assert rec.counters == {"osd.lanes": sum(lanes),
                            "osd.system_bits": sum(bits),
                            "decode.paired": 0}
    chunks = by_chunk(rec)
    assert sorted(chunks) == list(range(COUNT // BATCH))
    for c, spans in chunks.items():
        # dispatch, tail and finish are each a chunk span; the tail's and
        # the finish's reads are fetches
        assert spans == {**PER_CHUNK, "mc.chunk": 3, "mc.osd": 1,
                         "mc.fetch": 2, "mc.launch": 2 + solves[c]}


@pytest.mark.parametrize("run", [plain, relay, osd])
def test_results_do_not_depend_on_recording(graphs, run):
    off = run(graphs)
    with tracing.recording():
        on = run(graphs)
    np.testing.assert_array_equal(off[0], on[0])
    assert off[1] == on[1]


def test_profiler_sees_the_spans(graphs):
    """Under a profiler alone the spans go to profiled() and not into its
    trace; inside recording() they go into both.  The results stay the
    same."""
    off = plain(graphs)
    tracing.profiled().clear()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        profiled = plain(graphs)
    with tracing.recording() as rec, \
            torch.profiler.profile(activities=acts) as annotated:
        recorded = plain(graphs)
    for other in (profiled, recorded):
        np.testing.assert_array_equal(off[0], other[0])
        assert off[1] == other[1]
    auto = tracing.profiled()
    check_tree(auto)
    assert by_chunk(auto)[0] == PER_CHUNK
    assert not {s[0] for s in auto.spans} & {e.name for e in prof.events()}
    assert [s[0] for s in auto.spans] == [s[0] for s in rec.spans]
    assert {s[0] for s in rec.spans} <= {e.name for e in annotated.events()}
    auto.clear()


def test_cli_profile_reports_the_spans(tmp_path, capsys):
    """``--profile_dir``: the Chrome trace names the spans, and the CLI
    prints their self times to stderr once the trace is written."""
    from qec_ldpc_tpu_torch.harness import cli

    cli.main(["--code", "qc:3,3,6,7,2,3", "--w", "2", "--W", "2",
              "--count", "128", "--max", "10", "--p", "0.02", "--seed", "5",
              "--batch_size", "64", "--device", "cpu",
              "--results_dir", str(tmp_path / "out"),
              "--log_file", str(tmp_path / "out" / "log.txt"),
              "--profile_dir", str(tmp_path / "prof")])
    err = capsys.readouterr().err
    for name in ("mc.point", "mc.chunk", "mc.sample", "mc.decode",
                 "mc.launch", "mc.classify", "mc.fetch"):
        assert f"\n{name}: " in "\n" + err, name
    trace, = (tmp_path / "prof").glob("*.pt.trace.json")
    assert '"mc.decode"' in trace.read_text()
