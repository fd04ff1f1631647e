"""The port's journal (harness/journal.py) and debug tools
(harness/debug.py) against the JAX package's: the same appends give the
same bytes, resume states agree on duplicates and torn lines, array dumps
are byte for byte the same, and ``trace`` writes a trace file (or
nothing) and reports the spans."""

import json
import os

import numpy as np
import pytest
import torch

from qec_ldpc_tpu.harness import debug as jax_debug
from qec_ldpc_tpu.harness.journal import Journal as JaxJournal
from qec_ldpc_tpu_torch import tracing
from qec_ldpc_tpu_torch.harness import Journal, debug

torch.set_num_threads(1)

RECORDS = [
    {"run_id": "r1|torch=cpu", "weight": 5, "chunk": 0,
     "counters": [10, 1, 2, 3, 4, 5, 6, 7, 8], "iters": 100},
    {"run_id": "r1|torch=cpu", "weight": 5, "chunk": 1,
     "counters": [10, 9, 8, 7, 6, 5, 4, 3, 2], "iters": 7},
    # an out-of-order duplicate of chunk 0, then chunk 2
    {"run_id": "r1|torch=cpu", "weight": 5, "chunk": 0,
     "counters": [99] * 9, "iters": 1},
    {"run_id": "r1|torch=cpu", "weight": 5, "chunk": 2,
     "counters": [10, 0, 0, 1, 0, 0, 0, 0, 0], "iters": 3},
    {"run_id": "r1|torch=cpu", "weight": 6, "chunk": 0,
     "counters": [10, 0, 0, 0, 0, 0, 0, 0, 0], "iters": 50},
    {"run_id": "r2", "weight": 5, "chunk": 1,
     "counters": [1] * 9, "iters": 1},
]


def write(cls, path, records):
    j = cls(str(path))
    for rec in records:
        j.append(rec)
    j.close()


def test_same_bytes(tmp_path):
    write(Journal, tmp_path / "ours" / "journal.jsonl", RECORDS)
    write(JaxJournal, tmp_path / "theirs" / "journal.jsonl", RECORDS)
    ours = (tmp_path / "ours" / "journal.jsonl").read_bytes()
    assert ours == (tmp_path / "theirs" / "journal.jsonl").read_bytes()
    assert ours.count(b"\n") == len(RECORDS) and b" " not in ours


@pytest.mark.parametrize("torn", [False, True])
@pytest.mark.parametrize("key", [("r1|torch=cpu", 5), ("r1|torch=cpu", 6),
                                 ("r2", 5), ("r1", 5)])
def test_resume_state_matches(tmp_path, torn, key):
    path = tmp_path / "journal.jsonl"
    write(Journal, path, RECORDS)
    if torn:
        with open(path, "a") as f:
            f.write('{"run_id": "r1|torch=cpu", "weight": 5, "chu')
    ours = Journal(str(path)).resume_state(*key)
    theirs = JaxJournal(str(path)).resume_state(*key)
    assert ours[0] == theirs[0] and ours[2] == theirs[2]
    if theirs[1] is None:
        assert ours[1] is None
    else:
        np.testing.assert_array_equal(ours[1], theirs[1])
    if key == ("r1|torch=cpu", 5):
        assert ours[0] == 3 and ours[2] == 110


def test_append_after_a_torn_line_resumes(tmp_path):
    """A crash mid-write leaves a torn line with no newline; the next run
    ends it before its first record, so replay skips only the torn line
    and keeps every record before and after it."""
    path = tmp_path / "journal.jsonl"
    write(Journal, path, RECORDS[:2])
    with open(path, "a") as f:
        f.write('{"run_id": "r1|torch=cpu", "weight": 5, "chu')
    write(Journal, path, RECORDS[3:4])
    assert Journal(str(path)).resume_state("r1|torch=cpu", 5)[0] == 3
    lines = path.read_text().splitlines()
    assert lines[-1] == json.dumps(RECORDS[3], separators=(",", ":"))


ARRAYS = [
    np.array([[1, 0], [0, 1]], dtype=np.int8),
    np.array([0.5, 0.25, 1e-7, 3.0], dtype=np.float32),
    np.array([[0.1, -2.5], [np.inf, np.nan]]),
    np.arange(12, dtype=np.int32).reshape(3, 4),
    np.array([7, -3, 0], dtype=np.int64),
]


@pytest.mark.parametrize("as_tensor", [False, True])
def test_write_array_same_bytes(tmp_path, as_tensor):
    ours, theirs = tmp_path / "ours.txt", tmp_path / "theirs.txt"
    for a in ARRAYS:
        debug.write_array(str(ours), torch.from_numpy(a) if as_tensor else a)
        jax_debug.write_array(str(theirs), a)
    debug.write_array(str(ours), ARRAYS[1], fmt="%.3f")
    jax_debug.write_array(str(theirs), ARRAYS[1], fmt="%.3f")
    assert ours.read_bytes() == theirs.read_bytes()
    assert ours.read_text().startswith("1 0\n0 1\n\n0.5 0.25 1e-07 3\n\n")


def test_write_array_rejects_3d(tmp_path):
    with pytest.raises(ValueError, match="1d/2d"):
        debug.write_array(str(tmp_path / "x.txt"), torch.zeros(2, 2, 2))


def test_trace_writes_a_trace(tmp_path):
    log_dir = tmp_path / "prof"
    with debug.trace(str(log_dir)) as spans:
        with tracing.span("mc.decode"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    text = (log_dir / files[0]).read_text()
    assert "aten::mm" in text and "mc.decode" in text
    assert [s[0] for s in spans.spans] == ["mc.decode"]


def test_trace_none_writes_nothing(tmp_path):
    before = set(os.listdir(tmp_path))
    with debug.trace(None):
        torch.ones(4) + 1
    assert set(os.listdir(tmp_path)) == before


def test_section_timers():
    """The reference's section timers are the recorder's spans: ``report()``
    gives each name's self milliseconds and calls, then the counters."""
    with tracing.recording() as rec:
        for _ in range(3):
            with tracing.span("decode"):
                pass
        with tracing.span("init"):
            tracing.count("builds", 2)
    assert [s[0] for s in rec.spans] == ["decode"] * 3 + ["init"]
    lines = rec.report().splitlines()
    assert lines[0].startswith("decode: ") and "over 3 call(s)" in lines[0]
    assert lines[1].startswith("init: ") and "over 1 call(s)" in lines[1]
    assert lines[2] == "builds: 2"
