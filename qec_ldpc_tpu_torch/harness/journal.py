"""Append-only JSONL progress journal: checkpoint and resume of Monte-Carlo
sweeps (PyTorch port).

The port's copy of ``qec_ldpc_tpu/harness/journal.py``; the records are
byte for byte the JAX package's.  Every completed chunk group appends one
JSON line {run_id, weight, chunk, counters, iters}; on restart the journal
replays the finished groups, so a killed sweep resumes at the next group
with the same statistics (chunk generators derive from (seed, chunk
index)).  Appends are fsync'd whole lines, so a crash leaves at worst one
torn trailing line, which replay skips; the next append first ends that
line (the JAX package's journal writes the next record onto it, and replay
then skips that record too).
"""

from __future__ import annotations

import json
import os
from typing import Iterator

import numpy as np


class Journal:
    def __init__(self, path: str):
        self.path = path
        self._fh = None

    def _ensure_open(self):
        if self._fh is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            torn = False
            if os.path.exists(self.path) and os.path.getsize(self.path):
                with open(self.path, "rb") as f:
                    f.seek(-1, os.SEEK_END)
                    torn = f.read(1) != b"\n"
            self._fh = open(self.path, "a")
            if torn:
                # end a line torn by a crash, so that the next record is a
                # line of its own and replay skips only the torn one
                self._fh.write("\n")

    def append(self, record: dict) -> None:
        self._ensure_open()
        self._fh.write(json.dumps(record, separators=(",", ":")) + "\n")
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def records(self) -> Iterator[dict]:
        if not os.path.exists(self.path):
            return
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    # a torn final line after a crash: skip it (only whole
                    # lines are fsync'd, so the next append starts afresh)
                    continue

    def resume_state(self, run_id: str, weight: int):
        """Returns (next_chunk, accumulated_counters, total_iters) for the
        given run/weight from completed-chunk records."""
        next_chunk = 0
        counters = None
        iters = 0
        for rec in self.records():
            if rec.get("run_id") != run_id or rec.get("weight") != weight:
                continue
            if rec.get("chunk") != next_chunk:
                continue  # an out-of-order duplicate; chunks append in order
            c = np.asarray(rec["counters"], dtype=np.int64)
            counters = c if counters is None else counters + c
            iters += int(rec.get("iters", 0))
            next_chunk += 1
        return next_chunk, counters, iters
