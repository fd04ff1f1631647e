"""The card a run measures: its name, its power limit and its published
peaks.  The name and limit readers are copied from the port's benchmark
suite (``benchmarks_torch/common.py``); the peaks are NVIDIA's data-sheet
figures for one H100 SXM at its full 700 W, kept in ``peaks.json``."""

from __future__ import annotations

import json
import subprocess
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def power_limit(index: int) -> str | None:
    """``nvidia-smi``'s power limit of card ``index`` ("700.00 W"), or None
    where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out or None


def peaks() -> dict:
    return json.loads(PEAKS.read_text())
