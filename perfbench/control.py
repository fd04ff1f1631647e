#!/usr/bin/env python3
"""The readings the check's limits are set from, for one cell.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 3]

For each seed, in one process (one set-up): a short window of the cell at
its own load through the port, the groups a run would check drawn from the
seed, and the harness's own comparison (``run.judge``) of three sides
against the float32 reference:

  * ``program``: the port's groups (the lower reading);
  * ``witness``: the float32 reference out of the kernels' association
    order (``exact=False``) put in the program's place: what a float32
    decoder that orders its arithmetic otherwise reads;
  * ``control``: the reference in bfloat16 put in the program's place (the
    upper reading), which the comparison has to refuse.

Prints one JSON line per seed with each side's numbers and verdict, then a
summary line: the largest program and witness reading and the smallest
control reading of each number, and whether every program run was correct
and every control run refused.  The benchmark's own runs never run it.
Needs a CUDA device, as a run does (``--device cpu`` for a functional run).
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import run  # noqa: E402

SIDES = ("program", "witness", "control")
NUMBERS = ("counter_gap", "lane_iter_gap")


class Kept:
    """A reference whose replays are kept, so that every side is judged
    against one replay of each group."""

    def __init__(self, ref):
        self.ref, self.kept = ref, {}

    def replay(self, seed: int, chunks: list[int]):
        key = (seed, tuple(chunks))
        if key not in self.kept:
            self.kept[key] = self.ref.replay(seed, chunks)
        return self.kept[key]


def stand_in(ref, groups: list[dict], per_lane: bool) -> list[dict]:
    """``groups`` as ``ref``, put in the program's place, reports them."""
    out = []
    for g in groups:
        counters, records = ref.replay(g["seed"], g["chunks"])
        out.append({"seed": g["seed"], "chunks": g["chunks"],
                    "counters": [int(v) for v in counters],
                    "iters": run.lane_iters(records, per_lane)})
    return out


def readings(cell: dict, config: dict, seeds: list[int], seconds: float,
             device) -> list[dict]:
    import torch

    ref_codes, ref_decoders, ref_sampling = run.reference_modules()
    derive = ref_sampling.derived_seed
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    port = run.Port(config, cell, device)
    port.point(derive(seeds[0], run.WARMUP, 0), port.group_samples(), None)
    code = ref_codes.build_code(config)
    ref = ref_decoders.Reference(code, cell, device)
    witness = ref_decoders.Reference(code, cell, device, exact=False)
    control = ref_decoders.Reference(code, cell, device, torch.bfloat16)

    out = []
    for seed in seeds:
        t = time.perf_counter()
        win = run.drive_window(port, cell, seed, seconds, derive, sync)
        groups = win["groups"]
        picks = random.Random(seed).sample(
            range(len(groups)), min(cell["check_groups"], len(groups)))
        picked = [groups[i] for i in picks]
        kept = Kept(ref)
        sides = {"program": picked,
                 "witness": stand_in(witness, picked, on_card),
                 "control": stand_in(control, picked, on_card)}
        rec = {"seed": seed, "groups": len(picks)}
        for side, gs in sides.items():
            checks, correct = run.judge(kept, gs, on_card, cell["limits"])
            rec[side] = {k: c["value"] for k, c in checks.items()}
            rec[side]["correct"] = correct
        rec["seconds"] = time.perf_counter() - t
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


def summary(workload: str, limits: dict, recs: list[dict]) -> dict:
    out = {"workload": workload, "limits": limits}
    for key in NUMBERS:
        out[key] = {"program_max": max(r["program"][key] for r in recs),
                    "witness_max": max(r["witness"][key] for r in recs),
                    "control_min": min(r["control"][key] for r in recs)}
    out["program_correct"] = all(r["program"]["correct"] for r in recs)
    out["control_refused"] = not any(r["control"]["correct"] for r in recs)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, _, cell, config = run.spec_of(args.workload)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    recs = readings(cell, config, [int(s) for s in args.seeds.split(",")],
                    args.seconds, torch.device(args.device))
    print(json.dumps(summary(args.workload, cell["limits"], recs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
