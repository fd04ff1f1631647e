#!/usr/bin/env python3
"""One run of one cell of the port's benchmark (``BENCHMARK.json``).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is a configuration (``configs/<config>.json``: the code) under a
traffic mix (``cells/<cell>.json``: error model, decoder, batch, grouping,
sweep points, how many groups the check replays and how many the trace
profiles, and the limits of the check).  A run:

  1. builds the code's graphs and its rank-basis logical test through the
     port (``qec_ldpc_tpu_torch``), and warms up one group of the cell's own
     shapes (the first run in a checkout builds the CUDA kernels there);
  2. drives a closed-loop sweep through the port's Monte-Carlo driver
     (``run_monte_carlo``, or ``run_monte_carlo_osd`` in the OSD quality
     mode): consecutive points of ``point_samples`` samples, point k seeded
     from (--seed, k), each group timed at the driver's ``progress``
     callback.  The window closes at the first group boundary after
     --seconds;
  3. with --trace 1, runs a further point, profiles ``trace_groups`` of its
     groups and hands the summary to the per-layer readers
     (``metrics/<name>.py``);
  4. replays ``check_groups`` groups of the window, drawn from the seed,
     through the plain reference (``reference/``) and compares their
     counters and lane-iterations with the program's;
  5. prints one JSON line: ``correct``, ``attempted``, ``failed``,
     ``metrics``, ``device`` (and ``breakdown`` with --trace 1), the numbers
     compared last, under ``checks``.

Needs a CUDA device; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "qec_ldpc_tpu")
#: a point's seed is derived from (--seed, POINT, k); the warm-up's and the
#: trace's from their own tags
POINT, WARMUP, TRACE = 0, 1, 2


def load(path: Path):
    """A module of the benchmark, by path (the folder is no package)."""
    spec = importlib.util.spec_from_file_location(path.stem.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def spec_of(workload: str) -> tuple[dict, dict, dict, dict]:
    """(BENCHMARK.json, its workload entry, the cell file, the config file)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"unknown workload {workload!r}")
    cell = json.loads((HERE / "cells" / f"{workload}.json").read_text())
    config = json.loads((HERE / "configs" / f"{entry['config']}.json").read_text())
    return bench, entry, cell, config


def on_path() -> None:
    """The benchmark's folder on ``sys.path``: its modules, the readers
    included, import each other by name."""
    if str(HERE) not in sys.path:
        sys.path.insert(0, str(HERE))


def reference_modules():
    """The plain reference's modules (they import each other by name)."""
    ref = str(HERE / "reference")
    if ref not in sys.path:
        sys.path.insert(0, ref)
    import ref_codes
    import ref_decoders
    import ref_sampling
    return ref_codes, ref_decoders, ref_sampling


class WindowClosed(Exception):
    """Raised from the progress callback to end a sweep point."""


class Port:
    """The system under test: the code's graphs and logical test, built
    through the port, and one sweep point through its Monte-Carlo driver."""

    def __init__(self, config: dict, cell: dict, device):
        if str(ROOT) not in sys.path:
            sys.path.insert(0, str(ROOT))
        from qec_ldpc_tpu_torch.decoder.decode import CodeGraphs
        from qec_ldpc_tpu_torch.decoder.sum_product import BPConfig
        from qec_ldpc_tpu_torch.parallel import montecarlo
        from qec_ldpc_tpu_torch.sampling.classify import make_rank_basis_test

        self.mc = montecarlo
        self.cell, self.device = cell, device
        if config["family"] == "qc":
            from qec_ldpc_tpu_torch import construct_code
            code = construct_code(config["J"], config["K"], config["L"],
                                  config["P"], config["sigma"], config["tau"])
            self.graphs = CodeGraphs.build(code)
        else:
            from qec_ldpc_tpu_torch.codes import bicycle_code
            self.graphs = bicycle_code(config["l"], config["m"], config["a"],
                                       config["b"]).build_graphs()
        self.logical = make_rank_basis_test(self.graphs.code, device)
        d = cell["decoder"]
        self.cfg = BPConfig(max_iters=d["max_iters"],
                            check_every=d["check_every"],
                            conv_low=d["conv_low"], conv_high=d["conv_high"],
                            algorithm=d["algorithm"], min_sum_alpha=d["alpha"])
        osd = cell.get("osd_lam") is not None
        #: chunks per group: one in the quality mode, which reads per chunk
        self.group_chunks = 1 if osd else cell["chunks_per_group"]

    def group_samples(self) -> int:
        return self.group_chunks * self.cell["batch"]

    def point(self, seed: int, count: int, progress) -> None:
        c = self.cell
        common = dict(error_model=c["error_model"], progress=progress,
                      relay_retries=c.get("relay_retries", 0),
                      i_minus_p=self.logical, device=self.device)
        if c.get("osd_lam") is None:
            self.mc.run_monte_carlo(
                self.graphs, c.get("weight", 0), count, c["p"], self.cfg,
                seed=seed, batch_size=c["batch"],
                steps_per_call=c["chunks_per_group"], **common)
        else:
            self.mc.run_monte_carlo_osd(
                self.graphs, c.get("weight", 0), count, c["p"], self.cfg,
                seed=seed, batch_size=c["batch"], lam=c["osd_lam"], **common)

    def chunks_of(self, group: int, count: int) -> list[int]:
        """The chunk ids of group ``group`` of a point of ``count``."""
        if self.group_chunks == 1:
            return [group]
        num = -(-count // self.cell["batch"])
        spc = self.mc.effective_steps_per_call(count, self.cell["batch"],
                                               self.cell["chunks_per_group"])
        return list(range(group * spc, min((group + 1) * spc, num)))


def drive_window(port: Port, cell: dict, seed: int, seconds: float,
                 derive, sync) -> dict:
    """The measured window: sweep points until the first group boundary
    after ``seconds``.  Returns the groups (point seed, chunks, counters,
    lane-iterations, seconds) and the failed samples."""
    count = cell["point_samples"]
    groups, failed = [], 0
    t0 = time.perf_counter()
    clock = {"last": t0}

    def progress(gi, _num, counters, iters, point_seed=None):
        now = time.perf_counter()
        groups.append({"seed": point_seed, "chunks": port.chunks_of(gi, count),
                       "counters": [int(v) for v in counters],
                       "iters": int(iters), "s": now - clock["last"]})
        clock["last"] = now
        if now - t0 >= seconds:
            raise WindowClosed

    k = 0
    while time.perf_counter() - t0 < seconds:
        point_seed = derive(seed, POINT, k)
        try:
            port.point(point_seed, count,
                       lambda *a, s=point_seed: progress(*a, point_seed=s))
        except WindowClosed:
            break
        except Exception as exc:  # a failed operation: count it, go on
            print(f"[window] point {k} raised {type(exc).__name__}: {exc}",
                  file=sys.stderr)
            failed += port.group_samples()
            clock["last"] = time.perf_counter()
            if time.perf_counter() - t0 >= seconds:
                break
        k += 1
    sync()
    return {"groups": groups, "failed": failed,
            "window_s": clock["last"] - t0, "t0": t0}


def traced_stretch(port: Port, cell: dict, seed: int, derive, torch):
    """Profile ``trace_groups`` groups of a further point, after
    ``trace_skip`` groups that let it reach its steady state.  Returns
    (profiler, point seed, chunk ids, wall seconds)."""
    count = cell["point_samples"]
    skip, want = cell["trace_skip"], cell["trace_groups"]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)
    st = {"n": 0, "chunks": [], "t0": None, "t1": None}

    def progress(gi, _num, _counters, _iters):
        st["n"] += 1
        if st["n"] == skip:
            prof.start()
            st["t0"] = time.perf_counter()
        elif st["n"] > skip:
            st["chunks"] += port.chunks_of(gi, count)
            if st["n"] == skip + want:
                st["t1"] = time.perf_counter()
                prof.stop()
                raise WindowClosed

    point_seed = derive(seed, TRACE, 0)
    try:
        port.point(point_seed, count, progress)
    except WindowClosed:
        pass
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    if st["t1"] is None:
        raise RuntimeError("the traced point ended before its stretch")
    return prof, point_seed, st["chunks"], st["t1"] - st["t0"]


def lane_iters(records: list[dict], per_lane: bool) -> int:
    """The lane-iterations of a group's decode records as the program counts
    them.  ``per_lane``: each lane's own iterations (its kernels); else each
    decode call's loop iterations times its lanes (its plain path on the
    CPU)."""
    return sum(r["lane_iters"] if per_lane else r["loop_iters"] * r["lanes"]
               for r in records)


def check(ref, groups: list[dict], per_lane: bool) -> tuple[int, float]:
    """(counter gap, lane-iteration gap) of ``groups`` against the
    reference: the summed absolute differences of the nine counters, and
    the summed absolute difference of the lane-iterations over the
    reference's total."""
    counter_gap, iter_gap, iter_ref = 0, 0, 0
    for g in groups:
        counters, records = ref.replay(g["seed"], g["chunks"])
        counter_gap += int(sum(abs(int(a) - int(b))
                               for a, b in zip(g["counters"], counters)))
        want = lane_iters(records, per_lane)
        iter_gap += abs(g["iters"] - want)
        iter_ref += want
    return counter_gap, iter_gap / max(iter_ref, 1)


def judge(ref, groups: list[dict], per_lane: bool,
          limits: dict) -> tuple[dict, bool]:
    """(the numbers compared, each beside its limit; ``correct``)."""
    counter_gap, iter_gap = check(ref, groups, per_lane)
    checks = {"counter_gap": {"value": counter_gap,
                              "limit": limits["counter_gap"]},
              "lane_iter_gap": {"value": iter_gap,
                                "limit": limits["lane_iter_gap"]}}
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


def run_cell(bench: dict, entry: dict, cell: dict, config: dict, seed: int,
             seconds: float, trace: bool, device) -> dict:
    """One run of a cell on ``device``; returns the result line's object.
    The caller has checked the device."""
    import torch

    on_path()
    ref_codes, ref_decoders, ref_sampling = reference_modules()
    derive = ref_sampling.derived_seed
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t_port = time.perf_counter()
    port = Port(config, cell, device)
    t_warm = time.perf_counter()
    port.point(derive(seed, WARMUP, 0), port.group_samples(), None)
    sync()
    print(f"[setup] to the port {t_port - T_PROCESS:.3f} s, port "
          f"{t_warm - t_port:.3f} s, warm-up {time.perf_counter() - t_warm:.3f} s",
          file=sys.stderr)
    win = drive_window(port, cell, seed, seconds, derive, sync)
    setup_s = win["t0"] - T_PROCESS
    groups = win["groups"]
    if not groups:
        raise SystemExit(f"no group completed in the window "
                         f"({win['failed']} samples failed)")
    times = sorted(g["s"] for g in groups)
    half = len(groups) // 2
    print(f"[window] {len(groups)} groups in {win['window_s']:.2f} s; "
          f"group ms median {1e3 * times[len(times) // 2]:.3f}, "
          f"max {1e3 * times[-1]:.3f}; halves "
          f"{sum(g['s'] for g in groups[:half]):.3f} s, "
          f"{sum(g['s'] for g in groups[half:]):.3f} s", file=sys.stderr)
    batch = cell["batch"]
    memory_peak = int(torch.cuda.max_memory_allocated()) if on_card else 0

    classified = sum(g["counters"][0] for g in groups)
    expected = sum(len(g["chunks"]) * batch for g in groups)
    broken = sum(len(g["chunks"]) * batch for g in groups
                 if g["counters"][0] != len(g["chunks"]) * batch
                 or min(g["counters"]) < 0
                 or max(g["counters"][1:]) > g["counters"][0])
    attempted = expected + win["failed"]
    failed = win["failed"] + broken

    traced = None
    if trace:
        traced = traced_stretch(port, cell, seed, derive, torch)
    group_chunks = port.group_chunks
    del port
    if on_card:
        torch.cuda.empty_cache()

    code = ref_codes.build_code(config)
    ref = ref_decoders.Reference(code, cell, device)
    picks = random.Random(seed).sample(range(len(groups)),
                                       min(cell["check_groups"], len(groups)))
    t_check = time.perf_counter()
    checks, correct = judge(ref, [groups[i] for i in picks], on_card,
                            cell["limits"])
    print(f"[check] {len(picks)} of {len(groups)} groups replayed in "
          f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)

    out = {"correct": correct, "attempted": attempted, "failed": failed}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if on_card
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": memory_peak}
    if not trace:
        p95 = (statistics.quantiles(times, n=20, method="inclusive")[18]
               if len(times) > 1 else times[0])
        values = {"samples_per_s": classified / win["window_s"],
                  "group_ms_p95": 1e3 * p95, "setup_s": setup_s}
        metrics = {}
        for m in bench["end_to_end"]:
            if "workloads" in m and entry["name"] not in m["workloads"]:
                continue
            # ``<quantity>.<cells>``: the quantity in the cells it lists,
            # under a bound of their own
            value = values.get(m["name"].split(".")[0])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out["metrics"] = metrics
        out["device"] = device_info
    else:
        import pb_card
        import pb_trace
        prof, tseed, tchunks, twall = traced
        summary, breakdown = pb_trace.summarize(prof, len(tchunks), twall)
        chunks_in_window = sum(len(g["chunks"]) for g in groups)
        summary["unprofiled_s_per_chunk"] = win["window_s"] / chunks_in_window
        summary["peaks"] = pb_card.peaks()
        # the work the profiled chunks needed, counted by the reference
        records = []
        for i in range(0, len(tchunks), group_chunks):
            records += ref.replay(tseed, tchunks[i:i + group_chunks])[1]
        summary["decodes"] = records
        metrics = {}
        for m in bench["per_layer"]:
            if "workloads" in m and entry["name"] not in m["workloads"]:
                continue
            value = load(HERE / "metrics" / f"{m['name']}.py").read(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out["metrics"] = metrics
        device_info["busy_s"] = summary["device_busy_s"]
        device_info["window_s"] = summary["window_s"]
        out["device"] = device_info
        out["breakdown"] = breakdown
        out["card"] = {"power_limit": pb_card.power_limit(0) if on_card
                       else None, "peaks": summary["peaks"]}
    out["checks"] = checks
    return out


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench, entry, cell, config = spec_of(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("perfbench: torch.cuda.is_available() is false; the benchmark "
              "measures an NVIDIA GPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < entry["chips"]:
        print(f"perfbench: {args.workload} needs {entry['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    # NumPy's SeedSequence takes non-negative entropy only
    out = run_cell(bench, entry, cell, config, args.seed % (1 << 64),
                   args.seconds, bool(args.trace), torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"perfbench: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
