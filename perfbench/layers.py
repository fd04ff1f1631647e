#!/usr/bin/env python3
"""Where a cell's time goes, layer by layer, through the program's spans.

    python3 perfbench/layers.py --workload <cell> --seed <n> \
        [--seconds 20] [--points 4]

A run of one cell (``run.py``'s cell, port and sweep) with the program's
spans and counters (``qec_ldpc_tpu_torch/tracing.py``) read as well:

  1. set-up recorded: the ``[setup]`` line gains ``setup.graphs``,
     ``setup.logical``, ``kernels.load`` and ``kernels.builds``;
  2. the window, unrecorded and unprofiled, as ``run.py`` drives it;
  3. ``--points`` whole sweep points with recording off and as many with it
     on, in turns, each seeded from a tag of its own: the host self time of
     each layer per chunk, point set-up included, with no profiler, and the
     recording's overhead, from the wall per chunk with spans on against
     off, and from an empty span's cost on and off times the spans a chunk;
  4. ``run.py``'s profiled stretch, the spans recorded and put in the
     trace from the profiler's start to its stop: each layer's device time,
     operations and idle time (``pb_spans``), and every per-layer reader in
     ``metrics/`` that reads no reference count.

Prints a ``[spans]`` line (the overhead, the device operations no span
claimed, the ``mc.fetch`` count against the trace's device-to-host copies,
the four layers' device time against ``aux_device_ms_per_chunk``, the idle
seconds by layer) and one JSON line.  Needs a CUDA device; imports neither
JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))
import run  # noqa: E402  (sets set-up's clock)

#: a spans-on or spans-off point's seed tag (run.py's are 0, 1 and 2)
SPANS = 3
#: the layers whose device time splits aux_device_ms_per_chunk
AUX_LAYERS = ("sample", "decode", "classify", "osd")
#: readers that need the reference's counts of the profiled chunks
NEEDS_REFERENCE = ("roofline.",)


def timed_point(port, seed: int, count: int, sync) -> float:
    """Wall seconds per chunk of a whole sweep point."""
    t0 = time.perf_counter()
    port.point(seed, count, lambda *a: None)
    sync()
    return (time.perf_counter() - t0) / -(-count // port.cell["batch"])


def span_cost_us(tracing, n: int = 200_000) -> tuple[float, float]:
    """Host microseconds an empty span costs with recording (off, on)."""
    out = []
    for record in (contextlib.nullcontext, tracing.recording):
        with record():
            t0 = time.perf_counter_ns()
            for _ in range(n):
                with tracing.span("mc.chunk", 0):
                    pass
            out.append((time.perf_counter_ns() - t0) * 1e-3 / n)
    return out[0], out[1]


def recorded_stretch(port, cell: dict, seed: int, derive, torch, tracing):
    """``run.traced_stretch`` with the spans recorded, and put in the trace,
    from the profiler's start to its stop.  Returns (profiler, recording,
    chunk ids, wall seconds)."""
    skip, want = cell["trace_skip"], cell["trace_groups"]
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    st = {"n": 0, "chunks": [], "rec": contextlib.ExitStack()}

    def progress(gi, _num, _counters, _iters):
        st["n"] += 1
        if st["n"] == skip:
            prof.start()
            st["recording"] = st["rec"].enter_context(tracing.recording())
            st["t0"] = time.perf_counter()
        elif st["n"] > skip:
            st["chunks"] += port.chunks_of(gi, cell["point_samples"])
            if st["n"] == skip + want:
                st["t1"] = time.perf_counter()
                st["rec"].close()
                prof.stop()
                raise run.WindowClosed

    try:
        port.point(derive(seed, run.TRACE, 0), cell["point_samples"],
                   progress)
    except run.WindowClosed:
        pass
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    if "t1" not in st:
        raise RuntimeError("the traced point ended before its stretch")
    return prof, st["recording"], st["chunks"], st["t1"] - st["t0"]


def layers(cell: dict, config: dict, seed: int, seconds: float, points: int,
           device) -> dict:
    """One run of a cell on ``device``, its spans read; returns the JSON
    line's object and prints the ``[setup]`` and ``[spans]`` lines."""
    import torch

    from qec_ldpc_tpu_torch import tracing

    run.on_path()
    import pb_card
    import pb_spans
    import pb_trace

    _, _, ref_sampling = run.reference_modules()
    derive = ref_sampling.derived_seed
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t_port = time.perf_counter()
    with tracing.recording() as setup:
        port = run.Port(config, cell, device)
        port.point(derive(seed, run.WARMUP, 0), port.group_samples(), None)
        sync()
    split = {name: pb_spans.host_ms(setup, (name,)) or 0.0
             for name in ("setup.graphs", "setup.logical", "kernels.load",
                          "mc.point_setup")}
    split["kernels.builds"] = setup.counters.get("kernels.builds", 0)
    print(f"[setup] to the port {t_port - run.T_PROCESS:.3f} s, port and "
          f"warm-up {time.perf_counter() - t_port:.3f} s; ms "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()),
          file=sys.stderr)

    win = run.drive_window(port, cell, seed, seconds, derive, sync)
    window_chunks = sum(len(g["chunks"]) for g in win["groups"])
    window_s_per_chunk = win["window_s"] / window_chunks

    # whole points, spans off and on in turns, the same seed for both
    count = cell["point_samples"]
    off, on, recs = [], [], []
    for k in range(points):
        point_seed = derive(seed, SPANS, k)
        off.append(timed_point(port, point_seed, count, sync))
        with tracing.recording() as rec:
            on.append(timed_point(port, point_seed, count, sync))
        recs.append(rec)
    recorded_chunks = points * -(-count // cell["batch"])

    def host_ms(names) -> float:
        return sum(pb_spans.host_ms(r, names) or 0.0 for r in recs)

    host = {layer: host_ms(names) / recorded_chunks
            for layer, names in pb_spans.HOST_SPANS.items()}
    host["point_setup_ms_per_point"] = host_ms(("mc.point_setup",)) / points
    counters = {}
    for r in recs:
        for name, v in r.counters.items():
            counters[name] = counters.get(name, 0) + v
    overhead = statistics.median(on) / statistics.median(off) - 1.0
    # the same from each span's own cost, which the wall's noise hides;
    # and what the spans cost with recording off, as in the timed window
    cost_off, cost_on = span_cost_us(tracing)
    spans_per_chunk = sum(len(r.spans) for r in recs) / recorded_chunks
    estimate = (spans_per_chunk * (cost_on - cost_off) * 1e-6
                / statistics.median(off))
    off_cost = spans_per_chunk * cost_off * 1e-6 / statistics.median(off)

    prof, profiled, tchunks, twall = recorded_stretch(port, cell, seed,
                                                      derive, torch, tracing)
    events = pb_spans.without_annotations(prof.events())
    summary, breakdown = pb_trace.summarize(
        SimpleNamespace(events=lambda: events), len(tchunks), twall)
    summary["unprofiled_s_per_chunk"] = window_s_per_chunk
    summary["peaks"] = pb_card.peaks()
    summary["decodes"] = []
    summary["spans"] = profiled
    found = pb_spans.device_layers(events)
    if found is None:
        raise RuntimeError("the profiled stretch holds no program span")
    summary["device_layers"], summary["idle_layers"], unclaimed = found
    fetches = sum(s[0] == "mc.fetch" for s in profiled.spans)
    late = (sum(s[0] == "kernels.load" for r in (*recs, profiled)
                for s in r.spans)
            + counters.get("kernels.builds", 0)
            + profiled.counters.get("kernels.builds", 0))

    metrics = {}
    for path in sorted((HERE / "metrics").glob("*.py")):
        if path.stem.startswith(NEEDS_REFERENCE):
            continue
        value = run.load(path).read(summary)
        if value is not None:
            metrics[path.stem] = value
    aux = metrics.get("aux_device_ms_per_chunk")
    split_aux = sum(metrics.get(f"{k}.device_ms_per_chunk", 0.0)
                    for k in AUX_LAYERS)
    checks = {"overhead": overhead, "overhead_from_span_cost": estimate,
              "off_cost": off_cost,
              "span_us_off": cost_off, "span_us_on": cost_on,
              "spans_per_chunk": spans_per_chunk,
              "unclaimed_device_ops": unclaimed,
              "fetch_spans": fetches, "dtoh_copies": summary["memcpy_dtoh"],
              "aux_split_ms_per_chunk": split_aux, "aux_ms_per_chunk": aux,
              "late_loads_and_builds": late}
    print(f"[spans] overhead {100 * overhead:+.2f}% from the wall, "
          f"{100 * estimate:+.3f}% from {spans_per_chunk:.2f} spans a chunk "
          f"at {cost_on:.3f} us on, {cost_off:.3f} off; spans off cost "
          f"{100 * off_cost:.3f}% (wall per chunk "
          f"{1e3 * statistics.median(on):.4f} ms on, "
          f"{1e3 * statistics.median(off):.4f} off, window "
          f"{1e3 * window_s_per_chunk:.4f}); unclaimed device ops "
          f"{unclaimed}; mc.fetch {fetches} vs DtoH "
          f"{summary['memcpy_dtoh']}; device ms per chunk of "
          f"{'+'.join(AUX_LAYERS)} {split_aux:.4f} vs aux {aux}; loads and "
          f"builds after set-up {late}; idle s by layer "
          + json.dumps(summary["idle_layers"]), file=sys.stderr)
    return {"card": (torch.cuda.get_device_name(0) if on_card else "cpu"),
            "power_limit": pb_card.power_limit(0) if on_card else None,
            "setup_ms": split, "host_ms_per_chunk_no_profiler": host,
            "counters_no_profiler": counters,
            "wall_ms_per_chunk": {"off": [1e3 * v for v in off],
                                  "on": [1e3 * v for v in on],
                                  "window": 1e3 * window_s_per_chunk},
            "metrics": metrics, "checks": checks,
            "idle_s_by_layer": summary["idle_layers"],
            "device_layers": summary["device_layers"],
            "breakdown": breakdown}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--points", type=int, default=4)
    args = ap.parse_args(argv)
    _, _, cell, config = run.spec_of(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("layers: torch.cuda.is_available() is false; the spans are "
              "read on an NVIDIA GPU", file=sys.stderr)
        return 2
    out = layers(cell, config, args.seed % (1 << 64), args.seconds,
                 args.points, torch.device("cuda", 0))
    print(json.dumps({"workload": args.workload, "seed": args.seed, **out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
