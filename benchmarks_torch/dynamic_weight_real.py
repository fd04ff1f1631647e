"""The dynamic-weight sweep on the card: the W=1..58 [[610,61]] sweep with
``weight_cap``, against static-sampler probes.

The port of ``benchmarks/dynamic_weight_real.py``.  On the TPU the dynamic
sampler (``sample_weight_w_errors_dynamic`` + ``weight_cap``) made the
weight a runtime operand, so a whole w..W sweep shared one compiled
program.  The port compiles no programs: each weight runs the same
sum-product kernel (K1), built once per source hash at first use.  What
the record keeps:

* sweep accounting: wall seconds for the full W=1..58 sweep in dynamic
  mode (the first weight's wall includes building and loading K1 at first
  use) and for the static-sampler probes;
* counter parity: at every probed weight the dynamic sweep is compared
  with the static-sampler run; the draws differ by design (the dynamic
  stream draws ``weight_cap`` candidates) EXCEPT at ``weight ==
  weight_cap``, where the counters must be equal (gated);
* sweep throughput: samples/s over the whole 58-weight sweep.

The JAX record's compile keys have no counterpart and are null
(``compiled_programs``, ``seconds_incl_compile``); each static probe's
wall is in ``seconds``.  Every decode runs K1 on the card: the plain
PyTorch version takes 100-800 ms a decode there (PERF.md §6) and no switch
routes the sweep through it.

    python benchmarks_torch/dynamic_weight_real.py [--out PATH]
    python benchmarks_torch/dynamic_weight_real.py --device cpu --w-max 4 \\
        --count 128 --batch 64 --probes 1,4
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmarks_torch.common import (  # noqa: E402
    card,
    gate,
    out_path,
    resolve_device,
    write_records,
)
from qec_ldpc_tpu_torch import construct_code  # noqa: E402
from qec_ldpc_tpu_torch.decoder import BPConfig, CodeGraphs  # noqa: E402
from qec_ldpc_tpu_torch.parallel import run_monte_carlo  # noqa: E402
from qec_ldpc_tpu_torch.sampling import make_rank_basis_test  # noqa: E402

PER_WEIGHT_PROBE = (1, 15, 30, 58)  # static-mode weights
W_MAX = 58
COUNT = 10240


def main(device: str = "cuda", w_max: int = W_MAX, count: int = COUNT,
         batch: int = 2048, probes=PER_WEIGHT_PROBE,
         out: str | None = None) -> list:
    """The sweep and the probes; returns the records (meta line first).
    ``probes`` must lie in 1..``w_max``; the cap is ``w_max``."""
    device = resolve_device(device)
    where = card(device)
    code = construct_code(4, 5, 10, 61, 9, 49)
    graphs = CodeGraphs.build(code)
    test = make_rank_basis_test(code, device)
    cfg = BPConfig(max_iters=100)
    # cap = the sweep's top weight, so the top probe holds the
    # equal-draws invariant (weight == weight_cap)
    wcap = w_max

    def run(w, cap):
        return run_monte_carlo(graphs, w, count, 0.01, cfg, seed=500 + w,
                               batch_size=batch, steps_per_call=8,
                               i_minus_p=test, weight_cap=cap,
                               device=device)[0]

    records = []
    t0 = time.perf_counter()
    dyn_counters = {}
    first_w_seconds = None
    for w in range(1, w_max + 1):
        tw = time.perf_counter()
        dyn_counters[w] = run(w, wcap)
        if first_w_seconds is None:
            first_w_seconds = time.perf_counter() - tw
    dyn_total = time.perf_counter() - t0
    records.append({
        "mode": "dynamic", "weights": w_max, "count_per_weight": count,
        "weight_cap": wcap,
        "total_seconds": round(dyn_total, 2),
        "first_weight_seconds": round(first_w_seconds, 2),
        "steady_weight_seconds": round(
            (dyn_total - first_w_seconds) / max(w_max - 1, 1), 3),
        "samples_per_s_sweep": round(w_max * count / dyn_total, 1),
        "compiled_programs": None,
        "note": ("every weight runs the same K1 kernel, built once at first "
                 "use: the first-weight wall includes building and loading "
                 "it; there is no per-weight program to compile"),
    })
    print(f"dynamic: {w_max} weights in {dyn_total:.1f}s (first "
          f"{first_w_seconds:.1f}s, steady "
          f"{records[-1]['steady_weight_seconds']}s/weight)", flush=True)

    stat_seconds = {}
    for w in probes:
        tw = time.perf_counter()
        static = run(w, None)
        stat_seconds[w] = time.perf_counter() - tw
        rec = {
            "mode": "static_probe", "weight": w,
            "seconds_incl_compile": None,
            "seconds": round(stat_seconds[w], 2),
            "counters_static": static.tolist(),
            "counters_dynamic": dyn_counters[w].tolist(),
            "tested_equal": bool(static[0] == dyn_counters[w][0]),
            "bit_identical_draws": w == wcap,
        }
        if w == wcap:
            gate(np.array_equal(static, dyn_counters[w]),
                 f"W={w} == weight_cap: static {static.tolist()} != dynamic "
                 f"{dyn_counters[w].tolist()}")
            rec["counters_bit_equal"] = True
        records.append(rec)
        print(f"static W={w}: {stat_seconds[w]:.2f}s", flush=True)

    later = [stat_seconds[w] for w in probes[1:]] or [stat_seconds[probes[0]]]
    per_weight_mean = float(np.mean(later))
    records.append({
        "mode": "summary",
        "static_seconds_per_weight_mean": round(per_weight_mean, 2),
        "static_projected_58_weights": round(per_weight_mean * w_max, 1),
        "dynamic_58_weights": round(dyn_total, 1),
        "sweep_speedup": round(per_weight_mean * w_max / dyn_total, 1),
    })
    meta = {"artifact": "dynamic_weight_real", "code": str(code),
            "device_kind": where["device_kind"],
            "note": ("the reference's own w..W sweep loop (main.cu:91-104) "
                     "with the dynamic sampler (sampling/errors.py::"
                     "sample_weight_w_errors_dynamic + run_monte_carlo "
                     "weight_cap) against static-sampler probes; the port "
                     "compiles no per-weight program, so the projected "
                     "static sweep costs what the dynamic one does")}
    records.insert(0, meta)
    write_records(out_path("dynamic_weight_real", out), records, where)
    return records


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--w-max", type=int, default=W_MAX)
    ap.add_argument("--count", type=int, default=COUNT)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--probes", default=",".join(map(str, PER_WEIGHT_PROBE)))
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    main(a.device, a.w_max, a.count, a.batch,
         tuple(int(w) for w in a.probes.split(",")), a.out)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
