"""Large-code throughput, memory and the one-card limit, measured on the
card.

The port of ``benchmarks/large_code_real.py``.  The large codes run through
the single-device production path (``parallel/montecarlo.py::mc_chunk``:
sample -> syndromes -> X/Z min-sum -> classify) on the card, and each
record gives:

* fixed-work decode throughput (a convergence test at the first iteration
  only; a lane that passes it stops there, as the port's kernels exit per
  lane) and early-exit throughput (a test every 10): executed min-sum
  lane-iterations/s and samples/s;
* device memory (``torch.cuda.max_memory_allocated`` after
  ``reset_peak_memory_stats``, and ``memory_allocated``) after the run;
* where each graph's arrays live: ``kernels/placement.py::plan`` on the
  card's opt-in shared memory (``placement``: shared-memory bytes per CTA,
  V and the check state in shared memory or the lane's global slab).  It
  replaces the JAX script's VMEM budget and tile choice;
* the one-card limit probes P = 1051, 2081 and 4201 (256 lanes, 8 chunks,
  10 iterations), which take K2's P >= 768 route (K4, ``min_sum_run_wide``).
  At each probe K4 is first held to the plain
  ``decoder/min_sum.py::min_sum_run_lanes`` on one chunk's X and Z
  syndromes, bit for bit (gated): the JAX package's own Pallas and XLA rows
  disagree at P=2081 (``benchmarks/data/large_code_real_r5.jsonl:24-28``).

Codes: [[610,61]], P=131 [[1310,131]] and P=521 [[5210,521]] (K2), BB
[[756,16,34]] (K5), the probes (K4).  Each corrected count is held to the
JAX package's r5 record of the same code, weight, batch, chunks and mode by
a two-proportion test (|z| < 4, gated); at P=2081, where that record is not
its decoder's answer, to a JAX CPU run of the same shape (JAX_CPU_P2081).
Only ``torch.cuda.OutOfMemoryError`` is recorded as a wall (``"ok":
false``); any other error (a build, a launch, a gate) raises, and the
script exits non-zero.

The JAX record's ``kernel_tile_batch`` and ``compile_seconds_approx`` are
TPU keys and null; ``kernel`` is "cuda" (the JAX script's pallas / xla
engines have no counterpart: on a CUDA tensor the port always runs the
kernels; the plain versions take 100-800 ms a decode on the card, PERF.md
§6, and no switch routes the script through them).

    python benchmarks_torch/large_code_real.py [--out PATH]
    python benchmarks_torch/large_code_real.py --device cpu --qc 61 --no-bb \\
        --probes "" --batch 64 --chunks 1
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmarks_torch.common import (  # noqa: E402
    best_of,
    bits_equal,
    card,
    gate,
    jax_records,
    min_sum_plans,
    out_path,
    resolve_device,
    route,
    run_chunks,
    two_proportion_z,
    write_records,
)
from qec_ldpc_tpu_torch import construct_code  # noqa: E402
from qec_ldpc_tpu_torch.codes import find_code_params, known_bicycle_code  # noqa: E402
from qec_ldpc_tpu_torch.decoder import BPConfig, CodeGraphs  # noqa: E402
from qec_ldpc_tpu_torch.decoder import min_sum  # noqa: E402
from qec_ldpc_tpu_torch.kernels import min_sum_cuda  # noqa: E402
from qec_ldpc_tpu_torch.parallel.montecarlo import (  # noqa: E402
    chunk_generator,
    sample_syndromes,
)
from qec_ldpc_tpu_torch.sampling import make_rank_basis_test  # noqa: E402

#: (name, (J, K, L, P, sigma, tau) with sigma None for find_code_params,
#: batch, chunks): the JAX script's anchors and large QC codes
QC_SPECS = {
    61: ("qc_P61_[[610,61]]", (4, 5, 10, 61, 9, 49), 1024, 64),
    131: ("qc_P131_[[1310,131]]", (4, 5, 10, 131, None, None), 1024, 32),
    521: ("qc_P521_[[5210,521]]", (4, 5, 10, 521, 25, 1), 512, 8),
}
BB = ("bb_[[756,16,34]]", "[[756,16,34]]", 19, 1024, 8)
PROBES = (1051, 2081, 4201)
SEED = 11
P_ERR = 0.01
Z_LIMIT = 4.0
#: the JAX package's r5 rows of the P=2081 probe are not what its decoder
#: gives: both report every lane's Z syndrome failing and none corrected,
#: and its Pallas and XLA rows disagree on the Z convergence failures
#: (benchmarks/data/large_code_real_r5.jsonl:24-28).  The JAX package's own
#: chunk loop on the CPU at the probe's code, key, weight, batch, chunks and
#: iteration limit (kernel "xla") sums to these counters: the record's X and
#: convergence counters (156, 191, 224) and 1633 corrected
#: (tests/test_torch_large_code_reference.py reproduces them).  The probe is
#: held to them.
JAX_CPU_P2081 = (2048, 2048, 2048, 1633, 156, 280, 1, 191, 224)


def jax_row(name: str, weight: int, batch: int, chunks: int, iters: int,
            fixed_work: bool) -> dict | None:
    """The JAX package's record of this code and shape, if it has one: its
    r5 Pallas row, or at P=2081 its CPU run (JAX_CPU_P2081)."""
    if (name, weight, batch, chunks, iters) == ("qc_P2081_probe", 512, 256,
                                                8, 10):
        return {"counters": list(JAX_CPU_P2081)}
    for rec in jax_records("data/large_code_real_r5.jsonl")[1:]:
        if (rec.get("code"), rec.get("weight"), rec.get("batch"),
                rec.get("chunks"), rec.get("max_iters"),
                rec.get("fixed_work"), rec.get("kernel")) == (
                name, weight, batch, chunks, iters, fixed_work, "pallas"):
            return rec
    return None


def memory(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"bytes_in_use": None, "peak_bytes_in_use": None}
    return {"bytes_in_use": torch.cuda.memory_allocated(device),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(device)}


def main(device: str = "cuda", qc=(61, 131, 521), bb: bool = True,
         probes=PROBES, iters: int = 50, probe_batch: int = 256,
         probe_chunks: int = 8, probe_iters: int = 10,
         batch: int | None = None, chunks: int | None = None,
         repeats: int = 3, out: str | None = None) -> list:
    """Every code of ``qc`` (keys of QC_SPECS), [[756,16,34]] when ``bb``,
    and the ``probes``; returns the records (meta line first).  ``batch``
    and ``chunks`` override every code's (a functional run)."""
    device = resolve_device(device)
    where = card(device)
    kernel = route(device)
    records = []

    def bench_code(name, graphs, weight, b, c, it):
        test = make_rank_basis_test(graphs.code, device)
        b, c = batch or b, chunks or c
        edges = graphs.x.num_edges + graphs.z.num_edges
        plan = min_sum_plans(graphs.x, graphs.z, device)
        for fixed_work in (True, False):
            cfg = BPConfig(max_iters=it,
                           check_every=(it + 1 if fixed_work else 10),
                           algorithm="min-sum")
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            (counters, its), _, secs = best_of(
                lambda: run_chunks(graphs, test, cfg, seed=SEED,
                                   weight=weight, error_probability=P_ERR,
                                   batch=b, chunks=c, device=device), repeats)
            lane_iters = int(its.sum())
            rec = {
                "code": name, "n": graphs.code.n, "edges": edges,
                "algorithm": "min-sum", "kernel": kernel,
                "fixed_work": fixed_work, "weight": weight,
                "batch": b, "chunks": c, "max_iters": it,
                "kernel_tile_batch": None,
                "samples_per_s": round(b * c / secs, 1),
                "lane_iters_per_s": round(lane_iters / secs, 1),
                "seconds": round(secs, 4),
                "compile_seconds_approx": None,
                "edge_state_bytes_per_lane": edges * 4,
                "counters": counters.tolist(),
                **memory(device),
                "placement": plan,
            }
            records.append(rec)
            print(f"{name} fixed={fixed_work}: {rec['samples_per_s']:,} "
                  f"samples/s, {rec['lane_iters_per_s']:,.0f} lane-iters/s "
                  f"({secs:.4f}s)", flush=True)
            ref = jax_row(name, weight, b, c, it, fixed_work)
            if ref is None:
                print(f"{name} fixed={fixed_work}: no JAX record at this "
                      f"shape", flush=True)
                continue
            cnt = counters
            z = two_proportion_z(int(cnt[3]), int(cnt[0]), ref["counters"][3],
                                 ref["counters"][0])
            print(f"{name} fixed={fixed_work}: corrected {int(cnt[3])}/"
                  f"{int(cnt[0])} vs JAX {ref['counters'][3]}/"
                  f"{ref['counters'][0]}: z={z:+.2f}", flush=True)
            gate(abs(z) < Z_LIMIT, f"{name} fixed={fixed_work}: corrected "
                                   f"z={z:+.2f} against the JAX r5 record")

    def walled(name, fn, **fields):
        """Run ``fn``; a device out-of-memory error is the wall and is
        recorded, any other error raises."""
        try:
            fn()
            return True
        except torch.cuda.OutOfMemoryError as e:
            torch.cuda.empty_cache()
            records.append({**fields, "ok": False,
                            "error": f"{type(e).__name__}: {str(e)[:400]}"})
            print(f"{name}: out of device memory: {str(e)[:200]}", flush=True)
            return False

    for key in qc:
        name, (J, K, L, P, s, t), b, c = QC_SPECS[key]

        def qc_run():
            s_, t_ = (s, t) if s is not None else find_code_params(J, K, L, P)[0]
            code = construct_code(J, K, L, P, s_, t_)
            bench_code(name, CodeGraphs.build(code),
                       max(1, round(15 * code.n / 610)), b, c, iters)

        walled(name, qc_run, code=name)
    if bb:
        name, label, weight, b, c = BB
        walled(name, lambda: bench_code(
            name, known_bicycle_code(label).build_graphs(), weight, b, c,
            iters), code=name)

    for P in probes:
        rec = {"probe_P": P, "n": 10 * P, "kernel": kernel}

        def probe():
            s, t = find_code_params(4, 5, 10, P)[0]
            graphs = CodeGraphs.build(construct_code(4, 5, 10, P, s, t))
            w = max(1, round(15 * graphs.code.n / 610))
            # K4 against the plain loop on chunk 0, X and Z, bit for bit
            _, _, sx, sz = sample_syndromes(
                graphs, chunk_generator(SEED, 0, device), w, P_ERR,
                batch or probe_batch, "weight")
            llr = min_sum.prior_llr(np.float32(2.0 / 3.0) * np.float32(P_ERR))
            equal = True
            for graph, syn in ((graphs.x, sx), (graphs.z, sz)):
                v_k, it_k = min_sum_cuda.min_sum_run(graph, syn, llr,
                                                     probe_iters, 10)
                v_p, it_p = min_sum.min_sum_run_lanes(graph, syn, llr,
                                                      probe_iters, 10)
                equal &= bits_equal(v_k, v_p) and torch.equal(it_k, it_p)
            gate(equal, f"P={P}: K4 differs from the plain min-sum loop")
            rec["bit_equal_plain"] = True
            t0 = time.perf_counter()
            bench_code(f"qc_P{P}_probe", graphs, w, probe_batch,
                       probe_chunks, probe_iters)
            rec.update({"ok": True,
                        "total_seconds": round(time.perf_counter() - t0, 1)})

        if walled(f"P={P} probe", probe, **rec):
            records.append(rec)
    records.insert(0, {
        "artifact": "large_code_real",
        "device_kind": where["device_kind"],
        "platform": "gpu" if device.type == "cuda" else device.type,
        "note": ("one card's throughput and memory; fixed_work tests "
                 "convergence at the first iteration only (a lane that "
                 "passes stops); lane_iters counts executed X+Z min-sum "
                 "lane-iterations; placement is each graph's min-sum plan "
                 "on the card's opt-in shared memory; probes find the "
                 "one-card P limit, K4 held bit for bit to the plain loop "
                 "at each; only a device out-of-memory error is recorded "
                 "as a wall"),
    })
    write_records(out_path("large_code_real", out), records, where)
    return records


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--qc", default="61,131,521",
                    help="the circulant codes by P (61, 131, 521)")
    ap.add_argument("--no-bb", action="store_true")
    ap.add_argument("--probes", default=",".join(map(str, PROBES)))
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--chunks", type=int, default=None)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    ints = lambda s: tuple(int(x) for x in s.split(",") if x)  # noqa: E731
    main(a.device, ints(a.qc), not a.no_bb, ints(a.probes), batch=a.batch,
         chunks=a.chunks, out=a.out)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
