"""Data-parallel weak scaling of the sharded Monte-Carlo harness.

The port of ``benchmarks/scaling.py``.  Measures full-pipeline decode
throughput at increasing data-axis rank counts through the production
data-parallel path (``parallel/montecarlo.py::make_sharded_chunk``: the
generators of (seed, chunk, data index), the counters summed over the data
axis by one all_reduce), sum-product on each rank (K1 on a card).  One
record per rank count.

On one card each count d > 1 is a world of d ranks spawned by
``parallel/mesh.py::spawn``, all of them on the same H100 over gloo (which
stages every collective through host memory): the walls are a functional
proxy that bounds sharing one card, not multi-card scaling, and each
record's note says so.  d = 1 runs in this process on one device
(``run_monte_carlo``).  ``--device cpu`` runs the same worlds as gloo CPU
ranks (the JAX script's ``--cpu N``).  Under ``torchrun`` with one card
per rank, the same code measures real scaling at the world's size
(``--devices`` is then the world size alone): that needs several cards and
is not measured in this repository.

The JAX script's ``--kernel`` has no counterpart: on a CUDA tensor the port
always runs the algorithm's kernel (the plain versions take 100-800 ms a
decode on the card, PERF.md §6, and no switch routes the run through
them).

    python benchmarks_torch/scaling.py --devices 1,2,4
    python benchmarks_torch/scaling.py --device cpu --devices 1,2 --iters 20 \\
        --batch-per-device 64 --chunks 1
    torchrun --nproc-per-node=4 benchmarks_torch/scaling.py
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmarks_torch.common import (  # noqa: E402
    best_of,
    card,
    emit,
    gate,
    out_path,
    resolve_device,
    route,
    write_records,
)
from qec_ldpc_tpu_torch import construct_code  # noqa: E402
from qec_ldpc_tpu_torch.decoder import BPConfig, CodeGraphs  # noqa: E402
from qec_ldpc_tpu_torch.kernels import bp_cuda  # noqa: E402
from qec_ldpc_tpu_torch.parallel import (  # noqa: E402
    make_mesh,
    make_sharded_chunk,
    maybe_init_distributed,
    run_monte_carlo,
    spawn,
)
from qec_ldpc_tpu_torch.sampling import make_rank_basis_test  # noqa: E402


def timed_run(mesh, code, weight: int, p: float, iters: int,
              batch_per_device: int, chunks: int, algorithm: str,
              repeats: int, device=None) -> dict:
    """One rank's best time for ``chunks`` chunks of ``batch_per_device``
    lanes (``mesh`` None: one device, ``device``), the counters checked;
    returns ``{"seconds", "tested", "executed", "launches"}``: the executed
    X + Z lane-iterations of a run over the data axis, and the K1 launches
    in this process."""
    if mesh is not None:  # a spawned rank: one host thread each
        torch.set_num_threads(1)
        device = mesh.device
    graphs = CodeGraphs.build(construct_code(*code))
    test = make_rank_basis_test(graphs.code, device)
    cfg = BPConfig(max_iters=iters, check_every=iters + 1,
                   algorithm=algorithm)
    d = 1 if mesh is None else mesh.size("data")
    want = chunks * batch_per_device * d
    out = {}
    if mesh is None:
        def dispatch():
            counters, out["executed"] = run_monte_carlo(
                graphs, weight, want, p, cfg, seed=0,
                batch_size=batch_per_device, steps_per_call=chunks,
                i_minus_p=test, device=device)
            gate(counters[0] == want, f"tested {counters[0]} of {want}")
    else:
        chunk_fn = make_sharded_chunk(mesh, graphs, weight, cfg,
                                      batch_per_device)

        def dispatch():
            counters, iters_xz = chunk_fn(test, 0, p, range(chunks),
                                          device=device)
            tested = int(counters[0])
            out["executed"] = int(iters_xz.sum())
            gate(tested == want, f"tested {tested} of {want}")
    before = bp_cuda.launches
    _, _, seconds = best_of(dispatch, repeats)
    return {"seconds": seconds, "tested": want, "executed": out["executed"],
            "launches": bp_cuda.launches - before}


def main(device: str = "cuda", code=(4, 5, 10, 61, 9, 49), devices=None,
         iters: int = 100, batch_per_device: int = 2048, chunks: int = 8,
         weight: int = 15, p: float = 0.01, algorithm: str = "sum-product",
         repeats: int = 3, out: str | None = None) -> list:
    """One record per rank count (default: 1, 2, 4, ... up to the cards,
    the JAX script's rule); returns them."""
    device = resolve_device(device)
    args = (tuple(code), weight, p, iters, batch_per_device, chunks,
            algorithm, repeats)
    torchrun = maybe_init_distributed(device.type)
    if torchrun:
        mesh = make_mesh(device_type=device.type)
        world = mesh.size("data")
        runs = {world: timed_run(mesh, *args)}
        where = card(mesh.device)
        notes = {world: f"torchrun: {world} ranks, one card each"}
        if torch.distributed.get_rank() != 0:
            return []
    else:
        where = card(device)
        if devices is None:
            cards = torch.cuda.device_count() if device.type == "cuda" else 1
            devices, d = [], 1
            while d <= max(cards, 1):
                devices.append(d)
                d *= 2
        runs = {}
        for d in devices:
            if d == 1:
                runs[d] = timed_run(None, *args, device=device)
            else:
                runs[d] = spawn(timed_run, d, device_type=device.type,
                                args=args)[0]
        notes = {d: "one device in this process" if d == 1 else
                 f"{d} gloo CPU ranks spawned on this host: a functional "
                 f"check" if device.type == "cpu" else
                 f"{d} ranks spawned on the one card over gloo: they share "
                 f"it, a functional proxy, not multi-card scaling"
                 for d in devices}
    records = []
    base_rate = base_d = None
    for d, run in runs.items():
        # executed lane-iterations, X and Z halved (one iteration-codeword)
        rate = run["executed"] / 2 / run["seconds"]
        if base_rate is None:
            base_rate, base_d = rate, d
        rec = {
            "metric": "mc_scaling",
            "devices": d,
            "platform": "gpu" if device.type == "cuda" else device.type,
            "bp_iter_codewords_per_s": round(rate, 1),
            "samples_per_s": round(run["tested"] / run["seconds"], 1),
            "speedup_vs_base": round(rate / base_rate, 2),
            "parallel_efficiency": round((rate / base_rate) / (d / base_d), 3),
            "unit": (f"weak scaling, {batch_per_device} samples/device, "
                     f"fixed {iters} iters (a lane that passes the first "
                     f"test stops; executed lane-iterations), {algorithm}:"
                     f"{route(device)}"),
            "note": notes[d],
            "launches_rank0": run["launches"],
        }
        emit({**rec, **where})
        records.append(rec)
    write_records(out_path("scaling", out), records, where)
    return records


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--code", type=int, nargs=6, default=[4, 5, 10, 61, 9, 49],
                    metavar=("J", "K", "L", "P", "sigma", "tau"))
    ap.add_argument("--devices", default="",
                    help="comma-separated rank counts (default: 1,2,4,... "
                         "up to the cards)")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--batch-per-device", type=int, default=2048)
    ap.add_argument("--chunks", type=int, default=8)
    ap.add_argument("--weight", type=int, default=15)
    ap.add_argument("--p", type=float, default=0.01)
    ap.add_argument("--algorithm", default="sum-product")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    devices = [int(d) for d in a.devices.split(",")] if a.devices else None
    main(a.device, tuple(a.code), devices, a.iters, a.batch_per_device,
         a.chunks, a.weight, a.p, a.algorithm, out=a.out)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
