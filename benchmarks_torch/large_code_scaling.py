"""Large-code graph sharding: the (data x graph) statistics pipeline on the
codes that need the graph axis, and the one-card memory math.

The port of ``benchmarks/large_code_scaling.py``.  A P=521 Hagiwara-Imai
code ([[5210,521]]-class) and the BB [[756,16,34]] code run through the
graph-parallel Monte-Carlo path (``parallel/mc_graph.py::
make_graph_sharded_chunk``) at each graph-axis size the JAX script uses,
min-sum, 30 iterations, 16 lanes, one chunk:

* [[5210,521]] at (1,1) decodes on one device through the data chunk (K2
  on a card); at (1,2) and (1,5) graph-sharded, K8 on each rank;
* [[756,16,34]] at (1,1) through K5; at (1,3) and (1,7) on the
  lane-sharded lifted engine (``parallel/lifted_sharded.py``), which has no
  kernel (the JAX package has none either).

(1,1) runs in this process (the data chunk of a one-rank mesh: the
generator of (seed, chunk, data index 0)); each (1, G) is a world of G
ranks spawned by ``parallel/mesh.py::spawn``.  The counters and the
executed lane-iterations must be equal across shapes, exactly (gated): the
port's min-sum engines are the single-device decode bit for bit.  On one
card every rank of a world shares the H100 over gloo, which stages each
collective through host memory: the walls are a functional proxy, not
multi-card scaling (``wall_note``).

The communication record: the JAX script's analytic model of its own
engines (``halo_bytes_recv_per_dev_per_iter``, ``comm_compute_ratio``; for
the lifted engine a ppermute halo, ``*_upper``) is kept under its keys as
the JAX package's figure.  Beside it, what the port's counted ``Mesh``
moved in the timed chunk (``all_gathers_per_dev``,
``all_gather_bytes_recv_per_dev``, rank 0), and that over the chunk's X + Z
loop iterations (``all_gather_bytes_recv_per_dev_per_iter``): the port's
circulant engine gathers each graph's (min; sign) partials every iteration,
its lifted engine routes by one all_gather a routing (two an iteration).

The memory rows take the card's own figures (``torch.cuda.
get_device_properties`` and the min-sum plans on the opt-in shared memory,
``benchmarks_torch/common.py::min_sum_plans``) in place of the JAX script's
v5e constants; its VMEM keys are TPU keys and null.

    python benchmarks_torch/large_code_scaling.py [--out PATH]
    python benchmarks_torch/large_code_scaling.py --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmarks_torch.common import (  # noqa: E402
    card,
    gate,
    graphs_of,
    min_sum_plans,
    out_path,
    resolve_device,
    write_records,
)
from qec_ldpc_tpu_torch.decoder import BPConfig, CodeGraphs, decode_batch  # noqa: E402
from qec_ldpc_tpu_torch.kernels import (  # noqa: E402
    lifted_min_sum_cuda,
    min_sum_cuda,
    sharded_step_cuda,
)
from qec_ldpc_tpu_torch.parallel import make_graph_sharded_chunk, spawn  # noqa: E402
from qec_ldpc_tpu_torch.parallel.chunk import (  # noqa: E402
    chunk_generator,
    sample_syndromes,
)
from qec_ldpc_tpu_torch.sampling import classify_batch, make_rank_basis_test  # noqa: E402

SEED = 17
WALL_NOTE = {
    "cuda": ("(1, G > 1): G ranks share one card over gloo (host-staged "
             "collectives): a functional proxy, not multi-card scaling"),
    "cpu": ("gloo CPU ranks on a few-core host: a functional proxy, not "
            "multi-card scaling"),
}
#: name -> (code, shapes, weight, p); [[72,12,6]] and [[42]] for the tests
CODES = {
    "qc_P521": ((4, 5, 10, 521, 25, 1), ((1, 1), (1, 2), (1, 5)), 220, 0.01),
    "bb_756": ("[[756,16,34]]", ((1, 1), (1, 3), (1, 7)), 24, 0.01),
    "qc_P7": ((3, 3, 6, 7, 2, 3), ((1, 1), (1, 2), (1, 3)), 2, 0.02),
    "bb_72": ("[[72,12,6]]", ((1, 1), (1, 3)), 4, 0.03),
}
DEFAULT_CODES = ("qc_P521", "bb_756")


def launches() -> dict:
    return {"min_sum": min_sum_cuda.launches,
            "lifted_min_sum": lifted_min_sum_cuda.launches,
            "sharded_min_sum_step": sharded_step_cuda.launches}


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after if after[k] - before[k]}


def single_device(graphs: CodeGraphs, test, cfg: BPConfig, weight: int,
                  p: float, batch: int, device) -> dict:
    """(1,1): chunk 0 of the one-rank data mesh on ``device`` (``test`` the
    code's rank-basis test there), timed on a second call; also the chunk's
    X + Z loop iterations."""
    def run():
        xe, ze, sx, sz = sample_syndromes(
            graphs, chunk_generator(SEED, 0, device, 0), weight, p, batch,
            "weight")
        res = decode_batch(graphs, sx, sz, p, cfg)
        counters = classify_batch(test, xe, ze, res.decisions_x.to(xe.dtype),
                                  res.decisions_z.to(ze.dtype), res.error_code)
        return (counters.cpu().numpy(),
                [int(res.iter_samples_x), int(res.iter_samples_z)],
                int(res.iters_x + res.iters_z))

    run()
    before = launches()
    t0 = time.perf_counter()
    counters, lane_iters, loops = run()
    wall = time.perf_counter() - t0
    return dict(counters=counters, lane_iters=lane_iters, loops=loops,
                wall=wall, all_gathers=0, gathered_bytes=0,
                launches=_delta(launches(), before))


def sharded_rank(mesh, spec, cfg_kwargs: dict, weight: int, p: float,
                 batch: int) -> dict:
    """Rank function of a (1, G) world: chunk 0 through
    ``make_graph_sharded_chunk`` once to warm up, then timed, with what the
    rank's Mesh counted and the kernels it launched in the timed call."""
    torch.set_num_threads(1)
    graphs = graphs_of(spec)
    test = make_rank_basis_test(graphs.code, mesh.device)
    chunk_fn = make_graph_sharded_chunk(mesh, graphs, weight,
                                        BPConfig(**cfg_kwargs), batch)

    def run():
        counters, lane_iters = chunk_fn(test, SEED, p, [0], device=mesh.device)
        return counters.cpu().numpy(), lane_iters.cpu().tolist()

    run()
    before = (dict(mesh.collectives), mesh.gathered_bytes, launches())
    t0 = time.perf_counter()
    counters, lane_iters = run()
    wall = time.perf_counter() - t0
    return dict(counters=counters, lane_iters=lane_iters, wall=wall,
                all_gathers=mesh.collectives["all_gather"]
                - before[0]["all_gather"],
                gathered_bytes=mesh.gathered_bytes - before[1],
                launches=_delta(launches(), before[2]))


def jax_comm_model(graphs: CodeGraphs, ng: int, batch: int = 16) -> dict:
    """The JAX script's analytic model of its own engines' halo (its
    ``qc_comm`` / ``bb_comm``, at its default 16 lanes)."""
    if hasattr(graphs.x, "group"):
        l, m = graphs.x.group
        edge_blocks = graphs.x.num_edge_blocks + graphs.z.num_edge_blocks
        resident = edge_blocks * (l // max(ng, 1)) * m * batch * 4
        recv = 2 * resident if ng > 1 else 0
        return {"halo_bytes_recv_per_dev_per_iter_upper": recv,
                "resident_edge_bytes_per_dev": resident,
                "comm_compute_ratio_upper": round(recv / resident, 3)
                if resident else 0}
    B_x, B_z, L, P = graphs.x.B, graphs.z.B, graphs.x.L, graphs.x.P
    recv = (ng - 1) * (B_x + B_z) * P * batch * 4 if ng > 1 else 0
    resident = (B_x + B_z) * L // max(ng, 1) * P * batch * 4
    return {"halo_bytes_recv_per_dev_per_iter": recv,
            "resident_edge_bytes_per_dev": resident,
            "comm_compute_ratio": round(recv / resident, 3) if resident else 0}


def memory_model(name: str, n: int, graph_x, graph_z, rank_x: int,
                 rank_z: int, device: torch.device, batch: int = 2048) -> dict:
    """One code's single-card memory math (float32 message state) with the
    card's device memory, opt-in shared memory and min-sum plans."""
    edges = graph_x.num_edges + graph_z.num_edges
    edge_state = edges * 4  # bytes per lane (V only)
    dense_classify = (2 * n) ** 2
    basis_classify = (rank_x + rank_z) * n
    row = {
        "code": name, "n": n, "edges": edges,
        "edge_state_bytes_per_lane": edge_state,
        "kernel_vmem_bytes_at_tile": None,
        "kernel_fits_vmem_at_tile128": None,
        "hbm_bytes_at_batch": edge_state * batch,
        "fits_hbm_at_batch2048": None,
        "dense_classify_bytes": dense_classify,
        "rank_basis_classify_bytes": basis_classify,
        "classify_shrink_factor": round(dense_classify / basis_classify, 1),
        "device_memory_bytes": None, "min_sum_plan": None,
    }
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
        row.update(fits_hbm_at_batch2048=edge_state * batch < total,
                   device_memory_bytes=total,
                   min_sum_plan=min_sum_plans(graph_x, graph_z, device))
    return row


def circulant_shape(B: int, L: int, P: int):
    """The sizes a plan reads, of a B x L circulant graph of lift P."""
    return types.SimpleNamespace(num_edges=B * L * P, num_checks=B * P,
                                 num_vars=L * P)


def main(device: str = "cuda", codes=DEFAULT_CODES, shapes=None,
         batch: int = 16, max_iters: int = 30, memory: bool = True,
         out: str | None = None) -> list:
    """Every code's shapes (``shapes``: name -> shapes to run instead of
    CODES'); returns the records (meta line first).  Raises if the counters
    or lane-iterations differ across shapes."""
    device = resolve_device(device)
    where = card(device)
    cfg_kwargs = dict(max_iters=max_iters, algorithm="min-sum")
    records = []
    built = {}
    for name in codes:
        spec, code_shapes, weight, p = CODES[name]
        graphs = graphs_of(spec)
        test = make_rank_basis_test(graphs.code, device)
        built[name] = graphs, test
        code_shapes = (shapes or {}).get(name, code_shapes)
        if code_shapes[0] != (1, 1):
            raise ValueError(f"{name}: the shapes start with (1, 1), the "
                             f"reference of the others, not {code_shapes[0]}")
        base = None
        for (nd, ng) in code_shapes:
            if (nd, ng) == (1, 1):
                run = single_device(graphs, test, BPConfig(**cfg_kwargs),
                                    weight, p, batch, device)
            else:
                run = spawn(sharded_rank, nd, ng, device_type=device.type,
                            args=(spec, cfg_kwargs, weight, p, batch))[0]
            if base is None:
                base = run
            gate(np.array_equal(base["counters"], run["counters"])
                 and base["lane_iters"] == run["lane_iters"],
                 f"{name} {nd}x{ng}: counters or lane-iterations diverged: "
                 f"{base['counters'].tolist()} {base['lane_iters']} vs "
                 f"{run['counters'].tolist()} {run['lane_iters']}")
            rec = {
                "code": f"{name} {graphs.code}", "num_data": nd,
                "num_graph": ng, "batch_per_data_shard": batch,
                "weight": weight, "p": p, "algorithm": "min-sum",
                "max_iters": max_iters,
                "counters": run["counters"].tolist(),
                "lane_iters": run["lane_iters"],
                "wall_seconds": round(run["wall"], 3),
                "wall_note": WALL_NOTE[device.type],
                **jax_comm_model(graphs, ng),
                "loop_iterations": base["loops"],
                "all_gathers_per_dev": run["all_gathers"],
                "all_gather_bytes_recv_per_dev": run["gathered_bytes"],
                "all_gather_bytes_recv_per_dev_per_iter": round(
                    run["gathered_bytes"] / base["loops"], 1),
                "launches_rank0": run["launches"],
            }
            records.append(rec)
            print(f"{name} data={nd} graph={ng}: {run['wall']:.3f}s "
                  f"counters={rec['counters']} lane_iters={rec['lane_iters']} "
                  f"all_gathers={run['all_gathers']} "
                  f"bytes={run['gathered_bytes']} launches={run['launches']}",
                  flush=True)
    if memory:
        rows = []
        for name in codes:
            g, t = built[name]
            rows.append(memory_model(f"{name} {g.code}", g.code.n, g.x, g.z,
                                     t.basis_x.shape[0], t.basis_z.shape[0],
                                     device))
        # the JAX script's analytic [[40990]]-class row (no code built)
        rows.append(memory_model(
            "qc_P4099_[[40990]]-class", 40990, circulant_shape(4, 10, 4099),
            circulant_shape(5, 10, 4099), 16000, 20000, device))
        records += [{"memory_model": row} for row in rows]
    records.insert(0, {
        "artifact": "large_code_scaling",
        "devices": torch.cuda.device_count() if device.type == "cuda" else 1,
        "device_kind": where["device_kind"],
        "note": ("graph-parallel statistics pipeline on codes needing the "
                 "graph axis; (1,1) in one process, (1,G) a spawned world of "
                 "G ranks over gloo (on one card every rank shares it: walls "
                 "are functional proxies); halo_bytes_* and "
                 "comm_compute_ratio* are the JAX package's analytic model "
                 "of its engines, all_gather_* what the port's counted Mesh "
                 "moved (rank 0, the timed chunk); memory rows use the "
                 "card's device memory, opt-in shared memory and min-sum "
                 "plans"),
    })
    write_records(out_path("large_code_scaling", out), records, where)
    return records


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--codes", default=",".join(DEFAULT_CODES))
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    main(a.device, tuple(a.codes.split(",")), out=a.out)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
