"""Shared benchmark plumbing of the port: timing, the fixed-work rule, the
card's identity, JSON emission.

The port of ``benchmarks/common.py``.  Every timing ends in a host read or
a ``torch.cuda.synchronize``, so the wall clock covers the device work;
each script warms up once (the first call builds and loads the kernels it
launches) and reports the best of ``repeats`` runs.  The JAX package's
``setup_jax_cache`` has no counterpart: the port compiles no programs, its
kernels are built once per source hash (``kernels/build.py``).

Every record a script writes carries the card's name (``device_kind``) and
power limit (``power_limit``, as ``nvidia-smi --query-gpu=power.limit``
gives it; None on the CPU).  Records go to ``benchmarks_torch/data/`` by
default and never into the JAX package's ``benchmarks/``.
"""

from __future__ import annotations

import functools
import json
import subprocess
import time
from pathlib import Path

import torch

from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.codes import known_bicycle_code
from qec_ldpc_tpu_torch.decoder import BPConfig, CodeGraphs
from qec_ldpc_tpu_torch.kernels import placement
from qec_ldpc_tpu_torch.parallel import mc_chunk
from qec_ldpc_tpu_torch.sampling import C_TESTED, NUM_COUNTERS

BASELINE_ITER_SAMPLES_PER_S = 8.87e4  # reference CPU whole-machine, SURVEY §6

DATA_DIR = Path(__file__).resolve().parent / "data"
#: the JAX package's records, which no script of the port writes
JAX_RECORDS = Path(__file__).resolve().parent.parent / "benchmarks"


def gate(ok: bool, what: str) -> None:
    """An in-run gate: raise (the script exits non-zero, prints no
    result) when ``ok`` is false."""
    if not ok:
        raise AssertionError(f"benchmark gate failed: {what}")


def resolve_device(device: str) -> torch.device:
    """``device`` as a torch.device; a CUDA device needs a card (no
    fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: the benchmark "
                         "measures the card (pass --device cpu for a "
                         "functional run)")
    return device


@functools.lru_cache(maxsize=None)
def _nvidia_smi(index: int) -> tuple[str, str]:
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    name, _, limit = out.partition(",")
    return name.strip(), limit.strip()


def card(device: torch.device) -> dict:
    """``{"device_kind", "power_limit"}`` of ``device``: the card's name
    and ``nvidia-smi``'s power limit ("700.00 W"), or "cpu" and None."""
    if device.type != "cuda":
        return {"device_kind": device.type, "power_limit": None}
    index = device.index if device.index is not None else torch.cuda.current_device()
    return {"device_kind": torch.cuda.get_device_name(index),
            "power_limit": _nvidia_smi(index)[1]}


def route(device: torch.device) -> str:
    """What decodes on ``device``: "cuda" (the kernels) or "plain" (the
    plain PyTorch versions, on the CPU)."""
    return "cuda" if device.type == "cuda" else "plain"


def graphs_of(spec) -> CodeGraphs:
    """A published BB label ("[[144,12,12]]") or construct_code's
    (J, K, L, P, sigma, tau) -> the code's graphs."""
    if isinstance(spec, str):
        return known_bicycle_code(spec).build_graphs()
    return CodeGraphs.build(construct_code(*spec))


def min_sum_plans(graph_x, graph_z, device: torch.device) -> dict | None:
    """Where the min-sum kernels keep each graph's arrays on ``device``'s
    opt-in shared memory (``kernels/placement.py::plan``): the limit
    (``smem_optin_bytes``) and ``"x"``, ``"z"`` each with the CTA's
    shared-memory bytes and threads, where V and the check state live and
    the lane's slab; None on the CPU."""
    if device.type != "cuda":
        return None
    limit = placement.smem_optin(device.index or 0)
    plans = {"smem_optin_bytes": limit}
    for side, graph in (("x", graph_x), ("z", graph_z)):
        pl = placement.plan(graph, False, limit)
        plans[side] = {"smem_bytes": pl.smem_bytes, "threads": pl.threads,
                       "v": "shared" if pl.v_shared else "global",
                       "check_state": ("shared" if pl.state_shared
                                       else "global"),
                       "slab_floats_per_lane": pl.slab_floats}
    return plans


def sync() -> None:
    """Wait for the card, if this process has used one."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def event_time(fn, repeats: int = 3) -> float:
    """Best seconds of ``repeats`` calls of ``fn`` after a warm-up: CUDA
    events around each call on a card, the host clock on the CPU."""
    fn()
    sync()
    best = float("inf")
    for _ in range(repeats):
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


def best_of(run, repeats: int):
    """(last result, first run's seconds, best of ``repeats`` more), each
    run timed on the host clock up to a synchronisation with the card (the
    scripts' runs end in a host read besides); the first run builds and
    loads the kernels it launches."""
    t0 = time.perf_counter()
    result = run()
    sync()
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        result = run()
        sync()
        best = min(best, time.perf_counter() - t0)
    return result, first, best


def _total_edges(graphs: CodeGraphs) -> int:
    return graphs.x.num_edges + graphs.z.num_edges


# bench.py's analytic float operations per iteration (sweep) of one sample,
# X and Z graphs: a deliberate undercount (no convergence, init or masking)
def bp_flops_per_iter_sample(graphs: CodeGraphs) -> float:
    return 18.0 * _total_edges(graphs)


def min_sum_flops_per_iter_sample(graphs: CodeGraphs) -> float:
    return 15.0 * _total_edges(graphs)


def layered_flops_per_sweep_sample(graphs: CodeGraphs) -> float:
    return 14.0 * _total_edges(graphs)


FLOP_MODELS = {"sum-product": bp_flops_per_iter_sample,
               "min-sum": min_sum_flops_per_iter_sample,
               "layered-min-sum": layered_flops_per_sweep_sample}


def fixed_work_rate(graphs: CodeGraphs, test, algorithm: str, *, weight: int,
                    error_probability: float, max_iters: int, batch: int,
                    chunks: int, repeats: int, device: torch.device,
                    seed: int = 0):
    """The fixed-work rate of ``algorithm``: ``chunks`` chunks of ``batch``
    samples (``mc_chunk``'s chunks 0.. of ``seed``) decoded with the
    convergence test only at the first iteration (``check_every =
    max_iters + 1``; layered tests none), best of ``repeats`` after a
    warm-up.  The kernels exit per lane, so a lane that passes that test
    stops after one iteration, where JAX's kernels run its 128-lane tile
    on: each graph of a chunk runs ``batch * max_iters - (max_iters - 1) *
    k`` lane-iterations, k the lanes that passed it, which is gated, and
    the rate counts the executed lane-iterations (X and Z, halved: one
    iteration-codeword is an X and a Z iteration).

    Returns ``(iteration-codewords/s, executed lane-iterations, counters
    (NUM_COUNTERS,) int64 numpy, best seconds)``."""
    cfg = BPConfig(max_iters=max_iters, check_every=max_iters + 1,
                   layered_check_every=max_iters + 1, algorithm=algorithm)
    (counters, its), _, best = best_of(
        lambda: run_chunks(graphs, test, cfg, seed=seed, weight=weight,
                           error_probability=error_probability, batch=batch,
                           chunks=chunks, device=device), repeats)
    gate(int(counters[C_TESTED]) == chunks * batch,
         f"{algorithm} fixed work tested {int(counters[C_TESTED])}")
    gate(int(((max_iters * batch - its) % (max_iters - 1)).sum()) == 0,
         f"{algorithm} fixed work: a lane stopped after a later test")
    executed = int(its.sum())
    return executed / 2 / best, executed, counters, best


def run_chunks(graphs: CodeGraphs, test, cfg: BPConfig, *, seed: int,
               weight: int, error_probability: float, batch: int,
               chunks: int, device: torch.device):
    """``mc_chunk``'s chunks 0..``chunks - 1`` of ``seed`` under ``cfg``,
    read to the host once at the end: (counters summed over the chunks,
    (NUM_COUNTERS,) int64, and each chunk's executed lane-iterations,
    (chunks, 2) int64 for X and Z), NumPy arrays."""
    counters = torch.zeros(NUM_COUNTERS, dtype=torch.int64, device=device)
    its = []
    for c in range(chunks):
        cnt, it = mc_chunk(graphs, test, seed, c, weight, error_probability,
                           cfg, batch, device=device)
        counters += cnt
        its.append(it.to(torch.int64))
    host = torch.cat([counters, torch.stack(its).reshape(-1)]).cpu().numpy()
    return host[:NUM_COUNTERS], host[NUM_COUNTERS:].reshape(chunks, 2)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal NaN masks and every other entry equal bit for bit."""
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(nan_a, nan_b) and torch.equal(
        a.view(torch.int32)[~nan_a], b.view(torch.int32)[~nan_b]))


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def out_path(name: str, path: str | Path | None = None) -> Path:
    """Where script ``name`` writes: ``path``, by default
    ``benchmarks_torch/data/<name>_h100.jsonl``.  A path inside the JAX
    package's ``benchmarks/`` is refused."""
    path = Path(path) if path is not None else DATA_DIR / f"{name}_h100.jsonl"
    if JAX_RECORDS in path.resolve().parents:
        raise ValueError(f"{path}: the JAX package's records are not "
                         f"written by the port")
    return path


def write_records(path: Path, records: list, where: dict) -> None:
    """Write ``records`` as JSON lines, each with ``where`` (:func:`card`)
    appended."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps({**rec, **where}) + "\n")
    print(f"wrote {path}", flush=True)


def two_proportion_z(k1: int, n1: int, k2: int, n2: int) -> float:
    """The two-proportion z statistic of k1/n1 against k2/n2 (0 when the
    pooled proportion is 0 or 1: the two agree exactly)."""
    pool = (k1 + k2) / (n1 + n2)
    if pool in (0.0, 1.0):
        return 0.0
    return ((k1 / n1 - k2 / n2)
            / (pool * (1 - pool) * (1 / n1 + 1 / n2)) ** 0.5)


def jax_records(relative: str) -> list:
    """The JAX package's committed records ``benchmarks/<relative>``, one
    dict per JSON line (the gates compare with them)."""
    with open(JAX_RECORDS / relative) as f:
        return [json.loads(line) for line in f if line.strip()]
