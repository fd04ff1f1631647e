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
import re
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from benchmarks_torch import jax_stream
from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.codes import known_bicycle_code
from qec_ldpc_tpu_torch.decoder import BPConfig, CodeGraphs, decode_batch
from qec_ldpc_tpu_torch.harness.stats import (
    parse_code_params,
    parse_reference_text,
)
from qec_ldpc_tpu_torch.kernels import placement
from qec_ldpc_tpu_torch.parallel import mc_chunk
from qec_ldpc_tpu_torch.sampling import (
    C_CONV_X,
    C_CONV_Z,
    C_CORRECTED,
    C_LOGICAL,
    C_SYN_X,
    C_SYN_Z,
    C_TESTED,
    NUM_COUNTERS,
    classify_batch,
)

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
               chunks: int, device: torch.device,
               weight_cap: int | None = None, stream: str = "port"):
    """``mc_chunk``'s chunks 0..``chunks - 1`` of ``seed`` under ``cfg``
    (errors from the dynamic sampler with ``weight_cap`` candidates when it
    is given), read to the host once at the end: (counters summed over the
    chunks, (NUM_COUNTERS,) int64, and each chunk's executed
    lane-iterations, (chunks, 2) int64 for X and Z), NumPy arrays.  The
    benchmarks' one per-point Monte-Carlo loop: every sum is int64 (a
    point of 2^20 lanes at 10^5 iterations runs ~10^11 lane-iterations).

    ``stream="jax"``: chunk c's errors are instead the JAX package's draws
    for the same point, its dynamic sampler's from ``fold_in(PRNGKey(seed),
    c)`` (``jax_stream``), decoded and classified as ``mc_chunk`` does: on
    them the port computes what JAX's own script computes on an IEEE
    device."""
    if stream not in ("port", "jax"):
        raise ValueError(f"unknown stream {stream!r}")
    counters = torch.zeros(NUM_COUNTERS, dtype=torch.int64, device=device)
    its = []
    for c in range(chunks):
        if stream == "jax":
            xe, ze = (e.to(torch.int32) for e in
                      jax_stream.sample_weight_w_errors_dynamic(
                          jax_stream.fold_in(jax_stream.prng_key(seed), c),
                          graphs.code.n, weight, weight_cap, batch, device))
            res = decode_batch(graphs, graphs.x.syndrome(xe),
                               graphs.z.syndrome(ze), error_probability, cfg)
            cnt = classify_batch(test, xe, ze, res.decisions_x.to(torch.int32),
                                 res.decisions_z.to(torch.int32),
                                 res.error_code)
            it = torch.stack([res.iter_samples_x, res.iter_samples_z])
        else:
            cnt, it = mc_chunk(graphs, test, seed, c, weight,
                               error_probability, cfg, batch, device=device,
                               weight_cap=weight_cap)
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


def gate_parity(label: str, zs: list, full: bool) -> float:
    """The port against JAX's run of the same points (:func:`jax_twin`):
    every ``(what, z)`` of ``zs``, the two-proportion z of a port count
    against JAX's, below 5 in magnitude, and, when the run covered the
    script's whole corpus (``full``), their median |z| at most 1.  Returns
    that median (0 when there is nothing to compare)."""
    for what, z in zs:
        gate(abs(z) < 5.0, f"{label} {what}: port vs JAX z = {z:+.3f}")
    median = float(np.median([abs(z) for _, z in zs])) if zs else 0.0
    gate(not full or median <= 1.0,
         f"{label}: median port-vs-JAX |z| = {median:.3f} > 1")
    worst = max(zs, key=lambda wz: abs(wz[1]), default=("-", 0.0))
    print(f"{label}: port vs JAX over {len(zs)} counts, median |z| "
          f"{median:.3f}, max |z| {abs(worst[1]):.3f} ({worst[0]})",
          flush=True)
    return median


#: JAX's own per-point body on the CPU (``tests/golden_jax_cpu.py``, XLA,
#: jax 0.9.0) at three points of the JAX records' keys and depths: the
#: counters a ``--stream jax`` run must equal exactly on the card.  The TPU
#: records at these points differ (golden_dated's archive W=5 corrected +
#: logical 495,488 against 492,322 here), the TPU's arithmetic, not JAX's
#: decoder.
JAX_CPU_RUNS = {
    # golden_sweep W=40, p_0.01 label, MAX=100: PRNGKey(1040), cap 64, 5 x 2048
    ("golden_sweep", 40, 0.01, 100):
        (10240, 10240, 10240, 7704, 1348, 1329, 39, 733, 15),
    # golden_dated archive [[42,0]] W=5, 6: PRNGKey(5208), (5209), cap 48
    ("golden_dated", "archive", (3, 3, 6, 7, 2, 3), 5):
        (1048576, 1044233, 1044299, 124922, 325029, 325481, 367400, 205816,
         206342),
    ("golden_dated", "archive", (3, 3, 6, 7, 2, 3), 6):
        (1048576, 1047139, 1047099, 41275, 399661, 400818, 352597, 314751,
         315282),
}


#: the note of a ``--stream jax`` record
JAX_STREAM_NOTE = (
    "the JAX record's own points, keys, caps and depth: its samples drawn "
    "in PyTorch by benchmarks_torch/jax_stream.py (jax.random's threefry "
    "stream, bit for bit) and decoded on the card by the port, which is "
    "the JAX decoder bit for bit on IEEE arithmetic: what the JAX script "
    "gives on an IEEE device (JAX_CPU_RUNS hold it exactly at three "
    "points).  The TPU record's counts on the same samples differ by the "
    "TPU's arithmetic.  The port's own runs are gated on this record")


def stream_name(name: str, stream: str) -> str:
    """The record a script writes: ``name`` for the port's own samples,
    ``<name>_jaxstream`` for the JAX records' samples."""
    return name if stream == "port" else f"{name}_jaxstream"


def jax_twin(name: str) -> list:
    """The point lines of ``benchmarks_torch/data/<name>_jaxstream_h100
    .jsonl``: the JAX record's own samples (its keys, caps and depth, drawn
    by ``jax_stream``) decoded on the card by the port, which is JAX's
    decoder bit for bit on IEEE arithmetic: what the JAX script gives on an
    IEEE device.  The port's own runs are held to it, not to the TPU
    records, whose arithmetic is the TPU's (``JAX_CPU_RUNS``)."""
    with open(DATA_DIR / f"{name}_jaxstream_h100.jsonl") as f:
        return [json.loads(line) for line in f if line.strip()][1:]


def gate_jax_cpu(key: tuple, counters, batch: int) -> None:
    """A ``--stream jax`` point that ``JAX_CPU_RUNS`` holds, drawn as the
    JAX script draws it (its batch of 2048 and depth), must equal it."""
    want = JAX_CPU_RUNS.get(key)
    if want is not None and batch == 2048 and int(counters[0]) == want[0]:
        got = tuple(int(x) for x in counters)
        gate(got == want, f"{key}: the JAX stream gives {got}, JAX on the "
                          f"CPU {want}")
        print(f"{key}: equal to JAX on the CPU", flush=True)


def jax_records(relative: str) -> list:
    """The JAX package's committed records ``benchmarks/<relative>``, one
    dict per JSON line (the gates compare with them)."""
    with open(JAX_RECORDS / relative) as f:
        return [json.loads(line) for line in f if line.strip()]


# -- the reference's counts ------------------------------------------------------

#: construct_code's parameters of the corpus's two named codes
FLAGSHIP = (4, 5, 10, 61, 9, 49)   # [[610,61]], results/[4,5,10,61,9,49]/
CODE42 = (3, 3, 6, 7, 2, 3)        # [[42,0]], results/[2,3,6,7,2,3]/
#: the counters the records name, each with the reference file's field
#: (CodeStatistics.h:22-37) and the index of the port's counter
COUNTERS = {"tested": ("Errors Tested", C_TESTED),
            "corrected": ("Corrected", C_CORRECTED),
            "logical": ("Logical Errors", C_LOGICAL),
            "syn_x": ("Syndrome Errors X", C_SYN_X),
            "syn_z": ("Syndrome Errors Z", C_SYN_Z),
            "conv_x": ("Convergence Fail X", C_CONV_X),
            "conv_z": ("Convergence Fail Z", C_CONV_Z)}
#: per corpus script: the committed JAX record that carries the reference's
#: side of each point (``ler_sweep`` reads the sweep record of its code) and
#: the counters the script compares
REFERENCE = {
    "golden_sweep": ("data/golden_sweep_r3.jsonl",
                     ("tested", "corrected", "logical", "syn_x", "syn_z")),
    "golden_sweep42": ("data/golden_sweep42_deep_r5.jsonl", tuple(COUNTERS)),
    "golden_deep": ("data/golden_deep_r4.jsonl", tuple(COUNTERS)),
    "golden_dated": ("data/golden_dated_r5.jsonl",
                     ("tested", "corrected", "syn_x", "syn_z", "conv_x",
                      "conv_z")),
    "ler_sweep": (None, ("tested", "corrected", "logical")),
}
#: the corpus directory of each named code, and the sweep script whose
#: record holds its points
NAMED_DIRS = {FLAGSHIP: ("[4,5,10,61,9,49]", "golden_sweep"),
              CODE42: ("[2,3,6,7,2,3]", "golden_sweep42")}
#: the reference's deepest [[610,61]] file (100,000 samples, 1 logical
#: error), at the corpus root; golden_deep reads its W=15 point from it
HEADLINE_FILE = ("[J=4,K=5,L=10,P=61,s=9,t=49][[n=610,k=61]]"
                 "_W_15_MAX_100_p_0.01.txt")
#: golden_dated's dated directories: the MAX sweep's, each with its cap, and
#: the pre-detection one (cap unrecorded)
MAX_SWEEP_DIRS = (("11-20-2017_max_50_iterations", 50),
                  ("11-20-2017_max_100_iterations", 100),
                  ("11-20-2017_max_1000_iterations", 1000))
PRE_DETECTION_DIR = "11-18-2017_no_logical_error_detection"
_NAME_RE = re.compile(r"_W_(\d+)_MAX_(\d+)_p_([0-9.]+)\.txt$")


class RefPoint(NamedTuple):
    """One point of the reference's corpus: its weight, iteration cap (None
    where the file records none), the p in the file's name (None where
    there is none) and the reference's count of each counter the script
    compares.  golden_dated's points also name their section, their code
    (construct_code's parameters; the archive mixes two) and, in the dated
    directories, their file."""

    weight: int
    max_iters: int | None
    p: float | None
    counts: dict
    section: str | None = None
    code: tuple | None = None
    file: str | None = None


def reference_points(script: str, ref_dir: str | Path | None = None,
                     code: tuple = FLAGSHIP) -> tuple[list, str | None]:
    """``(points, source)``: the reference's counts at every point of the
    corpus script ``script``, as :class:`RefPoint`s in the order the JAX
    script visits them, and where they were read.

    With no ``ref_dir`` they come from the committed JAX record of the
    same script (``REFERENCE``; fraction-only records are rounded back to
    counts) and ``source`` names that file.  ``ref_dir``, the corpus's
    ``results`` directory, reads the corpus files instead, through
    ``harness/stats.py::parse_reference_text``, as the JAX scripts do; the
    W=15 point of golden_deep is then the headline file at its root, and
    ``source`` is the directory.  ``code``: ler_sweep's code (its named
    directory, or its sweep record; other codes have no points and
    ``source`` None)."""
    relative, fields = REFERENCE[script]
    if ref_dir is not None:
        return _corpus_points(script, Path(ref_dir), fields, tuple(code)), \
            str(ref_dir)
    if script == "ler_sweep":
        if tuple(code) not in NAMED_DIRS:
            return [], None
        relative = REFERENCE[NAMED_DIRS[tuple(code)][1]][0]
    points, seen = [], set()
    for rec in jax_records(relative)[1:]:
        n = rec["ref_tested"]
        counts = {f: (n if f == "tested" else rec[f"ref_{f}"]
                      if f"ref_{f}" in rec
                      else round(rec[f"ref_{f}_fraction"] * n))
                  for f in fields}
        key = (rec.get("section"), rec.get("code"), rec.get("file"),
               rec["weight"], rec.get("max_iters"), rec.get("p"))
        if key in seen:   # golden_dated's candidate caps share one file
            continue
        seen.add(key)
        dated = script == "golden_dated"
        points.append(RefPoint(
            rec["weight"], rec.get("max_iters"),
            rec.get("p", rec.get("p_label")), counts, rec.get("section"),
            parse_code_params(rec["code"]) if dated else None,
            rec.get("file")))
    return points, f"benchmarks/{relative}"


def _read_reference(path: Path) -> list:
    with open(path) as f:
        return parse_reference_text(f.read())


def _counts(rec: dict, fields) -> dict:
    return {f: int(rec[COUNTERS[f][0]]) for f in fields}


def _named_points(directory: Path, fields, section=None, code=False) -> list:
    """The first record of every ``..._W_w_MAX_m_p_p.txt`` file in
    ``directory`` (an empty file is skipped), in file-name order; ``code``:
    each point names its code, read from its record."""
    points = []
    for path in sorted(directory.glob("*.txt")):
        m = _NAME_RE.search(path.name)
        recs = _read_reference(path) if m else []
        if recs:
            points.append(RefPoint(
                int(m[1]), int(m[2]), float(m[3]), _counts(recs[0], fields),
                section, parse_code_params(recs[0]["Code"]) if code else None))
    return points


def _dated_points(directory: Path, fields, section: str,
                  max_iters: int | None) -> list:
    """Every record with an ``Error Weight`` in ``directory``'s files (the
    2017 files are named by run index), in file-name order."""
    return [RefPoint(int(rec["Error Weight"]), max_iters, None,
                     _counts(rec, fields), section,
                     parse_code_params(rec["Code"]), path.name)
            for path in sorted(directory.glob("*.txt"))
            for rec in _read_reference(path) if "Error Weight" in rec]


def _corpus_points(script: str, root: Path, fields, code: tuple) -> list:
    if script in ("golden_sweep", "golden_sweep42"):
        return _named_points(root / NAMED_DIRS[
            FLAGSHIP if script == "golden_sweep" else CODE42][0], fields)
    if script == "ler_sweep":
        spec = ",".join(str(x) for x in code)
        return _named_points(root / f"[{spec}]", fields)
    if script == "golden_deep":
        # the p_0.01-labelled MAX=100 files, W=15 from the headline file
        by_weight = {pt.weight: pt for pt in _named_points(
            root / NAMED_DIRS[FLAGSHIP][0], fields)
            if pt.max_iters == 100 and pt.p == 0.01}
        by_weight[15] = RefPoint(15, 100, 0.01, _counts(
            _read_reference(root / HEADLINE_FILE)[0], fields))
        return [by_weight[w] for w in sorted(by_weight)]
    if script == "golden_dated":
        points = _named_points(root / "archive", fields, "archive", code=True)
        for dirname, max_iters in MAX_SWEEP_DIRS:
            points += _dated_points(root / dirname, fields, "max_sweep",
                                    max_iters)
        return points + _dated_points(root / PRE_DETECTION_DIR, fields,
                                      "pre_detection", None)
    raise ValueError(f"no reference corpus for {script!r}")
