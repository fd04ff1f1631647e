"""Experiment CLI: the init-file-compatible weight-sweep driver (PyTorch).

The port of ``qec_ldpc_tpu/harness/cli.py``, itself the redesign of the
reference's ``main.cu:43-118``: open an append-mode run log, parse the init
file, load (or construct) the code, sweep weights w..W (or p values), run
the Monte-Carlo driver for each point, and append a CodeStatistics record
to ``results/<code>_W_<w>_MAX_<M>_p_<p>.txt`` in the reference's record
format and file naming.  Extensions, as in JAX: seeded runs, a JSONL
journal with chunk-exact resume, a (data, graph) mesh over the ranks of a
``torchrun`` launch, min-sum, layered min-sum, relay and OSD.

Usage:
    python -m qec_ldpc_tpu_torch.harness.cli <init-file> [--<field> value ...]
    python -m qec_ldpc_tpu_torch.harness.cli --code <spec> [options...]
    torchrun --nproc-per-node=N -m qec_ldpc_tpu_torch.harness.cli ...

The run goes to the card unless the config says ``device=cpu`` (``--device
cpu``); ``device=cuda`` without a card raises and never falls back.
"""

from __future__ import annotations

import datetime
import os
import random
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from qec_ldpc_tpu_torch.codes import (
    bicycle_code,
    construct_code,
    hgp_code,
    known_bicycle_code,
    load_code_file,
    toric_code,
)
from qec_ldpc_tpu_torch.codes.construction import build_i_minus_p, gf2_rref
from qec_ldpc_tpu_torch.decoder import CodeGraphs
from qec_ldpc_tpu_torch.decoder.relay import GAMMA_HIGH, GAMMA_LOW
from qec_ldpc_tpu_torch.harness import debug
from qec_ldpc_tpu_torch.harness.config import (
    RunConfig,
    apply_option,
    format_result_filename,
    load_init_file,
)
from qec_ldpc_tpu_torch.harness.journal import Journal
from qec_ldpc_tpu_torch.harness.stats import CodeStatistics
from qec_ldpc_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    GRAPH_AXIS,
    make_mesh,
    maybe_init_distributed,
)
from qec_ldpc_tpu_torch.parallel.montecarlo import (
    effective_steps_per_call,
    run_monte_carlo,
    run_monte_carlo_osd,
)
from qec_ldpc_tpu_torch.sampling.classify import (
    NUM_COUNTERS,
    make_rank_basis_test,
)


def _log(fh, msg: str) -> None:
    """Append and echo a run-log line; no-op on ranks other than 0 (fh is
    None there: one writer, main.cu:45-52)."""
    if fh is None:
        return
    print(msg)
    fh.write(msg + "\n")
    fh.flush()


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _broadcast(values: list[int]) -> list[int]:
    """Rank 0's ``values`` on every rank: one broadcast of an int64 tensor,
    on the CPU under gloo and on this rank's card under nccl."""
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor(values, dtype=torch.int64, device=device)
    dist.broadcast(t, src=0)
    return [int(v) for v in t.cpu()]


def _broadcast_resume(start_chunk: int, init_counters, init_iters: int):
    """Rank 0's journal resume state on every rank.

    Only rank 0 reads and writes the journal, but every rank must run the
    same chunk groups (a mesh chunk is a collective: diverging start chunks
    would deadlock), so the resume cursor is broadcast."""
    has = init_counters is not None
    counters = (np.asarray(init_counters, dtype=np.int64) if has
                else np.zeros(NUM_COUNTERS, dtype=np.int64))
    packed = _broadcast([start_chunk, init_iters, int(has),
                         *(int(c) for c in counters)])
    start_chunk, init_iters, has = packed[0], packed[1], bool(packed[2])
    return (start_chunk,
            np.asarray(packed[3:], dtype=np.int64) if has else None,
            init_iters)


def load_code_and_graphs(spec: str):
    """Resolve a codeFile spec to (code, graphs).  Forms:

    * a path to a reference-format code file (``Quantum_LDPC_Code.h:43-74``);
    * ``qc:J,K,L,P,sigma,tau``: the Hagiwara–Imai construction
      (``QEC_LDPC_CSS.cu:26-131``);
    * ``bb:[[144,12,12]]`` (a published instance) or
      ``bb:l=12,m=6,A=x3+y+y2,B=y3+x+x2``: bivariate bicycle codes
      (codes/bicycle.py) on lifted graphs;
    * ``toric:d``: the [[2d²,2,d]] toric code, or
      ``hgp:n1=7,n2=7,h1=1+x+x3,h2=1+y+y3``: hypergraph products of
      circulant classical codes (codes/hypergraph.py) on lifted graphs.
    """
    def bad_spec(form: str, exc: Exception):
        return ValueError(
            f"malformed code spec {spec!r}: expected {form} ({exc})")

    if spec.startswith("toric:"):
        try:
            code = toric_code(int(spec[len("toric:"):]))
        except (ValueError, TypeError) as e:
            raise bad_spec("toric:<d> with integer distance d >= 2", e) from e
        return code, code.build_graphs()
    if spec.startswith("hgp:"):
        try:
            kv = dict(t.split("=", 1) for t in spec[4:].split(","))
            code = hgp_code(int(kv["n1"]), int(kv["n2"]), kv["h1"], kv["h2"])
        except (KeyError, ValueError, TypeError) as e:
            raise bad_spec(
                "hgp:n1=<int>,n2=<int>,h1=<poly>,h2=<poly> "
                "(e.g. hgp:n1=7,n2=7,h1=1+x+x3,h2=1+y+y3)", e) from e
        return code, code.build_graphs()
    if spec.startswith("bb:"):
        body = spec[3:]
        try:
            if body.startswith("[["):
                code = known_bicycle_code(body)
            else:
                kv = dict(t.split("=", 1) for t in body.split(","))
                code = bicycle_code(int(kv["l"]), int(kv["m"]),
                                    kv["A"], kv["B"])
        except (KeyError, ValueError, TypeError) as e:
            raise bad_spec(
                "bb:[[n,k,d]] (a published instance) or "
                "bb:l=<int>,m=<int>,A=<poly>,B=<poly> "
                "(e.g. bb:l=12,m=6,A=x3+y+y2,B=y3+x+x2)", e) from e
        return code, code.build_graphs()
    if spec.startswith("qc:"):
        try:
            vals = [int(x) for x in spec[3:].replace(",", " ").split()]
            code = construct_code(*vals)
        except (ValueError, TypeError) as e:
            raise bad_spec("qc:J,K,L,P,sigma,tau (six integers)", e) from e
        return code, CodeGraphs.build(code)
    code = load_code_file(spec)
    return code, CodeGraphs.build(code)


def resolve_logical_test_for_code(code, logical_test: str,
                                  device: torch.device | str):
    """The CLI's logical-test operand on ``device``: the rank-basis test
    (the same classification as the dense iMinusP matvec at O(rank * n)
    memory), unless a file-loaded code ships an iMinusP with a DIFFERENT
    kernel than the PCM-derived annihilator, in which case the file's matrix
    wins (a deliberately different shipped matrix is not reinterpreted).
    Equivalence is one GF(2) rank check: the same rowspace is the same
    kernel is the same classification.

    Returns ``(test_operand, note_or_None)``.
    """
    test = make_rank_basis_test(code, device, logical_test)
    shipped = getattr(code, "_i_minus_p", None)
    if shipped is None or logical_test != "reference":
        return test, None
    shipped = np.asarray(shipped) % 2
    ours = build_i_minus_p(code.pcm_x, code.pcm_z)
    r_ship = len(gf2_rref(shipped)[1])
    r_ours = len(gf2_rref(ours)[1])
    r_both = len(gf2_rref(np.concatenate([shipped, ours]))[1])
    if r_ship == r_ours == r_both:
        return test, None
    return torch.as_tensor(shipped, device=device), (
        f"file-shipped iMinusP differs from the PCM-derived annihilator "
        f"(ranks {r_ship}/{r_ours}/joint {r_both}); classifying with the "
        f"FILE's matrix")


def run_sweep(cfg: RunConfig) -> list[CodeStatistics]:
    """Run every point of ``cfg.sweep_points()`` and return their records.

    Under ``torchrun`` every rank runs this with the same config.  The mesh
    is over the ranks (one process per rank, each on its own card or
    sharing one under gloo), not over the cards of one process: data =
    world size / ``num_graph`` when ``use_mesh`` or ``num_graph > 1``.
    Only rank 0 opens the run log, the journal and the result files; the
    counters are summed over the mesh, so every rank returns the same
    records.
    """
    # the device and the process group first: no work may start on a card
    # the rank has not selected, and no run quietly falls back to the CPU
    device_type = torch.device(cfg.device).type
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {cfg.device!r}; expected "
                         f"'cuda' or 'cpu'")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch.cuda.is_available() is false; pass "
            "--device cpu (device=cpu in an init file) to run on the CPU")
    maybe_init_distributed(device_type)
    device = (torch.device("cuda", torch.cuda.current_device())
              if device_type == "cuda" else torch.device("cpu"))
    world = _world()
    # one writer (main.cu:45-52, 100): only rank 0 opens the run log, the
    # journal and the result files
    is_main = _rank() == 0
    log = None
    if is_main:
        os.makedirs(cfg.results_dir, exist_ok=True)
        log = open(cfg.log_file, "a")  # append-mode run log (main.cu:45-52)
        log.write("\n" + datetime.datetime.now().ctime() + "\n")
    try:
        return _run_points(cfg, device, world, is_main, log)
    finally:
        if log is not None:
            log.close()


#: relay's draw rule, a generator per chunk, graph and retry
#: (decoder/relay.py's RelayDraws): a tag the JAX run_id lacks
RELAY_DRAWS_TAG = "|gammas=per-retry"


def _run_id(cfg: RunConfig, code, p: float, seed: int, spc_eff: int,
            weight_cap: int | None, device_type: str) -> str:
    """The journal key of one sweep point: the JAX package's run_id (with
    :data:`RELAY_DRAWS_TAG` after the relay fields), then
    ``|torch=<device type>``.  It pins everything a resumed continuation
    depends on: the chunk grouping (batch_size and the effective
    steps_per_call: start_chunk counts groups), the draw streams and the
    counter semantics; a mismatch starts afresh, never blends.  The port's
    streams differ from JAX's threefry and from each other (mt19937 on the
    CPU, Philox on a card), hence the device type."""
    run_id = (f"{code}|COUNT={cfg.count}|MAX={cfg.max_iterations}"
              f"|p={p:g}|seed={seed}|bs={cfg.batch_size}|spc={spc_eff}")
    if cfg.osd >= 0:
        run_id += f"|osd={cfg.osd}"
    if cfg.relay > 0:
        # the gamma range shapes the retry streams, and so does their draw
        # rule: never resume a journal of the earlier stream (one generator
        # for the X, then the Z retries)
        run_id += (f"|relay={cfg.relay}|g={GAMMA_LOW:g}:{GAMMA_HIGH:g}"
                   + RELAY_DRAWS_TAG)
    if cfg.num_graph > 1:
        # graph-sharded sum-product reassociates (statistically, not
        # bit-equivalent)
        run_id += f"|ng={cfg.num_graph}"
    if weight_cap is not None:
        # the dynamic sampler's stream differs from the static one's
        run_id += f"|wcap={weight_cap}"
    if cfg.logical_test != "reference":
        run_id += f"|lt={cfg.logical_test}"
    return run_id + f"|torch={device_type}"


def _run_points(cfg: RunConfig, device: torch.device, world: int,
                is_main: bool, log) -> list[CodeStatistics]:
    code, graphs = load_code_and_graphs(cfg.code_file)
    i_minus_p, note = resolve_logical_test_for_code(code, cfg.logical_test,
                                                    device)
    if note:
        _log(log, f"  NOTE: {note}")
    bp_cfg = cfg.bp_config()
    seed = cfg.seed if cfg.seed is not None else random.SystemRandom().getrandbits(32)
    if world > 1 and cfg.seed is None:
        # every rank must run the same seed (the generators derive from
        # it): take rank 0's draw
        seed = _broadcast([seed])[0]

    mesh = None
    if cfg.num_graph > 1:
        if world < cfg.num_graph or world % cfg.num_graph:
            raise ValueError(
                f"num_graph={cfg.num_graph} needs a world size that is a "
                f"multiple of it, have {world} rank(s)")
        mesh = make_mesh(num_data=world // cfg.num_graph,
                         num_graph=cfg.num_graph, device_type=device.type)
    elif cfg.use_mesh and world > 1:
        mesh = make_mesh(num_data=world, num_graph=1,
                         device_type=device.type)
    _log(log, f"Initializing run for code {code} on {world} rank(s) "
              f"({device.type}"
              + (f"; mesh data={mesh.size(DATA_AXIS)}"
                 f" x graph={mesh.size(GRAPH_AXIS)}" if mesh is not None
                 else "")
              + f"); seed={seed}")

    journal = (Journal(os.path.join(cfg.results_dir, "journal.jsonl"))
               if is_main else None)

    # multi-weight sweeps draw with the dynamic sampler, as JAX's do (there
    # it shares one compiled program; here it keeps the draw stream, and
    # with it the journal, the JAX package's rule); single points keep the
    # static sampler
    sweep = cfg.sweep_points()
    weights = sorted({w for w, _ in sweep})
    weight_cap = None
    if (len(weights) > 1 and cfg.error_model == "weight"
            and cfg.num_graph == 1 and cfg.osd < 0):
        weight_cap = -(-max(weights) // 8) * 8  # pad to a multiple of 8

    all_stats: list[CodeStatistics] = []
    try:
        with debug.trace(cfg.profile_dir or None) as spans:
            for i, (w, p) in enumerate(sweep):
                # the OSD mode journals per chunk, not per group, so its
                # sequencing does not depend on steps_per_call: keep the
                # configured value there
                spc_eff = cfg.steps_per_call
                if cfg.osd < 0:
                    spc_eff = effective_steps_per_call(
                        cfg.count, cfg.batch_size, cfg.steps_per_call, mesh)
                run_id = _run_id(cfg, code, p, seed, spc_eff, weight_cap,
                                 device.type)
                fname = format_result_filename(str(code), w,
                                               cfg.max_iterations, p)
                out_path = os.path.join(cfg.results_dir, fname)
                _log(log, out_path)

                start_chunk, init_counters, init_iters = (
                    journal.resume_state(run_id, w) if journal is not None
                    else (0, None, 0))
                if world > 1:
                    start_chunk, init_counters, init_iters = _broadcast_resume(
                        start_chunk, init_counters, init_iters)
                if start_chunk:
                    _log(log, f"  resuming W={w} p={p:g} at chunk {start_chunk}")

                def on_chunk(c, num_chunks, counters, iters, _w=w, _rid=run_id):
                    if journal is None:
                        return
                    journal.append({
                        "run_id": _rid, "weight": _w, "chunk": c,
                        "counters": [int(x) for x in counters], "iters": iters,
                    })

                t0 = time.perf_counter()
                if cfg.osd >= 0:
                    # the quality mode: relay (optional) then OSD per chunk,
                    # journaling post-repair counters per chunk
                    counters, bp_iters = run_monte_carlo_osd(
                        graphs, w, cfg.count, p, bp_cfg, seed + i,
                        batch_size=cfg.batch_size, lam=cfg.osd,
                        error_model=cfg.error_model, progress=on_chunk,
                        relay_retries=cfg.relay, i_minus_p=i_minus_p,
                        start_chunk=start_chunk, init_counters=init_counters,
                        device=device, mesh=mesh)
                else:
                    counters, bp_iters = run_monte_carlo(
                        graphs, w, cfg.count, p, bp_cfg, seed + i,
                        batch_size=cfg.batch_size, mesh=mesh,
                        error_model=cfg.error_model,
                        progress=on_chunk, start_chunk=start_chunk,
                        init_counters=init_counters,
                        steps_per_call=cfg.steps_per_call,
                        relay_retries=cfg.relay, i_minus_p=i_minus_p,
                        weight_cap=weight_cap, device=device)
                duration_us = int((time.perf_counter() - t0) * 1e6)

                stats = CodeStatistics.from_counters(
                    code, seed + i, w, counters, duration_us,
                    total_bp_iterations=bp_iters + init_iters,
                    num_devices=world)
                all_stats.append(stats)
                # append-mode per-point results file, rank 0 only (main.cu:100)
                if is_main:
                    with open(out_path, "a") as f:
                        f.write(stats.to_reference_text() + "\n\n")
                _log(log, f"  W={w} p={p:g}: {stats.num_errors_tested} samples, "
                          f"corrected={stats.corrected}, "
                          f"logical={stats.logical_errors}, "
                          f"{stats.samples_per_second:,.0f} samples/s")
        if spans is not None:  # the profile is written: where the time went
            print(spans.report(), file=sys.stderr)
    finally:
        if journal is not None:
            journal.close()

    _log(log, "Run complete.")
    return all_stats


def _parse_flag_tokens(argv: list[str]) -> dict[str, str]:
    """``--key value`` / ``--key=value`` tokens -> {field: raw value},
    mapping the reference init file's positional names to RunConfig fields."""
    alias = {"code": "code_file", "w": "weight_start", "W": "weight_end",
             "count": "count", "max": "max_iterations",
             "p": "error_probability"}
    values: dict[str, str] = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            raise ValueError(f"expected --flag, got {tok!r}")
        key = tok[2:]
        if "=" in key:
            key, val = key.split("=", 1)
        else:
            if i + 1 >= len(argv):
                raise ValueError(f"flag {tok!r} needs a value")
            val = argv[i + 1]
            i += 1
        values[alias.get(key, key)] = val
        i += 1
    return values


def _apply_flag_values(cfg: RunConfig, values: dict[str, str]) -> RunConfig:
    for k, v in values.items():
        try:
            apply_option(cfg, k, v)
        except ValueError as e:
            raise ValueError(f"--{k}: {e}") from e
    return cfg


def _config_from_flags(argv: list[str]) -> RunConfig:
    """Flag form: ``--code <spec> [--w N] [--W N] [--count N] [--max N]
    [--p F] [--<any-RunConfig-field> value]``: the init file's positional
    line as flags, for runs without writing a file."""
    values = _parse_flag_tokens(argv)
    if "code_file" not in values:
        raise ValueError("--code <spec> is required")
    weight_start = int(values.pop("weight_start", 1))
    weight_end = int(values.pop("weight_end", weight_start))
    if weight_end < weight_start:
        raise ValueError(
            f"--W {weight_end} is below --w {weight_start}")
    cfg = RunConfig(
        code_file=values.pop("code_file"),
        weight_start=weight_start,
        weight_end=weight_end,
        count=int(values.pop("count", 10000)),
        max_iterations=int(values.pop("max_iterations", 100)),
        error_probability=float(values.pop("error_probability", 0.01)),
    )
    return _apply_flag_values(cfg, values)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("Usage: python -m qec_ldpc_tpu_torch.harness.cli <init-file> "
              "[--<field> value ...]\n"
              "       python -m qec_ldpc_tpu_torch.harness.cli --code <spec> "
              "[--w N --W N --count N --max N --p F --<field> value ...]",
              file=sys.stderr)
        return 2
    if argv[0].startswith("--"):
        cfg = _config_from_flags(argv)
    else:
        # the init-file form; trailing --flag overrides layer on top, so
        # the reference's literal init.txt runs with local output dirs:
        #   cli QEC_LDPC/init.txt --results_dir out/
        cfg = load_init_file(argv[0])
        overrides = _parse_flag_tokens(argv[1:])
        overrides.pop("code_file", None)  # the init file owns the code spec
        _apply_flag_values(cfg, overrides)
    try:
        run_sweep(cfg)
    except Exception as e:
        # the reference appends failures to the run log before the process
        # exits (main.cu:106-112); rank 0 alone writes it
        if _rank() == 0:
            try:
                with open(cfg.log_file, "a") as f:
                    f.write(f"{datetime.datetime.now().ctime()} ERROR: {e}\n")
            except OSError:
                pass
        raise
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
