"""Rank functions of the port's mesh tests (``test_torch_mesh.py``,
``test_torch_graph_sharded.py``, ``test_torch_mc_graph.py``,
``test_torch_cli_mesh.py``, ``test_torch_graph_osd.py``,
``test_torch_graph_soft.py``, ``test_torch_lifted_sharded.py``).

``qec_ldpc_tpu_torch.parallel.mesh.spawn`` runs each in a fresh process per
rank, which imports this module: it imports neither JAX nor the JAX
package, so a spawned rank never loads them.  Each function runs every case
of its test module in one world and returns NumPy arrays and Python values.
"""

import time

import numpy as np
import torch

from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.codes import known_bicycle_code, toric_code
from qec_ldpc_tpu_torch.decoder import BPConfig, CodeGraphs, LiftedGraph
from qec_ldpc_tpu_torch.harness import Journal, load_init_file
from qec_ldpc_tpu_torch.harness.cli import run_sweep
from qec_ldpc_tpu_torch.parallel.graph_sharded import make_graph_sharded_decoder
from qec_ldpc_tpu_torch.parallel.lifted_sharded import (
    ShardedLiftedGraph,
    make_lifted_sharded_decoder,
)
from qec_ldpc_tpu_torch.parallel.mc_graph import (
    make_graph_sharded_arrays_chunk,
    make_graph_sharded_chunk,
)
from qec_ldpc_tpu_torch.parallel.mesh import DATA_AXIS, GRAPH_AXIS, make_mesh
from qec_ldpc_tpu_torch.parallel.montecarlo import (
    effective_steps_per_call,
    make_sharded_chunk,
    mc_chunk_arrays,
    run_monte_carlo,
    run_monte_carlo_osd,
)
from qec_ldpc_tpu_torch.sampling import make_rank_basis_test


def _shard(mesh, a: np.ndarray) -> torch.Tensor:
    """This rank's data shard of a (rows, batch) array."""
    d, nd = mesh.rank(DATA_AXIS), mesh.size(DATA_AXIS)
    bt = a.shape[1] // nd
    return torch.from_numpy(np.ascontiguousarray(a[:, d * bt:(d + 1) * bt]))


def graph_sharded_cases(mesh, cases: dict, p: float) -> dict:
    """Decode each case ``name -> (code params, BPConfig kwargs, sx, sz)``
    with ``make_graph_sharded_decoder``: the outputs and the collectives it
    issued, or the exception's type and message."""
    torch.set_num_threads(1)
    out = {"rank": (mesh.rank(DATA_AXIS), mesh.rank(GRAPH_AXIS))}
    for name, (params, cfg, sx, sz) in cases.items():
        graphs = CodeGraphs.build(construct_code(*params))
        try:
            decode = make_graph_sharded_decoder(mesh, graphs, BPConfig(**cfg))
        except (ValueError, NotImplementedError) as e:
            out[name] = (type(e).__name__, str(e))
            continue
        before = dict(mesh.collectives)
        dx, dz, code, iters = decode(_shard(mesh, sx), _shard(mesh, sz), p)
        out[name] = dict(dx=dx.numpy(), dz=dz.numpy(), code=code.numpy(),
                         iters=iters.numpy(),
                         collectives={k: mesh.collectives[k] - before[k]
                                      for k in before})
    return out


def mc_graph_cases(mesh, params: tuple, seed: int, p: float) -> dict:
    """Graph-sharded chunk groups of chunks 0 and 1 at 8 lanes per data
    shard for each algorithm, relay, ``run_monte_carlo`` on the mesh, and
    the lifted-code refusals."""
    torch.set_num_threads(1)
    code = construct_code(*params)
    graphs = CodeGraphs.build(code)
    test = make_rank_basis_test(code, "cpu")
    out = {}

    def chunk(algorithm, weight, relay_retries=0):
        fn = make_graph_sharded_chunk(
            mesh, graphs, weight, BPConfig(max_iters=20, algorithm=algorithm),
            8, relay_retries=relay_retries)
        counters, iters = fn(test, seed, p, [0, 1], device="cpu")
        return counters.numpy(), iters.numpy()

    for algorithm in ("min-sum", "layered-min-sum", "sum-product"):
        out[algorithm] = chunk(algorithm, 2)
    out["relay-base"] = chunk("min-sum", 4)
    out["relay"] = chunk("min-sum", 4, relay_retries=4)
    out["relay-again"] = chunk("min-sum", 4, relay_retries=4)
    before = dict(mesh.collectives)
    out["run"] = run_monte_carlo(
        graphs, 2, 4 * 8 * mesh.size(DATA_AXIS), p,
        BPConfig(max_iters=20, algorithm="min-sum"), seed,
        batch_size=8 * mesh.size(DATA_AXIS), mesh=mesh, steps_per_call=2,
        i_minus_p=test, device="cpu")
    out["run-collectives"] = {k: mesh.collectives[k] - before[k]
                              for k in before}
    toric = toric_code(4).build_graphs()
    toric_test = make_rank_basis_test(toric.code, "cpu")
    cfg = BPConfig(max_iters=20, algorithm="min-sum")
    out["lifted-chunk"] = tuple(t.numpy() for t in make_graph_sharded_chunk(
        mesh, toric, 1, cfg, 8)(toric_test, seed, p, [0, 1], device="cpu"))
    out["lifted-run"] = run_monte_carlo(
        toric, 1, 2 * 8 * mesh.size(DATA_AXIS), p, cfg, seed,
        batch_size=8 * mesh.size(DATA_AXIS), mesh=mesh, i_minus_p=toric_test,
        device="cpu")
    return out


def lifted_graphs(spec: str) -> CodeGraphs:
    """``toric:<d>`` or ``bb:<published label>`` -> the code's graphs."""
    family, arg = spec.split(":", 1)
    code = toric_code(int(arg)) if family == "toric" else known_bicycle_code(arg)
    return code.build_graphs()


def _band(a: ShardedLiftedGraph, x: np.ndarray) -> torch.Tensor:
    """This rank's band of a global (blocks*l*m, batch) array."""
    bt = x.shape[-1]
    y = x.reshape(-1, a.l, a.m, bt)[:, a.g * a.lc:(a.g + 1) * a.lc]
    return torch.from_numpy(np.ascontiguousarray(y.reshape(-1, bt)))


def _refusals(mesh) -> dict:
    """What the lane-sharded decoder refuses, and the block-column
    decoder's refusal of a lifted code: name -> (type, message)."""
    bb = lifted_graphs("bb:[[72,12,6]]")
    two_blocks = LiftedGraph.build(2, 2, (2, 2), [
        (0, 0, (0, 0)), (0, 1, (0, 1)), (1, 0, (1, 0)), (1, 1, (1, 1))])
    z_p = LiftedGraph.from_circulant(np.array([[0, 1, 3]]), 7)
    cases = {
        "circulant": (CodeGraphs.build(construct_code(3, 3, 6, 7, 2, 3)), {}),
        "non-product": (CodeGraphs(bb.code, z_p, z_p), {}),
        "divide": (toric_code(3).build_graphs(), {}),
        "check-blocks": (CodeGraphs(bb.code, two_blocks, two_blocks), {}),
        "pallas": (bb, dict(algorithm="min-sum", kernel="pallas")),
        "return_soft": (bb, dict(return_soft=True)),
        "layered": (bb, dict(algorithm="layered-min-sum")),
    }
    out = {}
    for name, (graphs, cfg) in cases.items():
        try:
            make_lifted_sharded_decoder(mesh, graphs, BPConfig(**cfg))
            out[name] = None
        except ValueError as e:
            out[name] = (type(e).__name__, str(e))
    try:
        make_graph_sharded_decoder(mesh, bb, BPConfig())
        out["block-column"] = None
    except ValueError as e:
        out["block-column"] = (type(e).__name__, str(e))
    decode = make_lifted_sharded_decoder(mesh, bb, BPConfig())
    s = torch.zeros((bb.x.num_checks, 4), dtype=torch.int32)
    for name, (sx, sz) in (("shape", (s[:-1], s)), ("batch", (s, s[:, :3]))):
        try:
            decode(sx, sz, 0.01)
            out[name] = None
        except ValueError as e:
            out[name] = (type(e).__name__, str(e))
    return out


def lifted_sharded_cases(mesh, routes: dict, decodes: dict, p: float,
                         chunks: dict, seed: int, cli_file: str | None) -> dict:
    """The lane-sharded lifted engine on this (data x graph) mesh:

    * ``routes``: (code spec, "x" or "z") -> (edge rows, variable rows,
      error bits), global arrays; the adapter's ``to_var``, ``to_check``
      (both of the edge rows), ``expand_vars`` and ``syndrome`` of this
      rank's band;
    * ``decodes``: name -> (code spec, BPConfig kwargs, sx, sz), global
      syndromes of every data shard; ``make_lifted_sharded_decoder`` on
      this rank's shard, with the collectives it issued;
    * the refusals;
    * ``chunks``: name -> (code spec, BPConfig kwargs, weight, error model,
      p, lanes per data shard, relay retries); chunks 0 and 1 of
      ``make_graph_sharded_chunk``;
    * ``cli_file``: the CLI's records of that init file (None: no CLI
      run)."""
    torch.set_num_threads(1)
    out = {"rank": (mesh.rank(DATA_AXIS), mesh.rank(GRAPH_AXIS))}
    for (spec, side), (edges, variables, errors) in routes.items():
        a = ShardedLiftedGraph(getattr(lifted_graphs(spec), side), mesh)
        out[("route", spec, side)] = {
            name: fn(_band(a, x)).numpy() for name, fn, x in (
                ("to_var", a.to_var, edges), ("to_check", a.to_check, edges),
                ("expand_vars", a.expand_vars, variables),
                ("syndrome", a.syndrome, errors))}
    for name, (spec, cfg, sx, sz) in decodes.items():
        decode = make_lifted_sharded_decoder(mesh, lifted_graphs(spec),
                                             BPConfig(**cfg))
        before = dict(mesh.collectives)
        dx, dz, code, iters = decode(_shard(mesh, sx), _shard(mesh, sz), p)
        out[name] = dict(dx=dx.numpy(), dz=dz.numpy(), code=code.numpy(),
                         iters=iters.numpy(),
                         collectives={k: mesh.collectives[k] - before[k]
                                      for k in before})
    out["refusals"] = _refusals(mesh)
    for name, (spec, cfg, weight, model, p_err, bpd, relay) in chunks.items():
        graphs = lifted_graphs(spec)
        fn = make_graph_sharded_chunk(mesh, graphs, weight, BPConfig(**cfg),
                                      bpd, model, relay)
        counters, iters = fn(make_rank_basis_test(graphs.code, "cpu"), seed,
                             p_err, [0, 1], device="cpu")
        out[("chunk", name)] = (counters.numpy(), iters.numpy())
    if cli_file is not None:
        out["cli"] = [s.to_dict() for s in run_sweep(load_init_file(cli_file))]
    return out


def mesh_cases(mesh, params: tuple, seed: int, p: float, spc_cases) -> dict:
    """The mesh's shape and its refusals, ``effective_steps_per_call`` on
    it, and data-parallel runs with the collectives they issued."""
    torch.set_num_threads(1)
    code = construct_code(*params)
    graphs = CodeGraphs.build(code)
    test = make_rank_basis_test(code, "cpu")
    nd = mesh.size(DATA_AXIS)
    out = dict(shape=dict(mesh.shape), backend=mesh.backend,
               device=str(mesh.device),
               rank=(mesh.rank(DATA_AXIS), mesh.rank(GRAPH_AXIS)),
               spc=[effective_steps_per_call(*case, mesh=mesh)
                    for case in spc_cases])
    for label, shape in (("too-many", (nd + 1, 1)), ("graph", (nd, 2))):
        try:
            make_mesh(*shape, device_type="cpu")
            out[f"error-{label}"] = None
        except ValueError as e:
            out[f"error-{label}"] = str(e)
    for name, cfg, relay in (
            ("sum-product", BPConfig(max_iters=100), 0),
            ("min-sum", BPConfig(max_iters=100, algorithm="min-sum"), 0),
            ("relay", BPConfig(max_iters=100, algorithm="min-sum"), 4)):
        before = dict(mesh.collectives)
        groups = []
        counters, iters = run_monte_carlo(
            graphs, 3, 6 * 32 * nd, p, cfg, seed, batch_size=32 * nd,
            mesh=mesh, steps_per_call=2, relay_retries=relay, i_minus_p=test,
            progress=lambda g, ng, c, it: groups.append(g), device="cpu")
        out[name] = dict(counters=counters, iters=iters, groups=groups,
                         collectives={k: mesh.collectives[k] - before[k]
                                      for k in before})
    fn = make_sharded_chunk(mesh, graphs, 3, BPConfig(max_iters=100), 32)
    counters, iters = fn(test, seed, p, [4, 5], device="cpu")
    out["chunk"] = (counters.numpy(), iters.numpy())
    return out


def arrays_of(chunk: tuple) -> dict:
    """A chunk's (xe, ze, sx, sz, DecodeResult) as NumPy arrays by name."""
    xe, ze, sx, sz, res = chunk
    out = dict(xe=xe, ze=ze, sx=sx, sz=sz, dx=res.decisions_x,
               dz=res.decisions_z, code=res.error_code, soft_x=res.soft_x,
               soft_z=res.soft_z)
    return {k: None if v is None else v.numpy() for k, v in out.items()}


def cli_cases(mesh, init_files: dict, osd_runs: list) -> dict:
    """The CLI on every rank of the world: each init file of
    ``init_files`` (name -> path; the ranks share its results directory)
    is run twice, the second run resuming from rank 0's journal; then
    ``run_monte_carlo_osd`` directly on the data mesh for each (algorithm,
    weight, count, batch, lam, relay retries) of ``osd_runs`` and on a
    (data=1 x graph=2) mesh, ``mc_chunk_arrays`` on the data mesh without
    and with relay, and the quality mode without a mesh, which must
    refuse."""
    torch.set_num_threads(1)
    out = {}
    for name, path in init_files.items():
        cfg = load_init_file(path)
        runs = [[s.to_dict() for s in run_sweep(cfg)] for _ in range(2)]
        out[name] = dict(runs=runs, run_ids=sorted(
            {r["run_id"] for r in Journal(
                f"{cfg.results_dir}/journal.jsonl").records()}))
    graphs = CodeGraphs.build(construct_code(3, 3, 6, 7, 2, 3))
    out["osd_direct"] = [run_monte_carlo_osd(
        graphs, w, count, 0.02, BPConfig(max_iters=15, algorithm=alg),
        seed=7, batch_size=batch, lam=lam, relay_retries=relay, mesh=mesh,
        device="cpu")[0]
        for alg, w, count, batch, lam, relay in osd_runs]
    out["arrays"] = [arrays_of(mc_chunk_arrays(
        graphs, 7, 2, 5, 0.02, BPConfig(max_iters=15, algorithm="min-sum",
                                        return_soft=True),
        64, relay_retries=relay, device="cpu", mesh=mesh))
        for relay in (0, 4)]
    try:
        run_monte_carlo_osd(graphs, 4, 64, 0.02,
                            BPConfig(max_iters=15, algorithm="min-sum"),
                            seed=7, batch_size=32, device="cpu")
        out["osd_no_mesh"] = None
    except ValueError as e:
        out["osd_no_mesh"] = str(e)
    out["graph_osd_direct"] = run_monte_carlo_osd(
        graphs, 4, 64, 0.02, BPConfig(max_iters=15, algorithm="min-sum"),
        seed=7, batch_size=32, mesh=make_mesh(1, 2, device_type="cpu"),
        device="cpu")[0]
    return out


def graph_osd_cases(mesh, params: tuple, seed: int, p: float,
                    runs: list) -> dict:
    """The quality mode on this (data x graph) mesh for each (algorithm,
    weight, count, batch, lam, relay retries) of ``runs``, a relay run
    twice; and ``make_graph_sharded_arrays_chunk`` for each algorithm, with
    soft outputs."""
    torch.set_num_threads(1)
    graphs = CodeGraphs.build(construct_code(*params))
    out = {"rank": (mesh.rank(DATA_AXIS), mesh.rank(GRAPH_AXIS))}
    for i, (alg, w, count, batch, lam, relay) in enumerate(runs):
        out[i] = [run_monte_carlo_osd(
            graphs, w, count, p, BPConfig(max_iters=15, algorithm=alg),
            seed=seed, batch_size=batch, lam=lam, relay_retries=relay,
            mesh=mesh, device="cpu")[0] for _ in range(2 if relay else 1)]
    out["arrays"] = {alg: arrays_of(make_graph_sharded_arrays_chunk(
        mesh, graphs, 5, BPConfig(max_iters=15, algorithm=alg), 64)(
            seed, 1, p, device="cpu"))
        for alg in ("min-sum", "layered-min-sum", "sum-product")}
    return out


def rank_index(mesh) -> int:
    """This rank's index along ``data``."""
    return mesh.rank(DATA_AXIS)


def failing_rank(mesh) -> None:
    """Rank 1 raises while rank 0 waits for it in a collective."""
    if mesh.rank(DATA_AXIS) == 1:
        raise RuntimeError("planted failure on rank 1")
    mesh.all_reduce(torch.ones(1), "sum", DATA_AXIS)


def sleeping_rank(mesh) -> None:
    """Outlives any short timeout."""
    time.sleep(120)


def recorded_run(mesh, params: tuple, seed: int, p: float, count: int,
                 batch: int):
    """A data-parallel min-sum run with its spans recorded: its (counters,
    iters) and the recording's counters."""
    from qec_ldpc_tpu_torch import tracing

    torch.set_num_threads(1)
    code = construct_code(*params)
    with tracing.recording() as rec:
        out = run_monte_carlo(
            CodeGraphs.build(code), 3, count, p,
            BPConfig(max_iters=20, algorithm="min-sum"), seed,
            batch_size=batch, mesh=mesh, steps_per_call=2,
            i_minus_p=make_rank_basis_test(code, "cpu"), device="cpu")
    return out, dict(rec.counters)
