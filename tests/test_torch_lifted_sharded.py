"""The port's lane-sharded lifted engine (parallel/lifted_sharded.py and the
lifted branch of mc_graph.make_graph_sharded_chunk) on gloo worlds of CPU
ranks (``torch_mesh_workers.lifted_sharded_cases``), each started once for
the module: (data=2 x graph=2) on the toric code d=4 (l = 4, lc = 2) and
the bivariate bicycle code [[72,12,6]] (l = 6, lc = 3: shifts cross band
edges with a remainder), and (data=1 x graph=3) on [[72,12,6]] (lc = 2),
its routes and decodes.  Against the pins of the JAX package's
``test_lifted_sharded.py`` and ``test_mc_graph.py``:

  * the adapter's ``to_var``, ``to_check``, ``expand_vars`` and
    ``syndrome`` equal the global ``LiftedGraph``'s on the rank's band;
  * min-sum and sum-product decisions, error codes and iteration counts
    equal the port's single-device decode of the data shard, and the
    decisions and error codes JAX's ``make_lifted_sharded_decoder`` on a
    JAX CPU mesh of the same shape, bit for bit;
  * weight-one errors are all corrected; the collectives per iteration are
    pinned; the refusals raise ``ValueError``;
  * ``make_graph_sharded_chunk`` equals the data-only mesh's counters for
    min-sum and sum-product; relay is deterministic and repairs; the CLI
    with ``num_graph=2`` equals the data-only run.

Spawned ranks import no JAX; the JAX comparisons run in this process.
"""

import concurrent.futures

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qec_ldpc_tpu.codes import known_bicycle_code as jax_known_bicycle_code
from qec_ldpc_tpu.codes import toric_code as jax_toric_code
from qec_ldpc_tpu.decoder import BPConfig as JaxBPConfig
from qec_ldpc_tpu.parallel import make_mesh as jax_make_mesh
from qec_ldpc_tpu.parallel.lifted_sharded import (
    make_lifted_sharded_decoder as jax_make_lifted_sharded_decoder,
)
from qec_ldpc_tpu_torch.decoder import BPConfig, decode_batch
from qec_ldpc_tpu_torch.kernels import bp_cuda, min_sum_cuda
from qec_ldpc_tpu_torch.parallel.chunk import chunk_generator
from qec_ldpc_tpu_torch.parallel.lifted_sharded import ShardedLiftedGraph
from qec_ldpc_tpu_torch.parallel.mesh import spawn
from qec_ldpc_tpu_torch.parallel.montecarlo import _chunk_body
from qec_ldpc_tpu_torch.sampling import (
    C_CORRECTED,
    C_LOGICAL,
    C_SYN_X,
    C_SYN_Z,
    C_TESTED,
    classify_batch_np,
    make_rank_basis_test,
)

from tests import torch_mesh_workers
from tests.torch_mesh_workers import lifted_graphs

torch.set_num_threads(1)

SPECS = ("toric:4", "bb:[[72,12,6]]")
ALGORITHMS = ("min-sum", "sum-product")
ND, NG = 2, 2     # the world every case runs in
# the worlds, and the codes of their route and decode cases
WORLDS = {(ND, NG): SPECS, (1, 3): ("bb:[[72,12,6]]",)}
BT = 8            # lanes per data shard of the decoder cases
P_ERR = 0.02      # a prior whose float32 LLR the port and JAX agree on
MAX_ITERS = 20
SEED = 3
# (code spec, BPConfig kwargs, weight, error model, p, lanes a data shard,
# relay retries); the relay cases at JAX's test_mc_graph.py:179-200
RELAY_CFG = dict(max_iters=30, algorithm="min-sum")
CHUNKS = {
    **{(spec, alg): (spec, dict(max_iters=MAX_ITERS, algorithm=alg), 2,
                     "weight", P_ERR, 8, 0)
       for spec in SPECS for alg in ALGORITHMS},
    "relay-base": ("bb:[[72,12,6]]", RELAY_CFG, 0, "depolarizing", 0.05, 32, 0),
    "relay": ("bb:[[72,12,6]]", RELAY_CFG, 0, "depolarizing", 0.05, 32, 8),
    "relay-again": ("bb:[[72,12,6]]", RELAY_CFG, 0, "depolarizing", 0.05, 32,
                    8),
}
CLI_LINE = ("bb:[[72,12,6]] 2 2 64 20 0.02 seed=5 batch_size=32 "
            "algorithm=min-sum num_graph=2 device=cpu")
REFUSALS = {"circulant": "LiftedGraph", "non-product": "product group",
            "divide": "must divide", "check-blocks": "one check block",
            "pallas": "pallas", "return_soft": "return_soft",
            "layered": "layered-min-sum", "shape": "GLOBAL check order",
            "batch": "batch sizes differ",
            "block-column": "make_lifted_sharded_decoder"}


def jax_graphs(spec):
    family, arg = spec.split(":", 1)
    code = (jax_toric_code(int(arg)) if family == "toric"
            else jax_known_bicycle_code(arg))
    return code.build_graphs()


def syndromes(graphs, batch, seed, p=0.03):
    """Depolarizing errors (NumPy) -> int32 syndromes of the port's graphs."""
    rng = np.random.default_rng(seed)
    n = graphs.code.n
    err = rng.random((n, batch)) < p
    typ = rng.integers(0, 3, (n, batch))
    xe = (err & (typ != 2)).astype(np.int32)
    ze = (err & (typ != 0)).astype(np.int32)
    return (graphs.x.syndrome(torch.from_numpy(xe)).numpy(),
            graphs.z.syndrome(torch.from_numpy(ze)).numpy())


def weight_one(graphs):
    """JAX's full-mesh case: weight-one X errors, one per lane (2x2)."""
    n, batch = graphs.code.n, ND * BT
    xe = np.zeros((n, batch), np.int32)
    for b in range(batch):
        xe[(3 * b) % n, b] = 1
    sx = graphs.x.syndrome(torch.from_numpy(xe)).numpy()
    return xe, sx, np.zeros((graphs.z.num_checks, batch), np.int32)


def route_inputs(specs):
    """(spec, side) -> (edge rows, variable rows, error bits), global."""
    rng = np.random.default_rng(11)
    out = {}
    for spec in specs:
        graphs = lifted_graphs(spec)
        for side in ("x", "z"):
            g = getattr(graphs, side)
            out[(spec, side)] = (
                rng.normal(size=(g.num_edges, 5)).astype(np.float32),
                rng.normal(size=(g.num_vars, 5)).astype(np.float32),
                rng.integers(0, 2, (g.num_vars, 5)).astype(np.int32))
    return out


def decode_cases(nd, specs):
    cases = {}
    for i, spec in enumerate(SPECS):
        if spec not in specs:
            continue
        sx, sz = syndromes(lifted_graphs(spec), nd * BT, SEED + i)
        for alg in ALGORITHMS:
            cases[(spec, alg)] = (spec, dict(max_iters=MAX_ITERS,
                                             algorithm=alg), sx, sz)
    if nd == ND:
        _, sx, sz = weight_one(lifted_graphs("toric:4"))
        cases["weight-one"] = ("toric:4", dict(max_iters=50,
                                               algorithm="min-sum"), sx, sz)
    return cases


def jax_decodes(cases, nd, ng):
    """JAX's lane-sharded decoder on a CPU mesh of the same shape, on the
    same syndromes."""
    import jax

    mesh = jax_make_mesh(num_data=nd, num_graph=ng,
                         devices=jax.devices()[:nd * ng])
    out = {}
    for name, (spec, cfg, sx, sz) in cases.items():
        decode = jax_make_lifted_sharded_decoder(mesh, jax_graphs(spec),
                                                 JaxBPConfig(**cfg))
        out[name] = tuple(np.asarray(a) for a in decode(
            jnp.asarray(sx), jnp.asarray(sz), P_ERR))
    return out


def start_world(shape, tmp_path_factory):
    """Every case of one world: the ranks' results, JAX's and the inputs.
    The 2x2 world also runs the chunks and the CLI."""
    nd, ng = shape
    specs = WORLDS[shape]
    full = shape == (ND, NG)
    init = None
    if full:
        tmp = tmp_path_factory.mktemp("lifted-cli")
        init = tmp / "init.txt"
        init.write_text(f"{CLI_LINE} results_dir={tmp}/r "
                        f"log_file={tmp}/log.txt\n")
    routes, cases = route_inputs(specs), decode_cases(nd, specs)
    # the ranks run while JAX decodes here
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(spawn, torch_mesh_workers.lifted_sharded_cases, nd,
                           ng, device_type="cpu",
                           args=(routes, cases, P_ERR, CHUNKS if full else {},
                                 SEED, None if init is None else str(init)),
                           timeout=300)
        jax_out = jax_decodes(cases, nd, ng)
        return dict(ranks=port.result(), jax=jax_out, routes=routes,
                    cases=cases, ng=ng)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """``worlds(shape)``: that world, started once per module."""
    started = {}

    def get(shape):
        if shape not in started:
            started[shape] = start_world(shape, tmp_path_factory)
        return started[shape]

    return get


@pytest.fixture(scope="module")
def world(worlds):
    return worlds((ND, NG))


def shard(a, d):
    return a[..., d * BT:(d + 1) * BT]


# every (world, code) pair of the route and decode cases
WORLD_SPECS = [(shape, spec) for shape, specs in WORLDS.items()
               for spec in specs]


def world_id(v):
    return f"{v[0]}x{v[1]}" if isinstance(v, tuple) else v


@pytest.mark.parametrize("side", ["x", "z"])
@pytest.mark.parametrize("shape,spec", WORLD_SPECS, ids=world_id)
def test_adapter_routes_equal_the_global_graph_on_the_band(worlds, shape,
                                                           spec, side):
    world = worlds(shape)
    g = getattr(lifted_graphs(spec), side)
    edges, variables, errors = world["routes"][(spec, side)]
    l, m = g.group
    lc = l // world["ng"]
    want = {"to_var": g.to_var(torch.from_numpy(edges)),
            "to_check": g.to_check(torch.from_numpy(edges)),
            "expand_vars": g.expand_vars(torch.from_numpy(variables)),
            "syndrome": g.syndrome(torch.from_numpy(errors))}
    for r in world["ranks"]:
        gi = r["rank"][1]
        got = r[("route", spec, side)]
        for name, w in want.items():
            band = w.numpy().reshape(-1, l, m, 5)[:, gi * lc:(gi + 1) * lc]
            np.testing.assert_array_equal(got[name], band.reshape(-1, 5),
                                          err_msg=name)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("shape,spec", WORLD_SPECS, ids=world_id)
def test_decode_equals_the_single_device_decode(worlds, shape, spec,
                                                algorithm):
    world = worlds(shape)
    _, cfg, sx, sz = world["cases"][(spec, algorithm)]
    graphs = lifted_graphs(spec)
    for r in world["ranks"]:
        d = r["rank"][0]
        res = decode_batch(graphs, torch.from_numpy(shard(sx, d)),
                           torch.from_numpy(shard(sz, d)), P_ERR,
                           BPConfig(**cfg))
        got = r[(spec, algorithm)]
        np.testing.assert_array_equal(got["dx"], res.decisions_x.numpy())
        np.testing.assert_array_equal(got["dz"], res.decisions_z.numpy())
        np.testing.assert_array_equal(got["code"], res.error_code.numpy())
        assert got["iters"].tolist() == [int(res.iters_x), int(res.iters_z)]


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("shape,spec", WORLD_SPECS, ids=world_id)
def test_decode_equals_jax_lane_sharded_decoder(worlds, shape, spec,
                                                algorithm):
    world = worlds(shape)
    dx, dz, code, _ = world["jax"][(spec, algorithm)]
    for r in world["ranks"]:
        d = r["rank"][0]
        got = r[(spec, algorithm)]
        np.testing.assert_array_equal(got["dx"], shard(dx, d))
        np.testing.assert_array_equal(got["dz"], shard(dz, d))
        np.testing.assert_array_equal(got["code"], shard(code, d))


def test_weight_one_errors_are_corrected(world):
    graphs = lifted_graphs("toric:4")
    xe, _, _ = weight_one(graphs)
    test = make_rank_basis_test(graphs.code, "cpu")
    for r in world["ranks"]:
        d = r["rank"][0]
        got = r["weight-one"]
        assert not got["code"].any()
        c = classify_batch_np(test, shard(xe, d), np.zeros_like(shard(xe, d)),
                              got["dx"], got["dz"], got["code"])
        assert c[C_CORRECTED] == c[C_TESTED] == BT and c[C_LOGICAL] == 0
    np.testing.assert_array_equal(world["jax"]["weight-one"][2], 0)


def checks(n, every=10):
    """Convergence tests in n iterations: k < n with k % every == 0."""
    return sum(1 for k in range(n) if k % every == 0)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("shape,spec", WORLD_SPECS, ids=world_id)
def test_collectives_per_iteration(worlds, shape, spec, algorithm):
    """Two all_gathers per iteration (to_var, to_check) and one all_reduce
    per convergence check; per graph two all_gathers (the decisions'
    to_var, the re-encode) and two all_reduces (the two flags), and the
    decisions' gather."""
    for r in worlds(shape)["ranks"]:
        got = r[(spec, algorithm)]
        itx, itz = (int(i) for i in got["iters"])
        n = got["collectives"]
        assert n["all_gather"] == 2 * (itx + itz) + 2 * 3
        assert n["all_reduce"] == checks(itx) + checks(itz) + 2 * 2


@pytest.mark.parametrize("shape", list(WORLDS), ids=world_id)
def test_graph_group_runs_in_lockstep(worlds, shape):
    world = worlds(shape)
    for name in world["cases"]:
        by_data = {}
        for r in world["ranks"]:
            by_data.setdefault(r["rank"][0], []).append(
                (r[name]["iters"].tolist(), r[name]["dx"].tolist()))
        for runs in by_data.values():
            assert all(run == runs[0] for run in runs)


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals(world, name):
    """On the 2x2 world: the toric code d=3 has l = 3, which G = 2 does
    not divide."""
    for r in world["ranks"]:
        kind, message = r["refusals"][name]
        assert kind == "ValueError" and REFUSALS[name] in message, message


def data_only(spec, cfg, weight, model, p, bpd, seed=SEED, chunks=(0, 1)):
    """The data-only mesh's (counters, iters[2]) for these chunks,
    recomputed shard by shard in one process."""
    graphs = lifted_graphs(spec)
    test = make_rank_basis_test(graphs.code, "cpu")
    counters, iters = np.zeros(9, np.int64), np.zeros(2, np.int64)
    for c in chunks:
        for d in range(ND):
            cnt, its = _chunk_body(graphs, test,
                                   chunk_generator(seed, c, "cpu", d), weight,
                                   p, BPConfig(**cfg), bpd, model)
            counters += cnt.numpy()
            iters += its.numpy()
    return counters, iters


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("spec", SPECS)
def test_chunk_equals_the_data_only_mesh(world, spec, algorithm):
    spec_, cfg, weight, model, p, bpd, _ = CHUNKS[(spec, algorithm)]
    counters, iters = data_only(spec_, cfg, weight, model, p, bpd)
    assert counters[C_TESTED] == 2 * ND * bpd
    for r in world["ranks"]:
        got, got_iters = r[("chunk", (spec, algorithm))]
        np.testing.assert_array_equal(got, counters)
        np.testing.assert_array_equal(got_iters, iters)


def test_relay_on_the_lifted_graph_mesh(world):
    """Deterministic, the tested population unchanged, syndrome failures
    strictly fewer, corrected-or-logical no fewer (JAX's pins)."""
    for r in world["ranks"]:
        base, base_it = r[("chunk", "relay-base")]
        relayed, relay_it = r[("chunk", "relay")]
        np.testing.assert_array_equal(relayed, r[("chunk", "relay-again")][0])
        assert relayed[C_TESTED] == base[C_TESTED]
        assert base[C_SYN_X] + base[C_SYN_Z] > 0, "nothing to repair"
        assert (relayed[C_SYN_X] + relayed[C_SYN_Z]
                < base[C_SYN_X] + base[C_SYN_Z]), "relay repaired none"
        assert (relayed[C_CORRECTED] + relayed[C_LOGICAL]
                >= base[C_CORRECTED] + base[C_LOGICAL])
        assert relay_it.sum() > base_it.sum()
    # the relay base is the data-only mesh's run
    base = data_only(*CHUNKS["relay-base"][:6])[0]
    np.testing.assert_array_equal(world["ranks"][0][("chunk", "relay-base")][0],
                                  base)


def test_cli_num_graph_equals_the_data_only_run(world):
    """``bb:[[72,12,6]]`` with ``num_graph=2`` on the 2x2 world: 2 chunks of
    32 lanes, 16 a data shard, the counters of the data-only mesh."""
    counters, _ = data_only("bb:[[72,12,6]]",
                            dict(max_iters=20, algorithm="min-sum"), 2,
                            "weight", 0.02, 16, seed=5)
    for r in world["ranks"]:
        (rec,) = r["cli"]
        got = [rec[k] for k in ("num_errors_tested", "num_x_errors_tested",
                                "num_z_errors_tested", "corrected",
                                "syndrome_errors_x", "syndrome_errors_z",
                                "logical_errors", "convergence_fail_x",
                                "convergence_fail_z")]
        assert got == counters.tolist()


class _Rank0Of2:
    """A graph group's shape without a process group: enough to build an
    adapter, which issues no collective until it routes."""

    def size(self, axis):
        return 2

    def rank(self, axis):
        return 0


@pytest.mark.parametrize("run", [min_sum_cuda.min_sum_run, bp_cuda.bp_run],
                         ids=["min_sum_run", "bp_run"])
def test_kernel_wrappers_refuse_the_adapter(run):
    """The lane-sharded engine runs the plain loops: the kernel wrappers
    (K5 and K6's dispatch) take a LiftedGraph, never the adapter."""
    adapter = ShardedLiftedGraph(lifted_graphs("bb:[[72,12,6]]").x,
                                 _Rank0Of2())
    s = torch.zeros((adapter.num_checks, 4), dtype=torch.int32)
    with pytest.raises(TypeError, match="ShardedLiftedGraph"):
        run(adapter, s, 0.01, 5)
