"""The port's graph-sharded decoders (parallel/graph_sharded.py) against the
JAX package's on its 8-virtual-device CPU mesh, bit for bit.

Gloo worlds of (data x graph) = 1x2, 2x2 and 1x3 CPU ranks decode the same
NumPy syndromes (``torch_mesh_workers.graph_sharded_cases``); each rank's
decisions, error codes and iteration counts must equal JAX's for its data
shard:

  * min-sum against JAX's ``kernel="xla"`` engine in every world and its
    ``kernel="pallas"`` engine (K8 in interpret mode) in the 2x2 world, and
    against the port's single-device ``decode_batch``;
  * layered min-sum against JAX's engine and the single-device decode;
  * sum-product against JAX's engine: bit for bit, since the port takes the
    cross-shard product in JAX's order and forms the variable-node
    denominator with the one fused multiply-add XLA makes on the CPU.

Also the [[610,61]] code at G=2, JAX's refusals, and the collectives per
iteration (the counterpart of JAX's ``test_hlo_collectives.py``).
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qec_ldpc_tpu.codes import construct_code as jax_construct_code
from qec_ldpc_tpu.decoder import BPConfig as JaxBPConfig
from qec_ldpc_tpu.decoder import CodeGraphs as JaxCodeGraphs
from qec_ldpc_tpu.parallel import make_mesh as jax_make_mesh
from qec_ldpc_tpu.parallel.graph_sharded import (
    make_graph_sharded_decoder as jax_make_graph_sharded_decoder,
)
from qec_ldpc_tpu_torch.convert import graphs_from_jax
from qec_ldpc_tpu_torch.decoder import BPConfig, decode_batch
from qec_ldpc_tpu_torch.parallel.mesh import spawn

from tests import torch_mesh_workers

CODES = {"42": (3, 3, 6, 7, 2, 3), "610": (4, 5, 10, 61, 9, 49)}
ALGORITHMS = ("min-sum", "layered-min-sum", "sum-product")
WORLDS = [(1, 2), (2, 2), (1, 3)]
P_ERR = 0.02
MAX_ITERS = {"42": 15, "610": 30}
# the refusals of JAX's test_graph_sharded.py:79-83, :155-160, :208-215
ERRORS = {
    "divide": ("610", dict(max_iters=10), "ValueError", "must divide"),
    "algorithm": ("42", dict(algorithm="bogus"), "ValueError",
                  "unknown algorithm"),
    "pallas-sum-product": ("42", dict(algorithm="sum-product",
                                      kernel="pallas"),
                           "ValueError", "between-halos"),
    "pallas-layered": ("42", dict(algorithm="layered-min-sum",
                                  kernel="pallas"),
                       "ValueError", "between-halos"),
}

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


def syndromes(jg, batch, seed, weight=3):
    """Weight-``weight`` X and Z errors per lane (NumPy) -> int32 syndromes,
    formed by the JAX graphs."""
    rng = np.random.default_rng(seed)
    n = jg.code.n
    out = []
    for graph in (jg.x, jg.z):
        e = np.zeros((n, batch), np.int32)
        for b in range(batch):
            e[rng.choice(n, weight, replace=False), b] = 1
        out.append(np.array(jax.jit(graph.syndrome)(jnp.asarray(e)),
                            dtype=np.int32))
    return out


def codes_of(num_graph):
    """The codes a world decodes: [[610,61]] only where G divides L=10."""
    return [c for c in CODES if (c == "42" or 10 % num_graph == 0)]


def start_world(nd, ng):
    """Every case of one world: the port's per-rank results, JAX's outputs
    and the syndromes."""
    jgs = {c: JaxCodeGraphs.build(jax_construct_code(*CODES[c])) for c in CODES}
    syn = {c: syndromes(jgs[c], 8 * nd, 7 + nd + 10 * ng) for c in CODES}
    cases = {}
    for c in codes_of(ng):
        for algorithm in ALGORITHMS:
            cfg = dict(max_iters=MAX_ITERS[c], algorithm=algorithm)
            cases[(c, algorithm)] = (CODES[c], cfg, *syn[c])
    if ng == 3:
        for name, (c, cfg, _, _) in ERRORS.items():
            cases[name] = (CODES[c], cfg, *syn[c])
    # the ranks run while JAX decodes here
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(spawn, torch_mesh_workers.graph_sharded_cases, nd,
                           ng, device_type="cpu", args=(cases, P_ERR),
                           timeout=300)
        jax_out = jax_cases(jgs, cases, nd, ng)
        return dict(nd=nd, ng=ng, port=port.result(), jax=jax_out, jgs=jgs,
                    syn=syn)


@pytest.fixture(scope="module")
def worlds():
    """``worlds((nd, ng))``: that world, started once per module."""
    started = {}

    def get(shape):
        if shape not in started:
            started[shape] = start_world(*shape)
        return started[shape]

    return get


def world_id(shape):
    return f"{shape[0]}x{shape[1]}"


def jax_cases(jgs, cases, nd, ng):
    """JAX's engines on the same mesh shape and syndromes."""
    mesh = jax_make_mesh(num_data=nd, num_graph=ng,
                         devices=jax.devices()[:nd * ng])
    jax_out = {}
    for (c, algorithm), (_, cfg, sx, sz) in (
            (k, v) for k, v in cases.items() if isinstance(k, tuple)):
        kernels = ("xla", "pallas") if (algorithm == "min-sum" and c == "42"
                                        and (nd, ng) == (2, 2)) else ("xla",)
        for kernel in kernels:
            decode = jax_make_graph_sharded_decoder(
                mesh, jgs[c], JaxBPConfig(**cfg, kernel=kernel))
            jax_out[(c, algorithm, kernel)] = tuple(
                np.asarray(a) for a in decode(jnp.asarray(sx), jnp.asarray(sz),
                                              P_ERR))
    return jax_out


def each_rank(world, c, algorithm):
    """(data index, the rank's case) for every rank."""
    for r in world["port"]:
        yield r["rank"][0], r[(c, algorithm)]


def check_against(world, c, algorithm, want):
    """Every rank's outputs equal ``want`` = (dx, dz, code, iters) on its
    data shard (iters: JAX's (num_data, 2) rows)."""
    bt = 8
    for d, got in each_rank(world, c, algorithm):
        cols = slice(d * bt, (d + 1) * bt)
        np.testing.assert_array_equal(got["dx"], want[0][:, cols])
        np.testing.assert_array_equal(got["dz"], want[1][:, cols])
        np.testing.assert_array_equal(got["code"], want[2][cols])
        if want[3] is not None:
            np.testing.assert_array_equal(got["iters"], want[3][d])


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("shape,code",
                         [(w, c) for w in WORLDS for c in codes_of(w[1])],
                         ids=lambda v: world_id(v) if isinstance(v, tuple) else v)
def test_bit_exact_vs_jax_engine(worlds, shape, code, algorithm):
    world = worlds(shape)
    check_against(world, code, algorithm, world["jax"][(code, algorithm, "xla")])


def test_min_sum_bit_exact_vs_jax_pallas_engine(worlds):
    """JAX's interpret-mode K8 engine runs in the 2x2 world."""
    world = worlds((2, 2))
    check_against(world, "42", "min-sum", world["jax"][("42", "min-sum", "pallas")])


@pytest.mark.parametrize("algorithm", ["min-sum", "layered-min-sum"])
@pytest.mark.parametrize("shape", WORLDS, ids=world_id)
def test_bit_exact_vs_single_device(worlds, shape, algorithm):
    world = worlds(shape)
    for c in codes_of(world["ng"]):
        graphs = graphs_from_jax(world["jgs"][c])
        sx, sz = (torch.from_numpy(s) for s in world["syn"][c])
        res = decode_batch(graphs, sx, sz, P_ERR,
                           BPConfig(max_iters=MAX_ITERS[c], algorithm=algorithm))
        check_against(world, c, algorithm,
                      (res.decisions_x.numpy(), res.decisions_z.numpy(),
                       res.error_code.numpy(), None))


@pytest.mark.parametrize("shape", WORLDS, ids=world_id)
def test_graph_group_runs_in_lockstep(worlds, shape):
    world = worlds(shape)
    for c in codes_of(world["ng"]):
        for algorithm in ALGORITHMS:
            by_data = {}
            for d, got in each_rank(world, c, algorithm):
                by_data.setdefault(d, []).append(got["iters"].tolist())
            for iters in by_data.values():
                assert all(i == iters[0] for i in iters)


def checks(n, every, phase=0):
    """Convergence tests in n iterations: k < n with k % every == phase."""
    return sum(1 for k in range(n) if k % every == phase)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("shape", WORLDS, ids=world_id)
def test_collectives_per_iteration(worlds, shape, algorithm):
    """One all_gather per flooding iteration per graph, B per layered sweep,
    plus one gather of each graph's decisions; the all_reduces are the
    convergence flags, the final convergence-fail flag and the re-encode
    sum: at most two per iteration."""
    world = worlds(shape)
    for c in codes_of(world["ng"]):
        B = {"x": world["jgs"][c].x.B, "z": world["jgs"][c].z.B}
        for _, got in each_rank(world, c, algorithm):
            itx, itz = (int(i) for i in got["iters"])
            n = got["collectives"]
            if algorithm == "layered-min-sum":
                assert n["all_gather"] == B["x"] * itx + B["z"] * itz + 2
                assert n["all_reduce"] == itx + itz + 2
            else:
                assert n["all_gather"] == itx + itz + 2
                assert n["all_reduce"] == checks(itx, 10) + checks(itz, 10) + 4
            assert n["all_reduce"] <= 2 * (itx + itz)


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_refusals(worlds, name):
    """The refusals run in the 1x3 world."""
    _, _, kind, match = ERRORS[name]
    for r in worlds((1, 3))["port"]:
        assert r[name][0] == kind and match in r[name][1]
