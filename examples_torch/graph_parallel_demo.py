"""Graph-parallel Monte-Carlo statistics demo (BASELINE config 5).

The PyTorch port of examples/graph_parallel_demo.py.  Runs the flagship
[[610,61]] code's statistics pipeline over a (data x graph) mesh, the
Tanner graphs themselves sharded block-column-wise across the graph axis,
and shows the exact decoder's counters (min-sum) equal to a data-only mesh
of the same data size.  Each mesh is a world of ranks spawned with
``parallel/mesh.py::spawn``: over NCCL when every rank has a card of its
own, else over gloo (several ranks sharing one card, or the CPU).  On CUDA
the graph-sharded min-sum runs the between-halos kernel (K8,
csrc/sharded_min_sum_step.cu) and the data-only mesh the min-sum kernel
(K2, csrc/min_sum.cu).

    python3 examples_torch/graph_parallel_demo.py [--num-data 4]
        [--num-graph 2] [--device cpu]
"""

import argparse
import pathlib
import sys

# runnable from anywhere without installing the package
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from examples_torch.quickstart import device_of
from qec_ldpc_tpu_torch.codes import construct_code
from qec_ldpc_tpu_torch.decoder import BPConfig, CodeGraphs
from qec_ldpc_tpu_torch.kernels import min_sum_cuda, sharded_step_cuda
from qec_ldpc_tpu_torch.parallel import run_monte_carlo, spawn


def run_on_mesh(mesh, params: tuple, kw: dict) -> dict:
    """One rank: ``run_monte_carlo`` on the mesh, with the rank's min-sum
    (K2) and between-halos (K8) kernel launches."""
    graphs = CodeGraphs.build(construct_code(*params))
    counters, iters = run_monte_carlo(
        graphs, cfg=BPConfig(max_iters=100, algorithm="min-sum"), mesh=mesh,
        device=mesh.device, **kw)
    return {"counters": counters, "iters": iters,
            "launches": {"min_sum": min_sum_cuda.launches,
                         "sharded_min_sum_step": sharded_step_cuda.launches}}


def main(argv=None) -> dict:
    """Returns both meshes' rank 0 results (counters, iterations, kernel
    launches) and every rank's launches, by mesh."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--num-data", type=int, default=4)
    ap.add_argument("--num-graph", type=int, default=2)
    ap.add_argument("--code", type=int, nargs=6, default=[4, 5, 10, 61, 9, 49],
                    metavar=("J", "K", "L", "P", "SIGMA", "TAU"),
                    help="construct_code parameters (default: [[610,61]])")
    ap.add_argument("--weight", type=int, default=30)
    ap.add_argument("--count", type=int, default=512)
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args(argv)
    device_of(args.device)
    kw = dict(weight=args.weight, count=args.count, error_probability=0.01, seed=7,
              batch_size=args.batch)
    params = tuple(args.code)
    out = {}
    # the data-only mesh decodes whole graphs; the (data x graph) mesh
    # splits each graph over num_graph ranks (L / num_graph block columns
    # each), whose check-node partials ride one all_gather per iteration
    for name, ng in (("data", 1), ("graph", args.num_graph)):
        ranks = spawn(run_on_mesh, args.num_data, ng,
                      device_type=torch.device(args.device).type,
                      args=(params, kw))
        print(f"{name} mesh: data={args.num_data} x graph={ng}, "
              f"{len(ranks)} ranks ({args.device})")
        out[name] = dict(ranks[0], launches=[r["launches"] for r in ranks])
    c_data, c_graph = out["data"]["counters"], out["graph"]["counters"]
    print("data-only counters:", np.asarray(c_data).tolist())
    print("graph-parallel    :", np.asarray(c_graph).tolist())
    assert np.array_equal(np.asarray(c_data), np.asarray(c_graph))
    assert out["data"]["iters"] == out["graph"]["iters"]
    print(f"bit-match OK; corrected fraction = {c_graph[3] / c_graph[0]:.4f}")
    return out


if __name__ == "__main__":
    main()
