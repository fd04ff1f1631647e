"""The port's CLI and quality mode on a data mesh: one gloo world of two CPU
ranks (``torch_mesh_workers.cli_cases``) runs every case, the ranks sharing
each run's results directory as ``torchrun`` ranks on one host do.

* A data=2 sweep gives the same records on both ranks; only rank 0 writes
  the run log, the journal and the result files; a rerun resumes on both
  ranks from rank 0's journal.
* ``seed=None`` runs rank 0's seed everywhere.
* ``num_graph=2`` shards the graphs, with ``|ng=2`` in its run_id.
* ``osd=0`` with min-sum (and layered min-sum, and OSD-3 on the host) on
  data=2 gives counters EQUAL to the port's single-process run: every rank
  draws the chunk's full batch and decodes its own columns.  With relay
  too, for min-sum and layered min-sum with OSD-0 and OSD-1: each retry
  draws its gammas for the full batch and keeps the rank's columns.
* ``osd=0`` with ``num_graph=2`` (data=1 x graph=2) gives the
  single-process run's counters, through the CLI and directly.
* ``mc_chunk_arrays`` on data=2 returns, on every rank, the full arrays of
  the ``mesh=None`` call, relay included.
* The quality mode refuses to run without a mesh in several processes.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.decoder import BPConfig, CodeGraphs
from qec_ldpc_tpu_torch.harness import load_init_file, parse_reference_text
from qec_ldpc_tpu_torch.harness.cli import run_sweep
from qec_ldpc_tpu_torch.parallel import mesh as port_mesh
from qec_ldpc_tpu_torch.parallel.montecarlo import (
    mc_chunk_arrays,
    run_monte_carlo_osd,
)

from tests import torch_mesh_workers

torch.set_num_threads(1)

SPEC = "qc:3,3,6,7,2,3"
LINES = {
    "sweep": f"{SPEC} 1 2 256 20 0.02 seed=5 batch_size=64 steps_per_call=2",
    "noseed": f"{SPEC} 2 2 128 10 0.02 batch_size=64",
    "graph": f"{SPEC} 3 3 128 20 0.02 seed=2 batch_size=64 algorithm=min-sum "
             f"num_graph=2",
    "osd": f"{SPEC} 4 4 256 15 0.02 seed=5 batch_size=64 algorithm=min-sum "
           f"osd=0",
    "graph_osd": f"{SPEC} 4 4 256 15 0.02 seed=5 batch_size=64 "
                 f"algorithm=min-sum osd=0 num_graph=2",
}
# (algorithm, weight, count, batch, lam, relay retries)
OSD_RUNS = [("min-sum", 4, 256, 64, 0, 0), ("layered-min-sum", 4, 256, 64, 0, 0),
            ("min-sum", 5, 128, 64, 3, 0),
            ("min-sum", 5, 256, 64, 0, 4), ("min-sum", 5, 256, 64, 1, 4),
            ("layered-min-sum", 5, 256, 64, 0, 4),
            ("layered-min-sum", 5, 256, 64, 1, 4)]
STAT_KEYS = ("num_errors_tested", "num_x_errors_tested", "num_z_errors_tested",
             "corrected", "syndrome_errors_x", "syndrome_errors_z",
             "logical_errors", "convergence_fail_x", "convergence_fail_z",
             "rand_seed", "error_weight", "num_devices")


def write_init(tmp: Path, name: str, line: str) -> str:
    path = tmp / f"{name}.txt"
    path.write_text(f"{line} device=cpu results_dir={tmp}/{name} "
                    f"log_file={tmp}/{name}-log.txt\n")
    return str(path)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli-mesh")
    files = {name: write_init(tmp, name, line) for name, line in LINES.items()}
    ranks = port_mesh.spawn(torch_mesh_workers.cli_cases, 2,
                            device_type="cpu", args=(files, OSD_RUNS),
                            timeout=300)
    return tmp, ranks


def stats(records: list[dict]) -> list[tuple]:
    return [tuple(r[k] for k in STAT_KEYS) for r in records]


def test_sweep_is_the_same_on_both_ranks_and_resumes(world):
    tmp, ranks = world
    first, second = ranks[0]["sweep"]["runs"]
    assert [r["error_weight"] for r in first] == [1, 2]
    assert all(r["num_errors_tested"] == 256 and r["num_devices"] == 2
               for r in first)
    for rank in ranks:
        assert stats(rank["sweep"]["runs"][0]) == stats(first)
        assert stats(rank["sweep"]["runs"][1]) == stats(first)
        assert ([r["total_bp_iterations"] for r in rank["sweep"]["runs"][1]]
                == [r["total_bp_iterations"] for r in first])
    log = (tmp / "sweep-log.txt").read_text()
    assert log.count("Initializing run") == 2   # rank 0 alone, two runs
    assert log.count("resuming") == 2           # the second run, 2 weights
    assert "mesh data=2 x graph=1" in log
    # 4 chunks of 64 per weight in groups of 2: 2 lines a weight, once
    journal = (tmp / "sweep" / "journal.jsonl").read_text().splitlines()
    assert len(journal) == 4
    files = sorted((tmp / "sweep").glob("*_W_*.txt"))
    assert len(files) == 2
    for f in files:  # one record per run, not one per rank
        assert len(parse_reference_text(f.read_text())) == 2


def test_seed_none_takes_rank_0s(world):
    _, ranks = world
    seeds = {r["noseed"]["runs"][0][0]["rand_seed"] for r in ranks}
    assert len(seeds) == 1
    assert stats(ranks[0]["noseed"]["runs"][0]) == stats(
        ranks[1]["noseed"]["runs"][0])


def test_graph_sharded_sweep(world):
    tmp, ranks = world
    (run_id,) = ranks[0]["graph"]["run_ids"]
    assert "|ng=2|" in run_id and run_id.endswith("|torch=cpu")
    first = ranks[0]["graph"]["runs"][0]
    assert first[0]["num_errors_tested"] == 128
    assert stats(ranks[1]["graph"]["runs"][0]) == stats(first)
    assert stats(ranks[0]["graph"]["runs"][1]) == stats(first)
    assert "mesh data=1 x graph=2" in (tmp / "graph-log.txt").read_text()


def test_osd_sweep_equals_the_single_process_run(world, tmp_path):
    """The quality mode on data=2 (min-sum + OSD-0) gives the counters of
    the same config run in one process, and resumes to them."""
    tmp, ranks = world
    single = run_sweep(load_init_file(write_init(tmp_path, "osd",
                                                 LINES["osd"])))
    want = [s.to_dict() for s in single]
    for rank in ranks:
        for run in rank["osd"]["runs"]:
            got = stats(run)
            assert [g[:-1] for g in got] == [w[:-1] for w in stats(want)]
            assert got[0][-1] == 2
    assert want[0]["syndrome_errors_x"] == want[0]["syndrome_errors_z"] == 0
    assert want[0]["corrected"] < want[0]["num_errors_tested"]
    assert len((tmp / "osd" / "journal.jsonl").read_text().splitlines()) == 4
    assert "resuming W=4" in (tmp / "osd-log.txt").read_text()


def test_graph_osd_sweep_equals_the_single_process_run(world, tmp_path):
    """``osd=0`` with ``num_graph=2`` on the world (data=1 x graph=2): the
    single-process run's counters, ``|ng=2`` in the run_id, and a resume."""
    tmp, ranks = world
    single = run_sweep(load_init_file(write_init(tmp_path, "osd",
                                                 LINES["osd"])))
    want = stats([s.to_dict() for s in single])
    for rank in ranks:
        for run in rank["graph_osd"]["runs"]:
            assert [g[:-1] for g in stats(run)] == [w[:-1] for w in want]
    (run_id,) = ranks[0]["graph_osd"]["run_ids"]
    assert "|osd=0|ng=2|" in run_id
    assert "mesh data=1 x graph=2" in (tmp / "graph_osd-log.txt").read_text()
    assert "resuming W=4" in (tmp / "graph_osd-log.txt").read_text()


@pytest.mark.parametrize("i", range(len(OSD_RUNS)))
def test_quality_mode_on_data_mesh_equals_mesh_none(world, i):
    _, ranks = world
    alg, w, count, batch, lam, relay = OSD_RUNS[i]
    graphs = CodeGraphs.build(construct_code(3, 3, 6, 7, 2, 3))
    cfg = BPConfig(max_iters=15, algorithm=alg)
    want, _ = run_monte_carlo_osd(graphs, w, count, 0.02, cfg, seed=7,
                                  batch_size=batch, lam=lam,
                                  relay_retries=relay, device="cpu")
    for rank in ranks:
        np.testing.assert_array_equal(rank["osd_direct"][i], want)
    assert want[0] == count and want[4] == want[5] == 0
    if relay:
        # the retries ran and changed the outcome
        unrelayed, _ = run_monte_carlo_osd(graphs, w, count, 0.02, cfg,
                                           seed=7, batch_size=batch, lam=lam,
                                           device="cpu")
        assert not np.array_equal(unrelayed, want)


def test_quality_mode_refuses_a_graph_mesh(world):
    """The quality mode on a (data=1 x graph=2) mesh gives the counters of
    the single-process run."""
    _, ranks = world
    graphs = CodeGraphs.build(construct_code(3, 3, 6, 7, 2, 3))
    want, _ = run_monte_carlo_osd(graphs, 4, 64, 0.02,
                                  BPConfig(max_iters=15, algorithm="min-sum"),
                                  seed=7, batch_size=32, device="cpu")
    for rank in ranks:
        np.testing.assert_array_equal(rank["graph_osd_direct"], want)
    assert want[4] == want[5] == 0


@pytest.mark.parametrize("relay", [0, 4])
def test_mc_chunk_arrays_on_data_mesh_equals_mesh_none(world, relay):
    _, ranks = world
    graphs = CodeGraphs.build(construct_code(3, 3, 6, 7, 2, 3))
    want = torch_mesh_workers.arrays_of(mc_chunk_arrays(
        graphs, 7, 2, 5, 0.02, BPConfig(max_iters=15, algorithm="min-sum",
                                        return_soft=True),
        64, relay_retries=relay, device="cpu"))
    assert want["soft_x"].shape == (graphs.code.n, 64)
    for rank in ranks:
        got = rank["arrays"][relay // 4]
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_quality_mode_needs_a_mesh_in_several_processes(world):
    """Without a mesh every process would decode the full batch and count
    each failure once per process: refused, as in JAX."""
    _, ranks = world
    for rank in ranks:
        assert rank["osd_no_mesh"] is not None
        assert "requires a mesh" in rank["osd_no_mesh"]
