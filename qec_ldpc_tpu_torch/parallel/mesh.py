"""Device mesh for Monte-Carlo scale-out (PyTorch).

The port of ``qec_ldpc_tpu/parallel/mesh.py`` to ``torch.distributed``.  A
mesh has two axes:

  * ``data``  — Monte-Carlo samples: each rank decodes its own sub-batch,
    and the counters are summed over the axis once per group of chunks;
  * ``graph`` — Tanner-graph sharding: each rank owns L/G block columns of
    both graphs and exchanges per-check partials with the other ranks of its
    graph group every iteration (parallel/graph_sharded.py).

The program is SPMD: one process per rank, every rank runs the same calls.
Ranks are laid out row-major over (data, graph), rank = data_index *
num_graph + graph_index.  Under ``torchrun --nproc-per-node=N``,
:func:`maybe_init_distributed` starts the process group; :func:`spawn` is
its in-process counterpart, which the tests and ``chip_smoke.py`` use.

Backend rule (:func:`choose_backend`): ``nccl`` when every rank of the host
has a CUDA card of its own, otherwise ``gloo``, and ``gloo`` on the CPU.
Gloo takes CUDA tensors for all_gather and all_reduce by staging them
through host memory, so several ranks can share one card.  A backend that
fails raises; nothing retries on another.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
from multiprocessing import resource_tracker
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable

import torch
import torch.distributed as dist

DATA_AXIS = "data"
GRAPH_AXIS = "graph"
AXES = (DATA_AXIS, GRAPH_AXIS)

#: how long a collective may wait for its peers before the rank fails
TIMEOUT = datetime.timedelta(seconds=300)

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def choose_backend(device_type: str, ranks_per_host: int) -> str:
    """``nccl`` when ``device_type`` is "cuda" and the host has a card for
    each of its ``ranks_per_host`` ranks; otherwise ``gloo``."""
    if device_type == "cpu":
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"unsupported device type {device_type!r}")
    return "nccl" if torch.cuda.device_count() >= ranks_per_host else "gloo"


def _select_card(local_rank: int) -> None:
    """Make card ``local_rank % device_count`` this process's device."""
    torch.cuda.set_device(local_rank % torch.cuda.device_count())


def maybe_init_distributed(device_type: str = "cuda") -> bool:
    """Start the process group from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``),
    with the backend of :func:`choose_backend`, and on CUDA select the card
    of this rank.  Without that environment this is a single process and
    nothing starts.  Returns True when running multi-process."""
    if not dist.is_initialized():
        if not all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                             "MASTER_ADDR")):
            return False
        local = int(os.environ.get("LOCAL_WORLD_SIZE",
                                   os.environ["WORLD_SIZE"]))
        if device_type == "cuda":
            _select_card(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(choose_backend(device_type, local),
                                timeout=TIMEOUT)
    return dist.get_world_size() > 1


class Mesh:
    """A (data, graph) device mesh over the process group: the
    ``DeviceMesh`` plus the collectives the engines call, each counted in
    ``collectives`` (a dict of issued "all_gather" and "all_reduce"), and
    ``gathered_bytes``: the bytes this rank's all_gathers received from the
    other ranks ((size - 1) times the tensor's bytes each)."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.backend = dist.get_backend()
        self.shape = {axis: device_mesh.size(i) for i, axis in enumerate(AXES)}
        self._groups = {axis: device_mesh.get_group(axis) for axis in AXES}
        self.collectives = {"all_gather": 0, "all_reduce": 0}
        self.gathered_bytes = 0

    def rank(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.device_mesh.get_local_rank(axis)

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x`` of every rank along ``axis``, stacked in axis order:
        (size(axis), *x.shape)."""
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(self.size(axis))]
        dist.all_gather(out, x, group=self._groups[axis])
        self.collectives["all_gather"] += 1
        self.gathered_bytes += (len(out) - 1) * x.numel() * x.element_size()
        return torch.stack(out)

    def all_reduce(self, x: torch.Tensor, op: str, axis: str) -> torch.Tensor:
        """The elementwise ``op`` ("sum" or "max") of ``x`` over ``axis``,
        as a new tensor."""
        y = x.clone()
        dist.all_reduce(y, _REDUCE_OPS[op], group=self._groups[axis])
        self.collectives["all_reduce"] += 1
        return y


def make_mesh(num_data: int | None = None, num_graph: int = 1,
              device_type: str = "cuda") -> Mesh:
    """Build the (data, graph) mesh over every rank of the process group;
    ``num_data`` defaults to world size / ``num_graph``.  On CUDA the mesh's
    device is the card selected for this rank."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: run the ranks under torchrun "
                           "and call maybe_init_distributed(), or use spawn()")
    world = dist.get_world_size()
    if num_data is None:
        num_data = world // num_graph
    if num_data < 1 or num_graph < 1 or num_data * num_graph != world:
        raise ValueError(f"mesh {num_data}x{num_graph} needs "
                         f"{num_data * num_graph} ranks, have {world}")
    device = (torch.device("cuda", torch.cuda.current_device())
              if device_type == "cuda" else torch.device(device_type))
    device_mesh = init_device_mesh(device_type, (num_data, num_graph),
                                   mesh_dim_names=AXES)
    return Mesh(device_mesh, device)


def _rank_main(rank: int, world: int, num_data: int, num_graph: int,
               device_type: str, backend: str, workdir: str,
               fn: Callable, args: tuple) -> None:
    """One spawned rank: join the group, build the mesh, run ``fn`` and save
    its result (or the traceback) under ``workdir``."""
    out = Path(workdir)
    try:
        if device_type == "cuda":
            _select_card(rank)
        dist.init_process_group(backend, init_method=f"file://{out}/rendezvous",
                                world_size=world, rank=rank, timeout=TIMEOUT)
        try:
            result = fn(make_mesh(num_data, num_graph, device_type), *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, out / f"result-{rank}.pt")
    except BaseException:
        (out / f"error-{rank}.txt").write_text(traceback.format_exc())
        raise


def _stop_resource_tracker() -> None:
    """Stop multiprocessing's resource tracker if this process started it
    (the spawn context does, with the first rank) and wait for it to exit.
    Left alone it would end only once it reads EOF after this process has
    exited, so it outlives its parent; the next world starts a new one."""
    tracker = resource_tracker._resource_tracker
    stop = getattr(tracker, "_stop", None)
    if stop is not None:
        stop()
    elif tracker._fd is not None and tracker._pid is not None:
        # Python releases without ResourceTracker._stop: what it does
        os.close(tracker._fd)
        os.waitpid(tracker._pid, 0)
        tracker._fd = tracker._pid = None


def spawn(fn: Callable, num_data: int, num_graph: int = 1, *,
          device_type: str = "cuda", args: tuple = (),
          timeout: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on every rank of a fresh (num_data x
    num_graph) world, one spawned process per rank, and return the ranks'
    results in rank order.

    The ranks meet through a ``file://`` rendezvous in a temporary
    directory (no port, so concurrent worlds never collide) with the
    backend of :func:`choose_backend`.  ``fn`` must be a top-level function
    of an importable module and return what ``torch.save`` can write
    (CPU tensors, NumPy arrays, Python values).  If any rank fails or the
    world outlives ``timeout`` seconds, every rank is stopped and this
    raises with the failed ranks' tracebacks.  No process started here
    outlives the call: the ranks are joined (or killed), and so is the
    resource tracker that the spawn context starts with them."""
    world = num_data * num_graph
    backend = choose_backend(device_type, world)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="qec-mesh-") as workdir:
        procs = [ctx.Process(target=_rank_main,
                             args=(rank, world, num_data, num_graph,
                                   device_type, backend, workdir, fn, args))
                 for rank in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.exitcode is None for p in procs):
                if (any(p.exitcode not in (None, 0) for p in procs)
                        or time.monotonic() > deadline):
                    break
                procs[0].join(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
            _stop_resource_tracker()
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            errors = "".join(
                f"\n--- rank {r} ---\n{path.read_text()}"
                for r in range(world)
                if (path := Path(workdir) / f"error-{r}.txt").exists())
            late = (" after the timeout" if time.monotonic() > deadline
                    else "")
            raise RuntimeError(f"mesh world {num_data}x{num_graph} "
                               f"({backend}) failed{late}: exit codes "
                               f"{codes}{errors}")
        return [torch.load(Path(workdir) / f"result-{r}.pt", weights_only=False)
                for r in range(world)]
