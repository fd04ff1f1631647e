"""Where a lane's arrays live: the min-sum and sum-product kernels'
placements and the device's shared-memory limit that every kernel's plan
reads.

The min-sum kernels (K2 and K4, ``csrc/min_sum.cu``; K5,
``csrc/lifted_min_sum.cu``) keep the same arrays per lane, sized by the
graph's edges, checks and variables, so one :func:`plan` places them for
both wrappers (``min_sum_cuda``, ``lifted_min_sum_cuda``); the sum-product
kernels (K1, ``csrc/bp_sum_product.cu``; K6, ``csrc/lifted_bp.cu``) likewise
share :func:`bp_plan` (``bp_cuda``, ``lifted_bp_cuda``).  The other plans
(``layered_cuda``, ``sharded_step_cuda``, ``osd0_cuda``) take their limit
from :func:`smem_optin`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import TYPE_CHECKING

from qec_ldpc_tpu_torch.kernels import build, launch

if TYPE_CHECKING:  # annotations only: the decoder imports the kernels
    from qec_ldpc_tpu_torch.decoder.layout import CirculantGraph
    from qec_ldpc_tpu_torch.decoder.lifted import LiftedGraph


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


@dataclasses.dataclass(frozen=True)
class Plan:
    """Where one lane's arrays live, and the CTA size: what the min-sum
    launchers are given (the kernels lay the arrays out in :func:`plan`'s
    order)."""

    threads: int
    v_shared: bool
    state_shared: bool
    damping_shared: bool
    smem_bytes: int      # dynamic shared memory per CTA
    slab_floats: int     # float32 global scratch per lane


def plan(graph: CirculantGraph | LiftedGraph, damped: bool,
         smem_limit: int) -> Plan:
    """The min-sum kernels' placement for ``graph`` (K2's kernel on a
    circulant graph, K5's on a lifted one) on a device whose CTA may take
    ``smem_limit`` bytes of shared memory (its opt-in limit, 227 KB on an
    H100): the syndrome bits always in shared memory, then, while they fit,
    V (4 bytes per edge), the compressed check state (12 bytes per check)
    and the damping (4 bytes per edge); the rest in the lane's global slab.
    Each array starts 16-byte aligned, in shared memory and in the slab.
    Threads: one per two variables, a multiple of 32 in [128, 1024], so
    that an iteration is one or two passes over the lane's checks and
    variables."""
    edges, checks = graph.num_edges, graph.num_checks
    v_bytes = _align16(4 * edges)
    state_bytes = _align16(8 * checks) + _align16(4 * checks)
    used, slab_bytes = _align16(checks), 0
    placed = []
    for nbytes, wanted in ((v_bytes, True), (state_bytes, True),
                           (v_bytes, damped)):
        fits = wanted and used + nbytes <= smem_limit
        used += nbytes if fits else 0
        slab_bytes += nbytes if wanted and not fits else 0
        placed.append(fits)
    threads = min(1024, max(128, -(-graph.num_vars // 64) * 32))
    return Plan(threads, *placed, used, slab_bytes // 4)


@dataclasses.dataclass(frozen=True)
class BPPlan:
    """Where one lane's V and E live, and the CTA size: what the
    sum-product launchers are given (the kernels lay the arrays out in
    :func:`bp_plan`'s order)."""

    threads: int
    v_shared: bool
    e_shared: bool
    smem_bytes: int      # dynamic shared memory per CTA
    slab_floats: int     # float32 global scratch per lane


def bp_plan(graph: CirculantGraph | LiftedGraph, smem_limit: int) -> BPPlan:
    """The sum-product kernels' placement for ``graph`` (K1's kernel on a
    circulant graph, K6's on a lifted one) on a device whose CTA may take
    ``smem_limit`` bytes of shared memory (its opt-in limit, 227 KB on an
    H100): the syndrome bits (a byte per check) always in shared memory,
    then, while they fit, V and E (4 bytes per edge each); the rest in the
    lane's global slab.  Each array starts 16-byte aligned, in shared memory
    and in the slab.  Threads: one per two variables, a multiple of 32 in
    [128, 1024], so that an iteration is one or two passes over the lane's
    checks and variables."""
    msg_bytes = _align16(4 * graph.num_edges)
    used, slab_bytes = _align16(graph.num_checks), 0
    placed = []
    for _ in ("V", "E"):
        fits = used + msg_bytes <= smem_limit
        used += msg_bytes if fits else 0
        slab_bytes += 0 if fits else msg_bytes
        placed.append(fits)
    threads = min(1024, max(128, -(-graph.num_vars // 64) * 32))
    return BPPlan(threads, *placed, used, slab_bytes // 4)


@functools.lru_cache(maxsize=None)
def smem_optin(index: int) -> int:
    """The shared memory a CTA may take on CUDA device ``index`` with the
    opt-in, in bytes (queried once per device, through the min-sum
    library's ``qec_min_sum_smem_optin``)."""
    lib = build.load("qec_min_sum", ("min_sum.cu",))
    lib.qec_min_sum_smem_optin.argtypes = [ctypes.c_int]
    lib.qec_min_sum_smem_optin.restype = ctypes.c_int
    limit = lib.qec_min_sum_smem_optin(index)
    launch.raise_on_error("qec_min_sum_smem_optin", -min(limit, 0))
    return limit
