"""One graph-sharded min-sum iteration through the hand-written CUDA kernel
(csrc/sharded_min_sum_step.cu).

The port of ``qec_ldpc_tpu/kernels/sharded_step_pallas.py::
sharded_min_sum_step_pallas`` (K8): everything the graph-sharded min-sum
engine (parallel/graph_sharded.py) does between two halo all_gathers, for the
shard of one graph-axis position:

    partials_n -- all_gather, other-shards combine --> other_n
    (V_n, other_n) -- one step --> (V_{n+1}, partials_{n+1})

The shard owns ``Lc`` block columns of a B x L circulant graph and is
described by a router (``parallel.graph_sharded.ShardRouter``): its ``B``,
``Lc``, ``P``, its (B, Lc) exponent sub-table ``table`` and the routings
``to_var`` / ``to_check`` of its (Lc*B*P, batch) edge rows, (l, b) block
order, check-indexed.  The layout is the port's row layout with the batch
trailing: V (Lc*B*P, batch), syndrome signs (B*P, batch), and the
(min; sign) partials and ``other`` as (2*B*P, batch), minima first.  The TPU
kernel's transposed (blocks, batch, P padded to 128) tiles are not carried
over; ``convert.lanes_to_rows`` maps them for the tests.

:func:`sharded_min_sum_step` checks its arguments and launches the kernel on
the current CUDA stream for CUDA tensors; for CPU tensors it runs
:func:`sharded_min_sum_step_plain`.  There is no fallback: a CUDA tensor
either runs the kernel or raises.  :func:`plan` owns the launch shape: the
lanes per CTA, where the CTA's compressed check state lives (shared memory
or a global slab, from the device's opt-in limit) and how the partials are
formed.  ``launches`` counts kernel launches (never the plain path).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from qec_ldpc_tpu_torch.decoder.min_sum import _sign, f32
from qec_ldpc_tpu_torch.decoder.sum_product import exclusive_scans
from qec_ldpc_tpu_torch.kernels import build, launch, placement

SOURCES = ("sharded_min_sum_step.cu",)

#: the kernel's compile-time limits (kMaxB / kMaxLc / kMaxLanes in the
#: source)
MAX_VAR_DEGREE = 8
MAX_SHARD_COLUMNS = 16
MAX_LANES = 32

#: :func:`plan`'s lanes per CTA and partials route, from the launch-shape
#: measurement on an H100 (csrc/sharded_min_sum_step.cu's note): 8 lanes
#: with the state on chip were fastest at batch 1024 and 2048, and folding
#: the partials beat reading them back wherever its key still fits
DEFAULT_LANES = 8
DEFAULT_FOLD = True

#: number of kernel launches made by :func:`sharded_min_sum_step` in this
#: process
launches = 0


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch's shape: lanes per CTA, threads, the partials' route, and
    where the CTA's compressed check state lives (shared memory when
    ``slab_bytes`` is 0, else a global slab of that many bytes per CTA)."""

    lanes: int
    threads: int
    fold: bool           # partials from the variable phase's atomics
    smem_bytes: int      # dynamic shared memory per CTA
    slab_bytes: int      # global state per CTA (0: the state is on chip)


def state_bytes(router, lanes: int, fold: bool) -> int:
    """The compressed check state of one CTA: {min1, min2} (8 bytes), the
    meta word (4) and, folding the partials, their key (4) per check and
    lane, each array 16-byte aligned."""
    n = router.B * router.P * lanes
    return _align16(8 * n) + _align16(4 * n) + (_align16(4 * n) if fold else 0)


def plan(router, smem_limit: int, lanes: int | None = None,
         fold: bool | None = None) -> Plan:
    """The kernel's launch shape for the shard ``router`` describes on a
    device whose CTA may take ``smem_limit`` bytes of shared memory (its
    opt-in limit, 227 KB on an H100).  By default DEFAULT_LANES lanes per
    CTA, halved until the state fits on chip (one lane whose state does not
    fit keeps DEFAULT_LANES with the state in the slab), and the partials
    folded when their key fits too.  ``lanes`` (a power of two up to 32)
    and ``fold`` override the choice; a state that does not fit goes to the
    slab.  Threads: one per two (variable, lane) pairs, a multiple of 32 in
    [128, 1024]."""
    if lanes is None:
        lanes = DEFAULT_LANES
        while lanes > 1 and state_bytes(router, lanes, False) > smem_limit:
            lanes //= 2
        if state_bytes(router, lanes, False) > smem_limit:
            lanes = DEFAULT_LANES
    if lanes < 1 or lanes > MAX_LANES or lanes & (lanes - 1):
        raise ValueError(f"lanes per CTA must be a power of two up to "
                         f"{MAX_LANES}, got {lanes}")
    if fold is None:
        fold = DEFAULT_FOLD and state_bytes(router, lanes, True) <= smem_limit
    nbytes = state_bytes(router, lanes, fold)
    on_chip = nbytes <= smem_limit
    pairs = lanes * router.Lc * router.P
    threads = min(1024, max(128, -(-pairs // 64) * 32))
    return Plan(lanes, threads, fold, nbytes if on_chip else 0,
                0 if on_chip else nbytes)


#: the C types of ``qec_sharded_min_sum_step``'s parameters, in order
ARGTYPES = [
    *([ctypes.c_void_p] * 7), ctypes.POINTER(ctypes.c_int32),
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_int, ctypes.c_float,
    ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built library with the launcher's C signature declared."""
    lib = build.load("qec_sharded_min_sum_step", SOURCES)
    lib.qec_sharded_min_sum_step.argtypes = ARGTYPES
    lib.qec_sharded_min_sum_step.restype = ctypes.c_int
    return lib


def local_partials(v: torch.Tensor, Lc: int) -> torch.Tensor:
    """The shard's per-check (min |V|; sign product) over its ``Lc``
    columns: (Lc*B*P, batch) -> (2*B*P, batch), minima first."""
    t = v.reshape(Lc, -1, v.shape[-1])
    m, s = t[0].abs(), _sign(t[0])
    for l in range(1, Lc):
        m = torch.minimum(m, t[l].abs())
        s = s * _sign(t[l])
    return torch.cat([m, s])


def check_messages(router, syn_sign: torch.Tensor, other: torch.Tensor,
                   v: torch.Tensor, alpha: float) -> torch.Tensor:
    """The step's check phase: E (Lc*B*P, batch), check-indexed, from the
    shard's V against the other shards' (min; sign), in the association
    order of the JAX engine's body (``graph_sharded.py:397-439``)."""
    B, Lc, P = router.B, router.Lc, router.P
    bt = v.shape[-1]
    alpha = f32(alpha)
    t = v.reshape(Lc, B * P, bt)
    mags = [t[l].abs() for l in range(Lc)]
    sgns = [_sign(t[l]) for l in range(Lc)]
    pre_m, suf_m = exclusive_scans(mags, torch.minimum,
                                   torch.full_like(mags[0], math.inf))
    pre_s, suf_s = exclusive_scans(sgns, torch.mul, torch.ones_like(sgns[0]))
    omin, osgn = other[:B * P], other[B * P:]
    e = torch.stack([
        syn_sign * (alpha * (pre_s[i] * suf_s[i] * osgn)
                    * torch.minimum(torch.minimum(pre_m[i], suf_m[i]), omin))
        for i in range(Lc)])
    return e.reshape(Lc * B * P, bt)


def variable_sums(router, prior_llr: float, last: bool,
                  e: torch.Tensor) -> torch.Tensor:
    """The step's variable phase: E routed to var order, the leave-one-out
    sums over b (the full sum on the last iteration) plus the prior LLR,
    routed back to check order."""
    B, Lc, P = router.B, router.Lc, router.P
    bt = e.shape[-1]
    ev = router.to_var(e).reshape(Lc, B, P * bt)
    terms = [ev[:, i] for i in range(B)]
    pre, suf = exclusive_scans(terms, torch.add, torch.zeros_like(terms[0]))
    if last:
        full = (pre[-1] + suf[-1]) + terms[-1]
        outs = [prior_llr + full] * B
    else:
        outs = [prior_llr + (pre[i] + suf[i]) for i in range(B)]
    vv = torch.stack(outs, dim=1).reshape(Lc * B * P, bt)
    return router.to_check(vv)


def variable_update(router, prior_llr: float, last: bool,
                    syn_sign: torch.Tensor, other: torch.Tensor,
                    v: torch.Tensor, alpha: float) -> torch.Tensor:
    """The step's new messages before the done mask: :func:`check_messages`
    then :func:`variable_sums`.  The damped relay retries blend this with V
    before masking."""
    return variable_sums(router, prior_llr, last,
                         check_messages(router, syn_sign, other, v, alpha))


def sharded_min_sum_step_plain(router, prior_llr: float, last: bool,
                               syn_sign: torch.Tensor, other: torch.Tensor,
                               done: torch.Tensor, v: torch.Tensor,
                               alpha: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel: returns ``(v_new
    (Lc*B*P, batch), partials (2*B*P, batch))``, V_new keeping V on done
    lanes and the partials taken from the masked V_new."""
    vv = variable_update(router, f32(prior_llr), last, syn_sign, other, v,
                         alpha)
    v_new = torch.where(done[None, :], v, vv)
    return v_new, local_partials(v_new, router.Lc)


def _check_args(router, syn_sign, other, done, v) -> None:
    B, Lc, P = router.B, router.Lc, router.P
    if v.dim() != 2:
        raise ValueError(f"v must be (Lc*B*P, batch), got {tuple(v.shape)}")
    batch = v.shape[1]
    for name, t, rows, dtype in (("v", v, Lc * B * P, torch.float32),
                                 ("syn_sign", syn_sign, B * P, torch.float32),
                                 ("other", other, 2 * B * P, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != (rows, batch):
            raise ValueError(f"{name} shape {tuple(t.shape)} does not match "
                             f"({rows}, {batch})")
    if done.dtype != torch.bool or tuple(done.shape) != (batch,):
        raise ValueError(f"done must be bool ({batch},), got {done.dtype} "
                         f"{tuple(done.shape)}")
    if len({t.device for t in (syn_sign, other, done, v)}) != 1:
        raise ValueError("the step's tensors lie on different devices")


def sharded_min_sum_step(router, prior_llr: float, last: bool,
                         syn_sign: torch.Tensor, other: torch.Tensor,
                         done: torch.Tensor, v: torch.Tensor,
                         alpha: float, shape: Plan | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """One between-halos iteration of the shard ``router`` describes.

    ``prior_llr``: the float32 channel prior LLR; ``last``: the
    posterior-forming last iteration; ``syn_sign``: 1 - 2*syndrome as
    float32; ``other``: the other shards' combined (min; sign), the signs
    +-1; ``done``: the lanes already converged.  Returns ``(v_new,
    partials)``, bit for bit :func:`sharded_min_sum_step_plain` on any
    device.  ``shape``: the kernel's launch shape, by default
    :func:`plan`'s for the device (a measurement may pass another)."""
    global launches
    _check_args(router, syn_sign, other, done, v)
    if v.device.type == "cpu":
        return sharded_min_sum_step_plain(router, prior_llr, last, syn_sign,
                                          other, done, v, alpha)
    launch.check_device(v)
    if router.B > MAX_VAR_DEGREE or router.Lc > MAX_SHARD_COLUMNS:
        raise ValueError(f"shard B={router.B}, Lc={router.Lc} exceeds the "
                         f"kernel's {MAX_VAR_DEGREE}, {MAX_SHARD_COLUMNS}")
    for name, t in (("syn_sign", syn_sign), ("other", other), ("done", done)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = _library()
    batch = v.shape[1]
    pl = (plan(router, placement.smem_optin(v.device.index))
          if shape is None else shape)
    v_new = torch.empty_like(v)
    part = torch.empty_like(other)
    scratch = (torch.empty((-(-batch // pl.lanes) * pl.slab_bytes,),
                           dtype=torch.uint8, device=v.device)
               if pl.slab_bytes else None)
    shifts = (ctypes.c_int32 * (router.B * router.Lc))(
        *np.asarray(router.table, dtype=np.int32).ravel().tolist())
    with torch.cuda.device(v.device):
        err = lib.qec_sharded_min_sum_step(
            syn_sign.data_ptr(), other.data_ptr(), done.data_ptr(),
            v.data_ptr(), v_new.data_ptr(), part.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            shifts, router.B, router.Lc, router.P, batch, f32(prior_llr),
            int(bool(last)), f32(alpha), pl.lanes, pl.threads, int(pl.fold),
            pl.smem_bytes, pl.slab_bytes, launch.stream_of(v.device))
    launch.raise_on_error("qec_sharded_min_sum_step", err)
    launches += 1
    return v_new, part
