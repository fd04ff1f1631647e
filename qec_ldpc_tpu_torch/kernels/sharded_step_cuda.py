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
either runs the kernel or raises.  ``launches`` counts kernel launches
(never the plain path).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from qec_ldpc_tpu_torch.decoder.min_sum import _sign, f32
from qec_ldpc_tpu_torch.decoder.sum_product import exclusive_scans
from qec_ldpc_tpu_torch.kernels import build, launch

SOURCES = ("sharded_min_sum_step.cu",)

#: the kernel's compile-time limits (kMaxB / kMaxLc in the source)
MAX_VAR_DEGREE = 8
MAX_SHARD_COLUMNS = 16

#: number of kernel launches made by :func:`sharded_min_sum_step` in this
#: process
launches = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built library with the launcher's C signature declared."""
    lib = build.load("qec_sharded_min_sum_step", SOURCES)
    fn = lib.qec_sharded_min_sum_step
    fn.argtypes = [
        *([ctypes.c_void_p] * 7), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
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


def variable_update(router, prior_llr: float, last: bool,
                    syn_sign: torch.Tensor, other: torch.Tensor,
                    v: torch.Tensor, alpha: float) -> torch.Tensor:
    """The step's new messages before the done mask: the check phase
    against the other shards' (min; sign), routing, the leave-one-out
    variable sums and the prior, in the association order of the JAX
    engine's body (``graph_sharded.py:397-439``).  The damped relay retries
    blend this with V before masking."""
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
    ev = router.to_var(e.reshape(Lc * B * P, bt)).reshape(Lc, B, P * bt)
    terms = [ev[:, i] for i in range(B)]
    pre, suf = exclusive_scans(terms, torch.add, torch.zeros_like(terms[0]))
    if last:
        full = (pre[-1] + suf[-1]) + terms[-1]
        outs = [prior_llr + full] * B
    else:
        outs = [prior_llr + (pre[i] + suf[i]) for i in range(B)]
    vv = torch.stack(outs, dim=1).reshape(Lc * B * P, bt)
    return router.to_check(vv)


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
                         alpha: float) -> tuple[torch.Tensor, torch.Tensor]:
    """One between-halos iteration of the shard ``router`` describes.

    ``prior_llr``: the float32 channel prior LLR; ``last``: the
    posterior-forming last iteration; ``syn_sign``: 1 - 2*syndrome as
    float32; ``other``: the other shards' combined (min; sign);
    ``done``: the lanes already converged.  Returns ``(v_new, partials)``,
    bit for bit :func:`sharded_min_sum_step_plain` on any device."""
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
    v_new = torch.empty_like(v)
    part = torch.empty_like(other)
    e = torch.empty_like(v)
    shifts = (ctypes.c_int32 * (router.B * router.Lc))(
        *np.asarray(router.table, dtype=np.int32).ravel().tolist())
    with torch.cuda.device(v.device):
        err = lib.qec_sharded_min_sum_step(
            syn_sign.data_ptr(), other.data_ptr(), done.data_ptr(),
            v.data_ptr(), v_new.data_ptr(), part.data_ptr(), e.data_ptr(),
            shifts, router.B, router.Lc, router.P, v.shape[1], f32(prior_llr),
            int(bool(last)), f32(alpha), launch.stream_of(v.device))
    launch.raise_on_error("qec_sharded_min_sum_step", err)
    launches += 1
    return v_new, part
