"""K7's plain versions and DeviceOSD0 against the JAX package on the CPU.

The plain packed core ``osd0_cuda.osd0_eliminate`` is held bit for bit
against ``osd0_eliminate_pallas(interpret=True)`` on systems packed by the
JAX package's own ``_pack_rows_words``; the fused plain version (the one the
CUDA kernel computes) through ``DeviceOSD0`` against JAX's device OSD-0 and
the host solver.  The kernel itself is tested on the card
(test_torch_kernel_osd0.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qec_ldpc_tpu.codes import construct_code
from qec_ldpc_tpu.codes import known_bicycle_code as jax_known_bicycle_code
from qec_ldpc_tpu.decoder.osd import OSDecoder as JaxOSDecoder
from qec_ldpc_tpu.decoder.osd_device import _gf2_rank, _pack_rows_words
from qec_ldpc_tpu.kernels.osd0_pallas import osd0_eliminate_pallas
from qec_ldpc_tpu_torch.decoder.osd import OSDecoder
from qec_ldpc_tpu_torch.decoder.osd_device import DeviceOSD0, ranking
from qec_ldpc_tpu_torch.kernels import osd0_cuda

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

CODES = {"42": lambda: construct_code(3, 3, 6, 7, 2, 3),
         "610": lambda: construct_code(4, 5, 10, 61, 9, 49),
         "gross": lambda: jax_known_bicycle_code("[[144,12,12]]")}
MATRICES = [(code, side) for code in CODES for side in "xz"]


def matrix(code: str, side: str) -> np.ndarray:
    c = CODES[code]()
    return np.asarray(c.pcm_x if side == "x" else c.pcm_z, dtype=np.int32) % 2


def instance(h: np.ndarray, lanes: int, seed: int, random_tail: int = 4):
    """Decodable syndromes of sparse errors, the last ``random_tail`` lanes
    random (mostly undecodable), and standard-normal reliabilities."""
    rng = np.random.default_rng(seed)
    m, n = h.shape
    e_true = (rng.random((n, lanes)) < 0.08).astype(np.int32)
    syn = (h @ e_true) % 2
    if random_tail:
        syn[:, -random_tail:] = rng.integers(0, 2, (m, random_tail))
    rel = rng.standard_normal((n, lanes)).astype(np.float32)
    return syn.astype(np.int32), rel


@pytest.mark.parametrize("code,side", MATRICES)
def test_eliminate_matches_pallas_interpret(code, side):
    """The packed core equals the Pallas kernel bit for bit on JAX-packed
    systems: reduced syndromes, pivot rows and pivot columns."""
    h = matrix(code, side)
    m, n = h.shape
    lanes = 21
    syn, rel = instance(h, lanes, seed=len(code) + ord(side))
    order = np.argsort(rel, axis=0, kind="stable").T.astype(np.int32)
    rank = _gf2_rank(h)
    h_ord = np.take(h, order, axis=1).transpose(1, 0, 2)     # (B, m, n)
    words = np.asarray(_pack_rows_words(jnp.asarray(h_ord), n))
    packed = np.ascontiguousarray(np.concatenate(
        [words, syn.T[:, :, None]], axis=2).transpose(0, 2, 1))
    want = osd0_eliminate_pallas(jnp.asarray(packed), m, n, rank,
                                 tile_batch=lanes, interpret=True)
    got = osd0_cuda.osd0_eliminate(torch.from_numpy(packed), m, n, rank)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the fused plain version packs the same system from H's columns
    hcols = torch.from_numpy(osd0_cuda.pack_columns(h))
    system = osd0_cuda.ordered_system(hcols, torch.from_numpy(syn),
                                      torch.from_numpy(order), m, n)
    np.testing.assert_array_equal(system.numpy(), packed)


def walk_work_np(h_ord: np.ndarray, rank: int, planes: int) -> int:
    """One lane's needed operations, by a dense NumPy walk of its ordered
    matrix (m, n): per column before the rank-th pivot, 2 per row, plus
    ``planes - c // 32`` per row that takes the pivot row."""
    a = h_ord.astype(bool).copy()
    m, n = a.shape
    used = np.zeros(m, dtype=bool)
    ops = 0
    for c in range(n):
        if used.sum() >= rank:
            break
        ops += 2 * m
        cand = np.flatnonzero(a[:, c] & ~used)
        if cand.size == 0:
            continue
        p = cand[0]
        rows = a[:, c].copy()
        rows[p] = False
        ops += (planes - c // 32) * int(rows.sum())
        a[rows] ^= a[p]
        used[p] = True
    return ops


@pytest.mark.parametrize("code,side", [("42", "x"), ("42", "z"),
                                       ("gross", "x")])
def test_eliminate_work_counts_the_needed_operations(code, side):
    """``work`` holds each lane's bit tests, picks and needed XORs, and
    leaves the walk's outputs as they are."""
    h = matrix(code, side)
    m, n = h.shape
    syn, rel = instance(h, 9, seed=11 + ord(side))
    order = np.argsort(rel, axis=0, kind="stable").T.astype(np.int32)
    rank = _gf2_rank(h)
    hcols = torch.from_numpy(osd0_cuda.pack_columns(h))
    packed = osd0_cuda.ordered_system(hcols, torch.from_numpy(syn),
                                      torch.from_numpy(order), m, n)
    work = torch.zeros(9, dtype=torch.int64)
    got = osd0_cuda.osd0_eliminate(packed, m, n, rank, work=work)
    for g, w in zip(got, osd0_cuda.osd0_eliminate(packed, m, n, rank)):
        assert torch.equal(g, w)
    planes = packed.shape[1]
    want = [walk_work_np(h[:, order[b]], rank, planes) for b in range(9)]
    assert work.tolist() == want


@pytest.mark.parametrize("code,side", MATRICES)
def test_device_osd0_matches_jax_and_host(code, side):
    """DeviceOSD0 on CPU tensors (the kernel's plain version) equals JAX's
    device OSD-0 and the host solver: corrections and solved flags."""
    h = matrix(code, side)
    syn, rel = instance(h, 21, seed=3 + len(code) + ord(side))
    e_j, ok_j = JaxOSDecoder(h, lam=0, device="device").decode(syn, rel)
    e_h, ok_h = OSDecoder(h, lam=0, device="host").decode(syn, rel)
    e_d, ok_d = OSDecoder(h, lam=0).decode(torch.from_numpy(syn),
                                           torch.from_numpy(rel))
    assert e_d.dtype == torch.uint8 and ok_d.dtype == torch.bool
    for e, ok in ((e_h, ok_h), (e_d, ok_d)):
        np.testing.assert_array_equal(e.numpy(), e_j)
        np.testing.assert_array_equal(ok.numpy(), ok_j)
    assert ok_j[:-4].all()
    sat = (h @ e_d.numpy().astype(np.int64)) % 2 == syn
    assert sat[:, ok_d.numpy()].all()


@pytest.mark.parametrize("lanes", [1, 2, 7, 19])
def test_odd_batch_sizes(lanes):
    h = matrix("42", "x")
    syn, rel = instance(h, lanes, seed=lanes, random_tail=min(lanes, 2) - 1)
    e_j, ok_j = JaxOSDecoder(h, lam=0, device="device").decode(syn, rel)
    e, ok = DeviceOSD0(h).decode(torch.from_numpy(syn),
                                 ranking(torch.from_numpy(rel)))
    np.testing.assert_array_equal(e.numpy(), e_j)
    np.testing.assert_array_equal(ok.numpy(), ok_j)


def test_decode_device_gathers_lanes():
    """decode_device on a lane subset equals decode on the gathered lanes."""
    h = matrix("42", "z")
    syn, rel = instance(h, 16, seed=5)
    dev = DeviceOSD0(h)
    failed = torch.tensor([3, 0, 11, 7])
    e, ok = dev.decode_device(torch.from_numpy(syn), torch.from_numpy(rel),
                              failed)
    e_all, ok_all = dev.decode(torch.from_numpy(syn),
                               ranking(torch.from_numpy(rel)))
    assert torch.equal(e, e_all[:, failed]) and torch.equal(ok, ok_all[failed])


def test_no_lanes():
    dev = DeviceOSD0(matrix("42", "x"))
    e, ok = dev.decode_device(torch.zeros((21, 5), dtype=torch.int32),
                              torch.zeros((42, 5)), torch.zeros(0, dtype=torch.int64))
    assert e.shape == (42, 0) and ok.shape == (0,)


def test_rank_matches_jax():
    for code, side in MATRICES:
        h = matrix(code, side)
        assert DeviceOSD0(h).rank == _gf2_rank(h)


def test_ranking_matches_numpy_stable_argsort():
    """-0.0 ties +0.0, NaN sorts last, ties keep their order."""
    v = np.array([0.0, -0.0, np.nan, -np.inf, 1.0, -0.0, np.inf, np.nan, 0.0,
                  -1.0, 1.0], dtype=np.float32)
    rel = np.stack([v, v[::-1].copy()], axis=1)
    want = np.argsort(rel, axis=0, kind="stable").T
    np.testing.assert_array_equal(ranking(torch.from_numpy(rel)).numpy(), want)


@pytest.mark.parametrize("bad", ["dtype", "shape", "rank"])
def test_solve_rejects_bad_arguments(bad):
    h = matrix("42", "x")
    m, n = h.shape
    hcols = torch.from_numpy(osd0_cuda.pack_columns(h))
    syn = torch.zeros((m, 3), dtype=torch.int32)
    order = torch.arange(n, dtype=torch.int32).repeat(3, 1)
    rank = 16
    if bad == "dtype":
        syn = syn.to(torch.int8)
    elif bad == "shape":
        order = order[:, :-1]
    else:
        rank = m + 1
    with pytest.raises((TypeError, ValueError)):
        osd0_cuda.osd0_solve(hcols, syn, order, m, n, rank)


def test_plain_solve_counts_no_launch():
    h = matrix("42", "x")
    syn, rel = instance(h, 4, seed=9)
    before = osd0_cuda.launches
    DeviceOSD0(h).decode(torch.from_numpy(syn), ranking(torch.from_numpy(rel)))
    assert osd0_cuda.launches == before
