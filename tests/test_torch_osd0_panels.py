"""The OSD-0 kernel's panel walk (csrc/osd0.cu), modelled in NumPy and
held on the CPU against the plain walk and the JAX package.

The kernel walks the ordered columns 32 at a time.  Within panel k it reads
only word k of each row: one warp holds word k of every row (lane l the rows
l*kR .. l*kR + kR - 1), picks each column's pivot as the first candidate row
of the lowest lane that has one, and XORs the pivot's word k into the other
rows with the bit, while each row tracks a 32-bit mask of the panel's
pivots it has taken (``M_r ^= M_p ^ (1 << j)``).  The trailing words k+1 ..
w (the syndrome plane included) then take one update per panel from the
panel's pivot rows as they stood at its start.  :func:`panel_walk` does
that on packed words and must equal ``osd0_cuda.osd0_eliminate`` and JAX's
``osd0_eliminate_pallas`` (interpret mode) bit for bit, on real parity-check
matrices and on the corner cases of ``tests/osd0_cases.py``: n and m not
multiples of 32, a rank-deficient H, columns with no candidate, pivots on
both sides of a panel border, rank reached in mid-panel, zero syndromes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qec_ldpc_tpu.codes import construct_code
from qec_ldpc_tpu.codes import known_bicycle_code as jax_known_bicycle_code
from qec_ldpc_tpu.decoder.osd_device import _gf2_rank, _pack_rows_words
from qec_ldpc_tpu.kernels.osd0_pallas import osd0_eliminate_pallas
from qec_ldpc_tpu_torch.kernels import osd0_cuda
from tests import osd0_cases

#: the shared memory an H100's CTA may take with the opt-in (227 KB)
H100_SMEM = 232448

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


def panel_walk(packed: np.ndarray, m: int, n: int, rank: int, kR: int):
    """The kernel's walk of one lane's packed system ``(w + 1, m)`` uint32.
    Returns ``(s_final, used, pivcol, walk)``: the plain walk's outputs and,
    per panel walked, the (column, pivot row) pairs it took."""
    sys = packed.astype(np.uint32).copy()
    w = sys.shape[0] - 1
    rows = 32 * kR
    pivcol = np.full(rows, n + 1, dtype=np.int32)
    used = np.zeros(rows, dtype=bool)
    found = 0
    walk = []
    for k in range(w):
        if found >= rank:
            break
        word = np.zeros(rows, dtype=np.uint32)
        word[:m] = sys[k]
        mask = np.zeros(rows, dtype=np.uint32)
        piv = {}
        for j in range(min(32, n - 32 * k)):
            if found >= rank:
                break
            bit = np.uint32(1 << j)
            has = (word & bit) != 0
            cand = (has & ~used).reshape(32, kR)  # lane l: rows l*kR + i
            lanes = np.flatnonzero(cand.any(axis=1))
            if lanes.size == 0:
                continue  # no candidate row
            src = lanes[0]
            p = src * kR + np.flatnonzero(cand[src])[0]
            others = has.copy()
            others[p] = False
            mp = mask[p] ^ bit
            word[others] ^= word[p]
            mask[others] ^= mp
            used[p] = True
            pivcol[p] = 32 * k + j
            piv[j] = p
            found += 1
        walk.append(sorted((32 * k + j, p) for j, p in piv.items()))
        old = sys[k + 1:].copy()  # the pivot rows as at the panel's start
        for j, p in piv.items():
            takes = ((mask[:m] >> np.uint32(j)) & 1).astype(bool)
            sys[k + 1:, takes] ^= old[:, p][:, None]
    return (sys[w] & 1).astype(bool), used[:m], pivcol[:m], walk


def packed_system(h, syn, rel):
    """The JAX package's packing of each lane's ordered system, ``(B, w+1,
    m)`` int32, and the lanes' orders."""
    m, n = h.shape
    order = np.argsort(rel, axis=0, kind="stable").T.astype(np.int32)
    h_ord = np.take(h, order, axis=1).transpose(1, 0, 2)     # (B, m, n)
    words = np.asarray(_pack_rows_words(jnp.asarray(h_ord), n))
    packed = np.ascontiguousarray(np.concatenate(
        [words, syn.T[:, :, None]], axis=2).transpose(0, 2, 1))
    return packed, order


def check_against_plain_and_jax(h, syn, rel):
    """The model vs the plain walk and JAX's kernel, lane by lane; returns
    the model's walks."""
    m, n = h.shape
    rank = _gf2_rank(h)
    packed, order = packed_system(h, syn, rel)
    kR = osd0_cuda.plan(m, n, H100_SMEM).rows_per_lane
    plain = osd0_cuda.osd0_eliminate(torch.from_numpy(packed), m, n, rank)
    jax_out = osd0_eliminate_pallas(jnp.asarray(packed), m, n, rank,
                                    tile_batch=packed.shape[0], interpret=True)
    walks = []
    for b in range(packed.shape[0]):
        s_final, used, pivcol, walk = panel_walk(packed[b].view(np.uint32),
                                                 m, n, rank, kR)
        for got, p, j in zip((s_final, used, pivcol), plain, jax_out):
            np.testing.assert_array_equal(got, p[b].numpy())
            np.testing.assert_array_equal(got, np.asarray(j)[b])
        walks.append(walk)
    # the fused plain version packs the same system from H's columns
    hcols = torch.from_numpy(osd0_cuda.pack_columns(h))
    system = osd0_cuda.ordered_system(hcols, torch.from_numpy(syn),
                                      torch.from_numpy(order), m, n)
    np.testing.assert_array_equal(system.numpy(), packed)
    return walks, rank


def last_pivot(walk):
    return max((c for panel in walk for c, _ in panel), default=-1)


@pytest.mark.parametrize("name", list(osd0_cases.CASES))
def test_panel_walk_matches_plain_and_jax(name):
    h, syn, rel = osd0_cases.case(name)
    walks, rank = check_against_plain_and_jax(h, syn, rel)
    m, n = h.shape
    pivots = [c for walk in walks for panel in walk for c, _ in panel]
    if name == "ragged":
        assert n % 32 and m % 32
    if name == "rank-deficient":
        assert rank < m and all(
            sum(len(p) for p in walk) == rank for walk in walks)
    if name == "empty-columns":
        empty = set(np.flatnonzero(~h.any(axis=0)))
        order = np.argsort(rel, axis=0, kind="stable").T
        # the walk passed over columns with no candidate: no pivot there
        assert any(order[b, c] in empty for b in range(len(walks))
                   for c in range(last_pivot(walks[b])))
        assert not any(order[b, c] in empty for b, walk in enumerate(walks)
                       for panel in walk for c, _ in panel)
    if name == "dense":
        # pivots on both sides of the border at column 32, and rank reached
        # in mid-panel: the last pivot is neither a panel's last column nor n's
        assert 31 in pivots and 32 in pivots
        assert all(last_pivot(walk) % 32 != 31 and last_pivot(walk) < n - 1
                   for walk in walks)
    if name == "zero-syndrome":
        assert not syn.any()


MATRICES = {"42-x": lambda: construct_code(3, 3, 6, 7, 2, 3).pcm_x,
            "610-z": lambda: construct_code(4, 5, 10, 61, 9, 49).pcm_z,
            "gross-x": lambda: jax_known_bicycle_code("[[144,12,12]]").pcm_x}


@pytest.mark.parametrize("name", list(MATRICES))
def test_panel_walk_on_real_matrices(name):
    """Real parity-check matrices, decodable and random syndromes: the
    walk ends at rank pivots, many panels in."""
    h = np.asarray(MATRICES[name](), dtype=np.int32) % 2
    m, n = h.shape
    rng = np.random.default_rng(len(name))
    lanes = 6
    e = (rng.random((n, lanes)) < 0.06).astype(np.int32)
    syn = (h @ e) % 2
    syn[:, -2:] = rng.integers(0, 2, (m, 2))
    rel = rng.standard_normal((n, lanes)).astype(np.float32)
    walks, rank = check_against_plain_and_jax(h, syn.astype(np.int32), rel)
    assert all(sum(len(p) for p in walk) == rank for walk in walks)
