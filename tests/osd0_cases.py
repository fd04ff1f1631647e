"""Small GF(2) systems that reach the corners of the OSD-0 kernel's panel
walk (csrc/osd0.cu): n and m not multiples of 32, a rank-deficient H,
columns with no candidate, pivots on both sides of a panel border, rank
reached in mid-panel, zero syndromes, more rows than columns and a single
row.  Shared by tests/test_torch_osd0_panels.py (the walk's model against the
plain version and JAX on the CPU) and tests/test_torch_kernel_osd0.py (the
kernel against the plain version on the card).  NumPy only, no JAX: the
card's test run imports it too.
"""

import numpy as np

LANES = 8


def _sparse(rng, m, n, density):
    return (rng.random((m, n)) < density).astype(np.int32)


def _ragged(rng):
    return _sparse(rng, 45, 70, 0.1), {}


def _rank_deficient(rng):
    base = _sparse(rng, 20, 96, 0.15)
    combos = (rng.integers(0, 2, (10, 20)) @ base) % 2
    return np.concatenate([base, combos, base[:10]]).astype(np.int32), {}


def _empty_columns(rng):
    h = _sparse(rng, 37, 80, 0.2)
    empty = rng.choice(80, 20, replace=False)
    h[:, empty] = 0
    # most reliable ... least: the empty columns first in half the lanes
    return h, {"first": empty}


def _dense(rng):
    return _sparse(rng, 40, 100, 0.5), {}


def _zero_syndrome(rng):
    return _sparse(rng, 77, 130, 0.1), {"zero_syndrome": True}


def _tall(rng):
    return _sparse(rng, 300, 64, 0.05), {}


def _single_row(rng):
    return np.array([[0, 1, 1, 0, 1]], dtype=np.int32), {}


CASES = {
    "ragged": _ragged,
    "rank-deficient": _rank_deficient,
    "empty-columns": _empty_columns,
    "dense": _dense,
    "zero-syndrome": _zero_syndrome,
    "tall": _tall,
    "single-row": _single_row,
}


def case(name: str, seed: int = 0):
    """``(h (m, n) int32, syndromes (m, LANES) int32, reliabilities (n,
    LANES) float32)``: syndromes of sparse errors (decodable) in the first
    half of the lanes and random ones (mostly not) in the rest, or zeros;
    standard-normal reliabilities, with the case's planted columns made the
    most likely in error in every other lane."""
    rng = np.random.default_rng(seed + sum(map(ord, name)))
    h, extra = CASES[name](rng)
    m, n = h.shape
    e = (rng.random((n, LANES)) < 0.05).astype(np.int32)
    syn = (h @ e) % 2
    syn[:, LANES // 2:] = rng.integers(0, 2, (m, LANES - LANES // 2))
    if extra.get("zero_syndrome"):
        syn[:] = 0
    rel = rng.standard_normal((n, LANES)).astype(np.float32)
    if "first" in extra:
        rel[extra["first"], ::2] = -10.0 - rng.random((len(extra["first"]), 1))
    return h, syn.astype(np.int32), rel
