"""The JAX package's random stream, drawn in PyTorch: ``jax.random``'s
threefry-2x32 keys and its weight-W sampler, bit for bit.

The JAX package's corpus scripts draw chunk c of a point from
``fold_in(PRNGKey(seed), c)`` with ``sample_weight_w_errors_dynamic``
(``qec_ldpc_tpu/sampling/errors.py``).  This module reproduces those
draws on any device (JAX's partitionable threefry, its default since JAX
0.5: ``split`` and ``random_bits`` hash a 64-bit iota; ``randint`` takes
two 32-bit words a value and reduces them modulo the span), so the port's
decoder, which is JAX's decoder bit for bit on IEEE arithmetic, can decode
the very samples behind a JAX record: what JAX's own script gives on an
IEEE device, for ``golden_*.py --stream jax``.  Words are uint32 values
held in int64 tensors; keys are pairs of Python ints.
"""

from __future__ import annotations

import torch

from qec_ldpc_tpu_torch.sampling.errors import _accumulate_hits

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the word pairs (x0, x1) under
    ``key`` (``jax._src.prng._threefry2x32_lowering``): Python ints or
    int64 tensors that broadcast, each word in [0, 2^32)."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2^32."""
    if not 0 <= seed <= _M32:
        raise ValueError(f"seed {seed} outside [0, 2^32)")
    return 0, seed


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)``, data a uint32."""
    return threefry2x32(key, 0, data & _M32)


def split(key: tuple[int, int]) -> list[tuple[int, int]]:
    """``jax.random.split(key)``: two keys."""
    return [threefry2x32(key, 0, 0), threefry2x32(key, 0, 1)]


def _words(keys: list, shape, device) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` for each key of ``keys``, in
    one hash over (len(keys), *shape) words, as int64."""
    count = 1
    for d in shape:
        count *= d
    if count > _M32:
        raise ValueError("at most 2^32 words a key")
    k = torch.tensor(keys, dtype=torch.int64, device=device)
    lo = torch.arange(count, dtype=torch.int64, device=device)[None, :]
    b0, b1 = threefry2x32((k[:, :1], k[:, 1:]), torch.zeros_like(lo), lo)
    return (b0 ^ b1).reshape(len(keys), *shape)


def _reduce(higher: torch.Tensor, lower: torch.Tensor, high: int):
    """``randint``'s reduction of two words to [0, high) (high < 2^16, so
    no product leaves 32 bits)."""
    multiplier = (2 ** 16 % high) ** 2 % high
    return ((higher % high) * multiplier + lower % high) % high


def randint(key: tuple[int, int], shape, high: int, device) -> torch.Tensor:
    """``jax.random.randint(key, shape, 0, high)`` for int32, as int64."""
    higher, lower = _words(split(key), shape, device)
    return _reduce(higher, lower, high)


def sample_weight_w_errors_dynamic(key: tuple[int, int], n: int, weight: int,
                                   w_max: int, batch: int, device):
    """The JAX package's ``sample_weight_w_errors_dynamic(key, n, weight,
    w_max, batch)``: (x_errors, z_errors), each (n, batch) int8.  Like it,
    a ``weight`` above ``w_max`` draws ``w_max`` errors."""
    k_idx, k_typ = split(key)
    words = _words(split(k_idx) + split(k_typ), (w_max, batch), device)
    idx = _reduce(words[0], words[1], n)
    typ = _reduce(words[2], words[3], 3)
    active = torch.arange(w_max, device=device) < weight
    return _accumulate_hits(idx, typ, n, active)
