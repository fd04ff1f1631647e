"""Random Pauli error generation with explicit ``torch.Generator``s.

Same distributions as ``qec_ldpc_tpu/sampling/errors.py`` (the reference's
weight-W model: W iid draws of a uniform qubit index and a uniform type in
{x=0, y=1, z=2}; x|y sets the X bit, z|y sets the Z bit; a repeated index
ORs its bits in and never clears one, so the effective weight can be < W).
The random streams differ from JAX's: results are compared by distribution,
or by feeding both packages the same draws (:func:`_accumulate_hits`).
"""

from __future__ import annotations

import numpy as np
import torch


def generator_seed(entropy) -> int:
    """The 64-bit seed of the integers ``entropy``, mixed by NumPy's
    SeedSequence: the port's one rule for deriving a random stream (per
    chunk, per relay retry)."""
    state = np.random.SeedSequence(list(entropy)).generate_state(2, np.uint32)
    return int(state[0]) | (int(state[1]) << 32)


def seeded_generator(entropy, device: torch.device | str) -> torch.Generator:
    """A generator on ``device`` seeded from the integers ``entropy`` alone
    (:func:`generator_seed`)."""
    g = torch.Generator(device=device)
    g.manual_seed(generator_seed(entropy))
    return g


def _accumulate_hits(idx: torch.Tensor, typ: torch.Tensor, n: int,
                     active: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(x_errors, z_errors), each (n, batch) int8, from draws idx/typ
    (W, batch).  A scatter with ``amax`` ORs the bits of colliding draws, so
    a later Z draw never clears an earlier X bit on the same qubit.
    ``active``: an optional (W,) bool mask of the draws that count (the
    dynamic sampler); an inactive draw sets no bit."""
    batch = idx.shape[1]
    idx = idx.to(torch.int64)

    def hits(bit: torch.Tensor) -> torch.Tensor:
        if active is not None:
            bit = bit & active[:, None]
        out = torch.zeros((n, batch), dtype=torch.int32, device=idx.device)
        out.scatter_reduce_(0, idx, bit.to(torch.int32), reduce="amax")
        return out.to(torch.int8)

    return hits(typ <= 1), hits(typ >= 1)


def sample_weight_w_errors(
    generator: torch.Generator, n: int, weight: int, batch: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw ``batch`` weight-``weight`` Pauli errors over ``n`` qubits on
    ``generator.device``.  Returns (x_errors, z_errors), each (n, batch)
    int8 in {0, 1}."""
    device = generator.device
    idx = torch.randint(0, n, (weight, batch), generator=generator, device=device)
    typ = torch.randint(0, 3, (weight, batch), generator=generator, device=device)
    return _accumulate_hits(idx, typ, n)


def sample_weight_w_errors_dynamic(
    generator: torch.Generator, n: int, weight: int, w_max: int, batch: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Weight-``weight`` errors drawn as ``w_max`` candidates: ``w_max``
    indices, then ``w_max`` types, of which the first ``weight`` are active.
    The JAX package draws this way so that a whole weight sweep shares one
    compiled program; the port compiles nothing, and keeps the sampler so
    that a sweep draws the same stream as a journal written by it expects
    (``run_monte_carlo(weight_cap=)``).  At ``weight == w_max`` the draws
    equal :func:`sample_weight_w_errors`'s from the same generator state."""
    if not 0 <= weight <= w_max:
        raise ValueError(f"weight {weight} outside [0, w_max={w_max}]")
    device = generator.device
    idx = torch.randint(0, n, (w_max, batch), generator=generator, device=device)
    typ = torch.randint(0, 3, (w_max, batch), generator=generator, device=device)
    active = torch.arange(w_max, device=device) < weight
    return _accumulate_hits(idx, typ, n, active)


def sample_depolarizing_errors(
    generator: torch.Generator, n: int, p: float, batch: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """I.i.d. depolarizing channel on ``generator.device``: each qubit errs
    with probability ``p``; the error type is uniform over {X, Y, Z}."""
    device = generator.device
    err = torch.rand((n, batch), generator=generator, device=device) < p
    typ = torch.randint(0, 3, (n, batch), generator=generator, device=device)
    return ((err & (typ <= 1)).to(torch.int8),
            (err & (typ >= 1)).to(torch.int8))
