"""Frozen copy of the program's random-stream rule, and the error models.

The program draws chunk ``c`` of a run seeded ``seed`` from a
``torch.Generator`` on the device, seeded from NumPy's ``SeedSequence`` of
the integers (seed, c): two 32-bit words of its state, low word first, make
the 64-bit seed.  Relay retry ``r`` of graph ``k`` (0 for X, 1 for Z) draws
its damping from the generator of (seed, c, RELAY_STREAM, k, r).  The
benchmark draws the same streams again here, so the reference decodes the
very errors the program decoded without taking them from the program.

Error models (the reference's): weight-W draws W uniform qubit indices, then
W uniform types in {x=0, y=1, z=2}; x|y sets the X bit, z|y the Z bit, and a
repeated index ORs its bits.  Depolarizing: each qubit errs with probability
p, with a uniform type.
"""

from __future__ import annotations

import numpy as np
import torch

#: the relay stream's tag ("RELA")
RELAY_STREAM = 0x52454C41
#: relay's damping range, gamma ~ U[GAMMA_LOW, GAMMA_HIGH)
GAMMA_LOW = 0.05
GAMMA_HIGH = 1.0


def generator(entropy, device) -> torch.Generator:
    state = np.random.SeedSequence([int(e) for e in entropy]).generate_state(
        2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]) | (int(state[1]) << 32))
    return g


def derived_seed(*entropy: int) -> int:
    """A 63-bit seed from integers (the benchmark's own rule, for sweep
    points)."""
    state = np.random.SeedSequence([int(e) for e in entropy]).generate_state(
        2, np.uint32)
    return (int(state[0]) | (int(state[1]) << 32)) & ((1 << 63) - 1)


def errors(traffic: dict, n: int, seed: int, chunk: int, batch: int, device):
    """(x, z) error bits, each (n, batch) uint8, of chunk ``chunk``."""
    g = generator([seed, chunk], device)
    if traffic["error_model"] == "weight":
        w = traffic["weight"]
        idx = torch.randint(0, n, (w, batch), generator=g, device=device)
        typ = torch.randint(0, 3, (w, batch), generator=g, device=device)
        x = torch.zeros((n, batch), dtype=torch.uint8, device=device)
        z = torch.zeros((n, batch), dtype=torch.uint8, device=device)
        lanes = torch.arange(batch, device=device).expand(w, batch)
        x[idx[typ <= 1], lanes[typ <= 1]] = 1
        z[idx[typ >= 1], lanes[typ >= 1]] = 1
        return x, z
    if traffic["error_model"] == "depolarizing":
        err = torch.rand((n, batch), generator=g, device=device) < traffic["p"]
        typ = torch.randint(0, 3, (n, batch), generator=g, device=device)
        return ((err & (typ <= 1)).to(torch.uint8),
                (err & (typ >= 1)).to(torch.uint8))
    raise ValueError(f"unknown error model {traffic['error_model']!r}")


def gammas(seed: int, chunk: int, k: int, r: int, n: int, batch: int, device
           ) -> torch.Tensor:
    """Retry ``r`` of graph ``k``'s (n, batch) float32 damping draw."""
    g = generator([seed, chunk, RELAY_STREAM, k, r], device)
    u = torch.rand((n, batch), generator=g, device=device, dtype=torch.float32)
    return u * (GAMMA_HIGH - GAMMA_LOW) + GAMMA_LOW
