"""Relay's damping draws (decoder/relay.py ``RelayDraws``) in the port: a
generator per graph and retry, drawn over the full batch.

* A decode of some columns of a batch draws exactly the full draw's
  columns, so it repairs those lanes as the full decode does (the property
  that makes the quality mode's relay counters independent of the data
  mesh; ``test_torch_cli_mesh.py`` holds them on a gloo world).
* The Z retries' gammas, decisions and flags do not depend on how many
  retries the X graph ran.
"""

import numpy as np
import pytest
import torch

from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.decoder import BPConfig, CodeGraphs
from qec_ldpc_tpu_torch.decoder.decode import (
    CONVERGENCE_FAIL_Z,
    SYNDROME_FAIL_X,
    SYNDROME_FAIL_Z,
)
from qec_ldpc_tpu_torch.decoder.relay import RelayDraws, relay_decode_batch
from qec_ldpc_tpu_torch.parallel.chunk import chunk_generator, sample_syndromes

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

P_ERR = 0.02
CFG = BPConfig(max_iters=15, algorithm="min-sum")


class RecordingDraws(RelayDraws):
    """RelayDraws that keeps every (graph, retry, gammas) it hands out."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.drawn = []

    def gammas(self, k, *args, **kw):
        draw = super().gammas(k, *args, **kw)

        def recorded(r):
            g = draw(r)
            self.drawn.append((k, r, g))
            return g
        return recorded


@pytest.fixture(scope="module")
def batch():
    graphs = CodeGraphs.build(construct_code(3, 3, 6, 7, 2, 3))
    _, _, sx, sz = sample_syndromes(graphs, chunk_generator(3, 0, "cpu"), 5,
                                    P_ERR, 64, "weight")
    return graphs, sx, sz


@pytest.mark.parametrize("k", [0, 1])
@pytest.mark.parametrize("offset", [0, 24, 40])
def test_columns_are_the_full_draws(k, offset):
    full = RelayDraws([4, 1], "cpu").gammas(k, 42, 64)
    part = RelayDraws([4, 1], "cpu", width=64, offset=offset).gammas(k, 42, 24)
    for r in range(3):
        assert torch.equal(part(r), full(r)[:, offset:offset + 24])
        assert bool((part(r) >= 0.05).all()) and bool((part(r) < 1.0).all())


def test_columns_outside_the_draw_are_refused():
    with pytest.raises(ValueError, match="outside"):
        RelayDraws([1], "cpu", width=64, offset=48).gammas(0, 42, 32)


@pytest.mark.parametrize("lo", [0, 32])
def test_a_column_slice_repairs_as_the_full_decode(batch, lo):
    graphs, sx, sz = batch
    full, rx, rz = relay_decode_batch(graphs, sx, sz, P_ERR,
                                      RelayDraws([5], "cpu"), CFG, retries=6)
    assert rx > 0 and rz > 0
    part, _, _ = relay_decode_batch(
        graphs, sx[:, lo:lo + 32], sz[:, lo:lo + 32], P_ERR,
        RelayDraws([5], "cpu", width=64, offset=lo), CFG, retries=6)
    for f in ("decisions_x", "decisions_z", "error_code"):
        assert torch.equal(getattr(part, f), getattr(full, f)[..., lo:lo + 32]), f


def test_z_draws_do_not_depend_on_the_x_retries(batch):
    graphs, sx, sz = batch
    runs = []
    for syn_x in (sx, torch.zeros_like(sx)):
        draws = RecordingDraws([6], "cpu")
        res, rx, rz = relay_decode_batch(graphs, syn_x, sz, P_ERR, draws,
                                         CFG, retries=6)
        runs.append((res, rx, rz, draws.drawn))
    (a, ax, az, drawn_a), (b, bx, bz, drawn_b) = runs
    assert ax > 0 and bx == 0 and az == bz > 0
    z_a = [(r, g) for k, r, g in drawn_a if k == 1]
    z_b = [(r, g) for k, r, g in drawn_b if k == 1]
    assert len(z_a) == az and [r for r, _ in z_a] == [r for r, _ in z_b]
    assert all(torch.equal(g, h) for (_, g), (_, h) in zip(z_a, z_b))
    assert torch.equal(a.decisions_z, b.decisions_z)
    z_bits = SYNDROME_FAIL_Z | CONVERGENCE_FAIL_Z
    assert torch.equal(a.error_code & z_bits, b.error_code & z_bits)
    assert bool(((b.error_code & SYNDROME_FAIL_X) == 0).all())
    assert np.any((a.error_code & SYNDROME_FAIL_Z).numpy() == 0)
