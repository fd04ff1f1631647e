"""``sampling/classify.py::classify_batch_np``, the host mirror of
``classify_batch``: the same counters as JAX's ``classify_batch_np`` and as
the port's ``classify_batch`` on the same arrays, for a dense ``iMinusP``
and a rank-basis test, on a QC-CSS code and a bivariate bicycle code; and
the host library's ``gf2_matvec`` against NumPy."""

import numpy as np
import pytest
import torch

from qec_ldpc_tpu.codes import construct_code as jax_construct_code
from qec_ldpc_tpu.codes import known_bicycle_code as jax_known_bicycle_code
from qec_ldpc_tpu.sampling.classify import (
    classify_batch_np as jax_classify_batch_np,
    make_rank_basis_test as jax_make_rank_basis_test,
)
from qec_ldpc_tpu_torch import native
from qec_ldpc_tpu_torch.codes import construct_code, known_bicycle_code
from qec_ldpc_tpu_torch.sampling import (
    classify_batch,
    classify_batch_np,
    make_rank_basis_test,
)

CODES = {"42": (lambda: construct_code(3, 3, 6, 7, 2, 3),
                lambda: jax_construct_code(3, 3, 6, 7, 2, 3)),
         "bb72": (lambda: known_bicycle_code("[[72,12,6]]"),
                  lambda: jax_known_bicycle_code("[[72,12,6]]"))}


def arrays(n, batch=96, seed=0):
    """Errors, decisions that undo some of them, and every error code."""
    rng = np.random.default_rng(seed)
    xe, ze = (rng.integers(0, 2, (n, batch)) * (rng.random((n, batch)) < 0.05)
              for _ in range(2))
    keep = rng.random(batch) < 0.5
    dx = np.where(keep, xe, rng.integers(0, 2, (n, batch)) * (
        rng.random((n, batch)) < 0.03))
    dz = np.where(keep, ze, 0)
    code = rng.integers(0, 16, batch)
    return [a.astype(np.int32) for a in (xe, ze, dx, dz, code)]


@pytest.mark.parametrize("test_kind", ["dense", "basis"])
@pytest.mark.parametrize("name", sorted(CODES))
def test_equals_jax_and_the_device_classify(name, test_kind):
    code, jax_code = (make() for make in CODES[name])
    xe, ze, dx, dz, ec = arrays(code.n)
    if test_kind == "dense":
        port_test, jax_test = code.i_minus_p, jax_code.i_minus_p
        torch_test = torch.as_tensor(code.i_minus_p)
    else:
        port_test = torch_test = make_rank_basis_test(code, "cpu")
        jax_test = jax_make_rank_basis_test(jax_code)
    got = classify_batch_np(port_test, xe, ze, dx, dz, ec)
    assert got.dtype == np.int64
    want = jax_classify_batch_np(jax_test, xe, ze, dx, dz, ec)
    np.testing.assert_array_equal(got, np.asarray(want))
    device = classify_batch(torch_test, *(torch.from_numpy(a) for a in
                                          (xe, ze, dx, dz, ec)))
    np.testing.assert_array_equal(got, device.numpy())
    # tensors are taken too
    np.testing.assert_array_equal(
        classify_batch_np(port_test, *(torch.from_numpy(a) for a in
                                       (xe, ze, dx, dz, ec))), got)


def test_gf2_matvec_equals_numpy():
    rng = np.random.default_rng(5)
    m = rng.integers(0, 2, (37, 130))
    v = rng.integers(0, 2, (11, 130))
    np.testing.assert_array_equal(native.gf2_matvec(m, v), (m @ v.T) % 2)
    with pytest.raises(ValueError, match="columns"):
        native.gf2_matvec(m, v[:, :-1])
