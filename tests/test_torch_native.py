"""The port's host GF(2) bindings (``qec_ldpc_tpu_torch.native``) against
the JAX package's (``qec_ldpc_tpu.native``): the same C++ source, so the
same results on the same random matrices and the same int file; the port
raises where JAX returns None."""

import numpy as np
import pytest

from qec_ldpc_tpu import native as jax_native
from qec_ldpc_tpu_torch import native


@pytest.fixture(scope="module")
def have_both():
    if not jax_native.native_available():
        pytest.skip("the JAX package's native library is unavailable")
    assert native.native_available()


@pytest.mark.parametrize("rows,cols", [(1, 1), (7, 5), (30, 64), (65, 130),
                                       (40, 200), (0, 3)])
def test_rref_matches_jax(have_both, rows, cols):
    rng = np.random.default_rng(rows * 1000 + cols)
    for _ in range(3):
        m = rng.integers(0, 2, (rows, cols), dtype=np.uint8)
        got_rows, got_piv = native.gf2_rref(m)
        want_rows, want_piv = jax_native.gf2_rref(m)
        assert got_piv == want_piv
        assert np.array_equal(got_rows, want_rows)


def test_parse_int_file_matches_jax(have_both, tmp_path):
    p = tmp_path / "ints.txt"
    p.write_text("3 3 6 7 2 3\n0 1 0\n  42\t-7\nx 12y13\n")
    for max_count in (64, 5):
        got = native.parse_int_file(str(p), max_count)
        want = jax_native.parse_int_file(str(p), max_count)
        assert got.dtype == want.dtype == np.int64
        assert np.array_equal(got, want)
    assert native.parse_int_file(str(p), 64).tolist() == [
        3, 3, 6, 7, 2, 3, 0, 1, 0, 42, -7, 12, 13]


def test_parse_int_file_raises_on_a_missing_file(have_both, tmp_path):
    with pytest.raises(FileNotFoundError):
        native.parse_int_file(str(tmp_path / "absent.txt"), 4)
    with pytest.raises(FileNotFoundError):
        jax_native.parse_int_file(str(tmp_path / "absent.txt"), 4)


def test_unavailable_library_raises(monkeypatch):
    """Without a compiler the port reports the library unavailable and its
    bindings raise (JAX's return None)."""
    def no_library():
        raise RuntimeError("cannot build the GF(2) library")

    monkeypatch.setattr(native, "library", no_library)
    assert native.native_available() is False
    with pytest.raises(RuntimeError):
        native.gf2_rref(np.eye(3, dtype=np.uint8))
    with pytest.raises(RuntimeError):
        native.parse_int_file("ints.txt", 4)
