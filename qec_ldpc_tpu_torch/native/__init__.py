"""ctypes bindings for the host GF(2) library (``gf2.cpp``).

The port's copy of ``qec_ldpc_tpu/native``: the same C++ source, built by
``g++`` at first use with OpenMP and ``-march=native`` into
``qec_ldpc_tpu_torch/_build/`` (listed in ``.gitignore``).  The library's
file name carries a tag of the host's ISA (a library built with
``-march=native`` and carried to a host without those instructions would
load and then die of SIGILL at call time, which cannot be caught) and a
hash of the source and flags, so a foreign or stale library is never
loaded.

There is no NumPy fallback: if the library cannot be built, the call that
needs it raises.  The OSD solver's plain single-lane version,
``decoder/osd._osd_one_np``, exists for the tests only.

Bit packing convention: row-major, little-endian bit order within 64-bit
words (numpy ``packbits(bitorder="little")`` viewed as uint64).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "gf2.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
COMPILER = "g++"
# -march=native lets the word-wide XOR/popcount loops vectorize to the host's
# SIMD width; OpenMP runs the OSD lanes in parallel
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-fopenmp", "-march=native")


def host_tag() -> str:
    """Short hash of this host's ISA surface (machine and CPU flags)."""
    ident = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith(("flags", "features")):
                    ident += "|" + line.split(":", 1)[-1].strip()
                    break
    except OSError:
        ident += "|" + platform.processor()
    return hashlib.sha256(ident.encode()).hexdigest()[:12]


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    """Where the library for this host, source and flags lives."""
    h = hashlib.sha256("\0".join(FLAGS).encode() + b"\0" + SOURCE.read_bytes())
    return Path(build_dir) / f"libgf2-{host_tag()}-{h.hexdigest()[:12]}.so"


@functools.lru_cache(maxsize=None)
def library(build_dir: Path = BUILD_DIR, compiler: str = COMPILER) -> ctypes.CDLL:
    """Build the library with ``compiler`` unless it exists, load it and
    declare the C signatures.  Raises ``RuntimeError`` if the build fails."""
    path = library_path(build_dir)
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *FLAGS, "-o", str(tmp), str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.SubprocessError) as exc:
            raise RuntimeError(f"cannot build the GF(2) library: "
                               f"{' '.join(cmd)}: {exc}") from exc
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{compiler} failed ({proc.returncode}) "
                               f"building {SOURCE.name}:\n{proc.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    lib.qec_osd_batch.restype = ctypes.c_int
    lib.qec_osd_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8)]
    lib.qec_gf2_matvec.restype = None
    lib.qec_gf2_matvec.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8)]
    return lib


def pack_rows(m: np.ndarray) -> tuple[np.ndarray, int]:
    """(rows, cols) 0/1 matrix -> (rows, words) uint64 packed, plus words."""
    m = np.ascontiguousarray(np.asarray(m, dtype=np.uint8) % 2)
    rows, cols = m.shape
    words = max(1, -(-cols // 64))
    packed_bytes = np.packbits(m, axis=1, bitorder="little")
    pad = words * 8 - packed_bytes.shape[1]
    if pad:
        packed_bytes = np.pad(packed_bytes, ((0, 0), (0, pad)))
    return (np.ascontiguousarray(packed_bytes).view(np.uint64)
            .reshape(rows, words), words)


def unpack_rows(packed: np.ndarray, cols: int) -> np.ndarray:
    """(rows, words) uint64 -> (rows, cols) uint8 0/1 matrix."""
    rows = packed.shape[0]
    if rows == 0:
        return np.zeros((0, cols), dtype=np.uint8)
    as_bytes = np.ascontiguousarray(packed).view(np.uint8).reshape(rows, -1)
    bits = np.unpackbits(as_bytes, axis=1, bitorder="little")
    return bits[:, :cols]


def gf2_matvec(m: np.ndarray, vecs: np.ndarray) -> np.ndarray:
    """Batched mod-2 matvec on packed rows (``qec_gf2_matvec``): the 0/1
    matrix (rows, cols) times the 0/1 vectors (batch, cols) -> (rows, batch)
    uint8."""
    if np.shape(m)[1] != np.shape(vecs)[1]:
        raise ValueError(f"matrix {np.shape(m)} and vectors {np.shape(vecs)} "
                         f"differ in columns")
    lib = library()
    pm, words = pack_rows(m)
    pv, _ = pack_rows(vecs)
    rows, batch = pm.shape[0], pv.shape[0]
    out = np.zeros((rows, batch), dtype=np.uint8)
    lib.qec_gf2_matvec(
        pm.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), rows, words,
        pv.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), batch,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


def osd_batch(
    packed_cols: np.ndarray,   # (n, w) uint64 packed columns of H (m rows)
    m: int,
    order: np.ndarray,         # (batch, n) int32, most-likely-error first
    packed_syn: np.ndarray,    # (batch, w) uint64 packed syndromes
    lam: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Batched OSD solve (``qec_osd_batch``, OpenMP over lanes): returns
    ((batch, n) uint8 corrections, (batch,) bool solved)."""
    lib = library()
    n, w = packed_cols.shape
    batch = packed_syn.shape[0]
    packed_cols = np.ascontiguousarray(packed_cols, dtype=np.uint64)
    order = np.ascontiguousarray(order, dtype=np.int32)
    packed_syn = np.ascontiguousarray(packed_syn, dtype=np.uint64)
    if order.shape != (batch, n) or packed_syn.shape != (batch, w):
        raise ValueError(f"order {order.shape} / syndromes {packed_syn.shape} "
                         f"do not match ({batch}, {n}) / ({batch}, {w})")
    if lam < 0:
        raise ValueError(f"lam={lam}")
    e_out = np.zeros((batch, n), dtype=np.uint8)
    status = np.zeros(batch, dtype=np.uint8)
    lib.qec_osd_batch(
        packed_cols.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        m, n, w,
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        packed_syn.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        batch, lam,
        e_out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return e_out, status == 0
