"""Build the port's CUDA sources into shared libraries and load them.

Each library is compiled by ``nvcc`` at first use, for Hopper (``sm_90a``),
into ``qec_ldpc_tpu_torch/_build/`` (listed in ``.gitignore``), with a plain
C interface that :mod:`ctypes` loads — no PyTorch headers, so a build takes
seconds.  The file name carries a hash of the sources, the headers they
share (``csrc/*.cuh``) and the flags, so an edit to any of them rebuilds and
a stale library is never loaded.

Flags that matter for numerics: ``--fmad=false`` stops nvcc from contracting
``a*b + c`` into fused multiply-adds the reference does not do (the kernels
write the one contraction it does do explicitly), and there is no
``--use_fast_math``: it flushes denormals to zero, and leave-one-out
products of a few small probabilities reach float32 denormals.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from qec_ldpc_tpu_torch import tracing

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "--fmad=false", "-Xptxas=-v",
)


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else the toolkit's default location."""
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (neither on PATH nor /usr/local/cuda/bin): the "
            "CUDA kernels of qec_ldpc_tpu_torch need the CUDA toolkit")
    return nvcc


def library_path(name: str, sources: tuple[str, ...]) -> Path:
    """Where the library built from ``sources`` (names under csrc/) lives."""
    h = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    headers = sorted(p.name for p in CSRC_DIR.glob("*.cuh"))
    for src in (*sources, *headers):
        h.update(src.encode() + b"\0" + (CSRC_DIR / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, sources: tuple[str, ...]) -> tuple[Path, str]:
    """Compile ``sources`` into ``lib<name>-<hash>.so`` unless it exists.

    Returns ``(path, log)`` where ``log`` is nvcc's output of this build
    (ptxas register and spill report), or "" when the library was cached.
    Raises ``RuntimeError`` with nvcc's stderr when the compile fails."""
    out = library_path(name, sources)
    if out.exists():
        return out, ""
    tracing.count("kernels.builds")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC_DIR / s) for s in sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {name}:\n"
            f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def load(name: str, sources: tuple[str, ...]) -> ctypes.CDLL:
    """Build the library if needed and load it."""
    with tracing.span("kernels.load"):
        path, _ = build(name, sources)
        return ctypes.CDLL(str(path))
