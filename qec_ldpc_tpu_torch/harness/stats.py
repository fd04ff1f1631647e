"""Run-statistics record with reference-exact text serialization.

The port of ``qec_ldpc_tpu/harness/stats.py``: the reference's
``CodeStatistics`` fields and ``operator<<`` text layout, byte for byte, so
result files of both packages diff cleanly against each other and against
the reference's golden corpus.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

from qec_ldpc_tpu_torch.codes import QuantumLDPCCode
from qec_ldpc_tpu_torch.sampling.classify import (
    C_CONV_X, C_CONV_Z, C_CORRECTED, C_LOGICAL, C_SYN_X, C_SYN_Z,
    C_TESTED, C_X_TESTED, C_Z_TESTED,
)


@dataclasses.dataclass
class CodeStatistics:
    code_str: str
    rand_seed: int
    num_errors_tested: int
    num_x_errors_tested: int
    num_z_errors_tested: int
    error_weight: int
    corrected: int
    syndrome_errors_x: int
    syndrome_errors_z: int
    logical_errors: int
    convergence_fail_x: int
    convergence_fail_z: int
    duration_micro_seconds: int
    #: framework extensions (not in the reference record)
    total_bp_iterations: int = 0
    num_devices: int = 1

    @staticmethod
    def from_counters(code: QuantumLDPCCode, seed: int, weight: int,
                      counters: np.ndarray, duration_us: int,
                      total_bp_iterations: int = 0,
                      num_devices: int = 1) -> "CodeStatistics":
        c = np.asarray(counters, dtype=np.int64)
        return CodeStatistics(
            code_str=str(code), rand_seed=int(seed),
            num_errors_tested=int(c[C_TESTED]),
            num_x_errors_tested=int(c[C_X_TESTED]),
            num_z_errors_tested=int(c[C_Z_TESTED]),
            error_weight=int(weight),
            corrected=int(c[C_CORRECTED]),
            syndrome_errors_x=int(c[C_SYN_X]),
            syndrome_errors_z=int(c[C_SYN_Z]),
            logical_errors=int(c[C_LOGICAL]),
            convergence_fail_x=int(c[C_CONV_X]),
            convergence_fail_z=int(c[C_CONV_Z]),
            duration_micro_seconds=int(duration_us),
            total_bp_iterations=int(total_bp_iterations),
            num_devices=int(num_devices),
        )

    def to_reference_text(self) -> str:
        """Exact operator<< format (CodeStatistics.h:22-37)."""
        return (
            f"Code: {self.code_str}\n"
            f"Rand Seed: {self.rand_seed}\n"
            f"Duration(micro-s): {self.duration_micro_seconds}\n"
            f"Errors Tested: {self.num_errors_tested}\n"
            f"Errors With X: {self.num_x_errors_tested}\n"
            f"Errors With Z: {self.num_z_errors_tested}\n"
            f"Error Weight: {self.error_weight}\n"
            f"Corrected: {self.corrected}\n"
            f"Syndrome Errors X: {self.syndrome_errors_x}\n"
            f"Syndrome Errors Z: {self.syndrome_errors_z}\n"
            f"Logical Errors: {self.logical_errors}\n"
            f"Convergence Fail X: {self.convergence_fail_x}\n"
            f"Convergence Fail Z: {self.convergence_fail_z}\n"
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def samples_per_second(self) -> float:
        if self.duration_micro_seconds == 0:
            return float("inf")
        return self.num_errors_tested / (self.duration_micro_seconds * 1e-6)


#: the entry :func:`parse_reference_text` adds to a record whose ``Logical
#: Errors`` it derived from the split X and Z lines
DERIVED_MARKER = ("Logical Errors derived", "X+Z")


def parse_reference_text(text: str) -> dict:
    """Parse a reference results file (one or more CodeStatistics dumps) into
    a list of field dicts — used by the golden-corpus parity tests.

    Handles BOTH serialization generations in the corpus:

    * the final format (``CodeStatistics.h:22-37``): ``Errors With X/Z``
      lines and one unified ``Logical Errors`` counter;
    * the 2017 dated-directory format (``results/11-18-2017_*/``,
      ``11-20-2017_max_*/``): no ``Errors With X/Z``, a ``Code:`` value
      prefixed ``code: J=..,sigma=..,tau=..``, and — in the pre-detection
      ``11-18`` files only — split ``Logical Errors X/Z`` lines.

    The key/value structure is shared, so records keep their raw keys;
    old-format records additionally get a derived ``Logical Errors`` entry
    (the X+Z sum) when only the split lines exist, marked by
    ``DERIVED_MARKER`` (``"Logical Errors derived": "X+Z"``), and consumers
    can detect the old format by the absence of ``Errors With X``.  Use
    :func:`parse_code_params` to read the code parameters from either
    ``Code:`` form.
    """
    records = []
    current: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            if current:
                records.append(current)
                current = {}
            continue
        if ":" not in line:
            continue
        key, val = line.split(":", 1)
        current[key.strip()] = val.strip()
    if current:
        records.append(current)
    for rec in records:
        # the derived X+Z sum counts a sample with both an X and a Z logical
        # error twice; its value is the JAX parser's, so the two agree on
        # every key they share, and the marker says it was not read
        if "Logical Errors" not in rec and "Logical Errors X" in rec:
            rec["Logical Errors"] = str(
                int(rec["Logical Errors X"])
                + int(rec.get("Logical Errors Z", 0)))
            rec.update([DERIVED_MARKER])
    return records


#: both Code-string generations: "[J=3,K=3,L=6,P=7,s=2,t=3][[n=42,k=0]]"
#: (Quantum_LDPC_Code.h:145-150) and the older
#: "code: J=2,K=3,L=6,P=7,sigma=2,tau=3 [[n=42,k=7]]"
_CODE_PARAMS_RE = re.compile(
    r"J=(\d+),\s*K=(\d+),\s*L=(\d+),\s*P=(\d+),"
    r"\s*s(?:igma)?=(\d+),\s*t(?:au)?=(\d+)")


def parse_code_params(code_str: str):
    """(J, K, L, P, sigma, tau) from either generation of the reference's
    code pretty-printer, or None if the string matches neither."""
    m = _CODE_PARAMS_RE.search(code_str)
    if not m:
        return None
    return tuple(int(g) for g in m.groups())
