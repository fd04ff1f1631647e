"""Numerical validation of the decode path (PyTorch port).

The port of ``qec_ldpc_tpu/decoder/validate.py``.  Probability-domain BP
saturates to exact 0/1 on long runs, after which the posterior evaluates
0/0 -> NaN.  Two tools:

* :func:`checked_decode_batch` runs the plain decode under float checks and
  reports the first violation in program order.  JAX instruments the
  traced program with ``checkify``; torch has none, so a
  ``torch.overrides.TorchFunctionMode`` inspects each torch call as it runs:
  a division whose divisor holds a zero is a division-by-zero error, and an
  arithmetic call whose float output holds a NaN or an infinity is a NaN or
  Inf error.
* :func:`validate_decode_result` checks a decode result's structure on the
  host.

Debug tooling, never the main path: the checks read every float result of
the decode back from its device.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from qec_ldpc_tpu_torch.decoder.decode import (
    SYNDROME_FAIL_X,
    SYNDROME_FAIL_Z,
    CodeGraphs,
    DecodeResult,
    decode_batch,
)
from qec_ldpc_tpu_torch.decoder.sum_product import BPConfig

#: calls whose divisor is the second operand, and the one whose divisor is
#: the first (``x.__rtruediv__(y)`` is ``y / x``)
_DIVISIONS = {"div", "divide", "true_divide", "truediv", "itruediv",
              "floor_divide", "floordiv", "ifloordiv"}
_REVERSED_DIVISIONS = {"rtruediv", "rdiv", "rfloordiv", "reciprocal"}
#: the arithmetic calls that can make a NaN or an infinity (JAX's
#: ``nan_primitives``, by torch name; in-place and reflected forms count)
_ARITHMETIC = _DIVISIONS | _REVERSED_DIVISIONS | {
    "add", "radd", "iadd", "sub", "rsub", "isub", "subtract", "mul", "rmul",
    "imul", "multiply", "matmul", "rmatmul", "mm", "bmm", "addmm", "sum",
    "prod", "cumsum", "cumprod", "mean", "exp", "expm1", "log", "log1p",
    "log2", "log10", "pow", "rpow", "ipow", "sqrt", "rsqrt", "sin", "cos",
    "tan", "tanh", "sinh", "cosh", "asin", "acos", "atan", "atan2",
    "sigmoid", "logsumexp", "remainder", "fmod", "addcmul", "addcdiv"}


class FloatCheckError(ArithmeticError):
    """The first float violation of a checked decode."""


class FloatChecks:
    """The outcome of :func:`checked_decode_batch`, after ``checkify``'s
    error value: :meth:`get` is None or the first violation's message, and
    :meth:`throw` raises it."""

    def __init__(self, message: str | None = None):
        self._message = message

    def get(self) -> str | None:
        return self._message

    def throw(self) -> None:
        if self._message is not None:
            raise FloatCheckError(self._message)


def _name(func) -> str:
    """The call's name without dunder or in-place underscores: ``mul`` for
    ``torch.mul``, ``Tensor.mul_`` and ``Tensor.__mul__``."""
    return getattr(func, "__name__", "").strip("_")


def _holds_zero(x) -> bool:
    if isinstance(x, torch.Tensor):
        return bool((x == 0).any())
    return isinstance(x, (int, float)) and x == 0


class _FloatCheckMode(TorchFunctionMode):
    """Records the first division by zero, NaN or Inf of the torch calls
    made under it (the mode is off inside its own handler, so its checks
    are not checked)."""

    def __init__(self):
        super().__init__()
        self.message: str | None = None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _name(func)
        if self.message is None and name in _DIVISIONS | _REVERSED_DIVISIONS:
            if name in _DIVISIONS:
                divisor = args[1] if len(args) > 1 else kwargs.get("other")
            else:
                divisor = args[0]
            if _holds_zero(divisor):
                self.message = f"division by zero in {name}"
        out = func(*args, **kwargs)
        if (self.message is None and name in _ARITHMETIC
                and isinstance(out, torch.Tensor) and out.is_floating_point()):
            if bool(out.isnan().any()):
                self.message = f"nan generated by {name}"
            elif bool(out.isinf().any()):
                self.message = f"inf generated by {name}"
        return out


def checked_decode_batch(
    graphs: CodeGraphs,
    syndrome_x: torch.Tensor,
    syndrome_z: torch.Tensor,
    error_probability: float,
    cfg: BPConfig = BPConfig(),
) -> tuple[FloatChecks, DecodeResult]:
    """Run the plain ``decode_batch`` on the syndromes' device under float
    checks (a division by zero, a NaN or an infinity in any arithmetic
    call of the decode, inside the BP loop included).

    Returns ``(err, result)``: ``err.get()`` is the first violation in
    program order (None if none), ``err.throw()`` raises it.  The decode is
    the plain one on every device: a CUDA kernel cannot be instrumented,
    and each kernel matches its plain version bit for bit, so numerics
    validated here hold for the kernels.

    Reading a hit: probability-domain sum-product saturates messages to
    exact float32 0/1 within ~8 iterations on easy syndromes, after which
    the leave-one-out posterior (masked and discarded) divides by zero, so
    on healthy long runs the first error is a division in the VN update:
    the known-benign saturation signature (the C++ reference computes the
    same expression, ``DecoderCPU.h:191-226``).  A NaN before saturation,
    an error at small ``max_iters``, or non-finite values in the OUTPUTS
    (:func:`validate_decode_result`) point at real trouble, e.g. a
    degenerate prior (p >= 1 after the 2/3 factor) trips within the first
    iterations.
    """
    mode = _FloatCheckMode()
    with mode:
        res = decode_batch(graphs, syndrome_x, syndrome_z, error_probability,
                           cfg, plain=True)
    return FloatChecks(mode.message), res


def validate_decode_result(
    graphs: CodeGraphs,
    syndrome_x: torch.Tensor,
    syndrome_z: torch.Tensor,
    res: DecodeResult,
) -> list[str]:
    """Structural checks of a decode result on the host.  Returns a list of
    violation descriptions (empty = valid):

    * decisions are 0/1;
    * the SYNDROME_FAIL_X/Z bits agree exactly with re-encoding the
      decisions (the decode's own re-encode, DecoderCPU.h:380-384);
    * soft outputs, when present, are finite.
    """
    problems: list[str] = []
    ec = res.error_code.cpu().numpy()
    for name, d in (("x", res.decisions_x), ("z", res.decisions_z)):
        if not np.isin(d.cpu().numpy(), (0, 1)).all():
            problems.append(f"decisions_{name} not in {{0,1}}")
    for name, bit, graph, syn, d in (
        ("x", SYNDROME_FAIL_X, graphs.x, syndrome_x, res.decisions_x),
        ("z", SYNDROME_FAIL_Z, graphs.z, syndrome_z, res.decisions_z),
    ):
        s_hat = graph.syndrome(d.to(torch.int32)).cpu().numpy()
        mismatch = (s_hat != syn.cpu().numpy()).any(axis=0)
        flagged = (ec & bit) != 0
        if not np.array_equal(mismatch, flagged):
            problems.append(
                f"SYNDROME_FAIL_{name.upper()} disagrees with re-encoded "
                f"syndrome on {int((mismatch != flagged).sum())} lane(s)")
    for name, soft in (("x", res.soft_x), ("z", res.soft_z)):
        if soft is not None and not bool(torch.isfinite(soft).all()):
            problems.append(f"soft_{name} contains non-finite values")
    return problems
