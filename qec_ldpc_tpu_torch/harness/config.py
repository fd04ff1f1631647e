"""Run configuration: the dataclass of one experiment and the reference's
init-file format (PyTorch port).

The port's copy of ``qec_ldpc_tpu/harness/config.py``.  The reference
drives experiments from a 6-token positional init file (``main.cu:74-89``;
example ``QEC_LDPC/init.txt``):
    codeFile / w / W / COUNT / MAX_ITERATIONS / p
Further ``key=value`` tokens set the other fields of :class:`RunConfig`.
The fields and defaults are the JAX package's, plus ``device``.
"""

from __future__ import annotations

import dataclasses
import os

from qec_ldpc_tpu_torch.decoder.sum_product import BPConfig

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


def apply_option(cfg: "RunConfig", key: str, value: str) -> None:
    """Set one RunConfig field from its string form, with strict coercion.

    Booleans accept only explicit true/false literals: a typo ('ture')
    raises rather than becoming False."""
    if not hasattr(cfg, key):
        raise ValueError(f"unknown option {key!r}")
    cur = getattr(cfg, key)
    if isinstance(cur, bool):
        v = value.lower()
        if v in _TRUE:
            value = True
        elif v in _FALSE:
            value = False
        else:
            raise ValueError(
                f"option {key!r}: expected one of {_TRUE + _FALSE}, "
                f"got {value!r}")
    elif isinstance(cur, int) or (cur is None and key == "seed"):
        value = int(value)
    elif isinstance(cur, float):
        value = float(value)
    setattr(cfg, key, value)


@dataclasses.dataclass
class RunConfig:
    code_file: str
    weight_start: int
    weight_end: int
    count: int
    max_iterations: int
    error_probability: float
    #: framework extensions
    seed: int | None = None
    batch_size: int = 1024
    results_dir: str = "results"
    log_file: str = "output_log.txt"
    algorithm: str = "sum-product"   # or "min-sum" / "layered-min-sum"
    error_model: str = "weight"      # or "depolarizing"
    #: spread the samples over every rank of the process group (torchrun)
    use_mesh: bool = True
    #: graph-axis size of the mesh: > 1 shards the Tanner graphs over that
    #: many ranks (circulant codes, parallel/mc_graph.py) and the samples
    #: over the rest; it must divide L, and the world size must be a
    #: multiple of it.  The quality mode (osd) runs on the data axis only.
    num_graph: int = 1
    #: comma-separated physical error rates: sweep p at fixed weight
    #: instead of the reference's weight sweep
    p_values: str = ""
    #: write a torch.profiler trace (Chrome / TensorBoard) under this
    #: directory
    profile_dir: str = ""
    #: the JAX package's engine choice ("auto", "pallas", "xla"); see
    #: :meth:`bp_config`
    kernel: str = "auto"
    #: Monte-Carlo chunks per group: the host reads the counters once per
    #: group, and the journal records one line per group
    steps_per_call: int = 32
    #: OSD post-processing of BP failures (decoder/osd.py): -1 = off,
    #: 0 = OSD-0, >0 = combination sweep over that many non-pivot columns.
    #: Pairs best with an LLR-domain algorithm (min-sum / layered-min-sum).
    osd: int = -1
    #: logical-error test convention: "reference" reproduces the shipped
    #: iMinusP semantics; "physical" uses the same-Pauli-type stabilizers
    #: (codes/css.py i_minus_p_physical)
    logical_test: str = "reference"
    #: randomized damped min-sum retries of BP failures (decoder/relay.py),
    #: 0 = off; composes with osd (relay first, OSD mops up)
    relay: int = 0
    #: the torch device type to run on: "cuda" (the card this rank
    #: selected) or "cpu"; a run on "cuda" without a card raises
    device: str = "cuda"

    def sweep_points(self) -> list[tuple[int, float]]:
        """The (weight, p) grid this run covers: the reference's w..W sweep at
        fixed p, or a p sweep at fixed weight when ``p_values`` is set."""
        if self.p_values:
            ps = [float(x) for x in self.p_values.replace(",", " ").split()]
            return [(self.weight_start, p) for p in ps]
        return [(w, self.error_probability)
                for w in range(self.weight_start, self.weight_end + 1)]

    def bp_config(self) -> BPConfig:
        """The decode config: the one the JAX package's ``bp_config()``
        returns on a CPU backend, so ``"auto"`` becomes ``"xla"``.  The
        port's ``BPConfig.kernel`` only keeps the two configs equal: on a
        CUDA tensor the decode always runs the algorithm's CUDA kernel, on
        a CPU tensor its plain version.  ``"pallas"`` on a graph mesh asks
        for the fused graph-sharded min-sum step (K8)."""
        kernel = "xla" if self.kernel == "auto" else self.kernel
        return BPConfig(max_iters=self.max_iterations,
                        algorithm=self.algorithm, kernel=kernel)


def load_init_file(path: str) -> RunConfig:
    """Parse the reference init format: 6 whitespace-separated tokens
    (``main.cu:74-89``).  Extra ``key=value`` tokens extend the format."""
    tokens: list[str] = []
    extras: dict[str, str] = {}
    with open(path) as f:
        for raw in f.read().split():
            if "=" in raw:
                k, v = raw.split("=", 1)
                extras[k] = v
            else:
                tokens.append(raw)
    if len(tokens) < 6:
        raise ValueError(
            f"init file {path!r}: expected 6 positional values "
            f"(codeFile w W COUNT MAX_ITERATIONS p), got {len(tokens)}")
    code_file = tokens[0]
    if (not os.path.isabs(code_file) and not os.path.exists(code_file)
            and ":" not in code_file):
        # the reference resolves codeFile against its own directory
        # (init.txt names just "code610.txt", main.cu:74-78), so its
        # literal init file runs from anywhere
        beside = os.path.join(os.path.dirname(os.path.abspath(path)),
                              code_file)
        if os.path.exists(beside):
            code_file = beside
    cfg = RunConfig(
        code_file=code_file,
        weight_start=int(tokens[1]),
        weight_end=int(tokens[2]),
        count=int(tokens[3]),
        max_iterations=int(tokens[4]),
        error_probability=float(tokens[5]),
    )
    for k, v in extras.items():
        try:
            apply_option(cfg, k, v)
        except ValueError as e:
            raise ValueError(f"init file {path!r}: {e}") from e
    return cfg


def format_result_filename(code_str: str, weight: int, max_iterations: int,
                           error_probability: float) -> str:
    """Result-file naming of the reference harness (``main.cu:93-97``):
    ``<code>_W_<w>_MAX_<M>_p_<p>.txt`` with spaces stripped and the float
    printed like C++ default ostream (up to 6 significant digits)."""
    p_str = f"{error_probability:g}"
    name = f"{code_str}_W_{weight}_MAX_{max_iterations}_p_{p_str}.txt"
    return name.replace(" ", "")
