"""Carry the JAX package's decode-time objects across to the port.

For this system the "parameters" are the codes, the edge structure of their
circulant and lifted graphs, the logical-test basis, the decode config, the
prior LLR and the relay decoder's damping draws.  These functions rebuild
them as the port's objects, so that tests feed both packages the same
structure.  They read the JAX objects' fields only and import nothing of
the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qec_ldpc_tpu_torch.codes import (
    BicycleCode,
    HypergraphProductCode,
    QuantumLDPCCode,
)
from qec_ldpc_tpu_torch.decoder.decode import CodeGraphs
from qec_ldpc_tpu_torch.decoder.layout import CirculantGraph
from qec_ldpc_tpu_torch.decoder.lifted import LiftedGraph
from qec_ldpc_tpu_torch.decoder.sum_product import BPConfig
from qec_ldpc_tpu_torch.sampling.classify import RankBasisTest


CODE_TYPES = {cls.__name__: cls
              for cls in (QuantumLDPCCode, BicycleCode, HypergraphProductCode)}


def graph_from_jax(graph) -> CirculantGraph | LiftedGraph:
    """A ``qec_ldpc_tpu`` CirculantGraph or LiftedGraph -> the port's.  A
    lifted graph is rebuilt from its check-major edge blocks, so the port's
    stable sort keeps their order and the rank tables agree."""
    if hasattr(graph, "table"):
        return CirculantGraph.from_table(np.asarray(graph.table), graph.P)
    edges = list(zip(graph.check_blocks, graph.var_blocks, graph.shifts))
    return LiftedGraph.build(graph.num_check_blocks, graph.num_var_blocks,
                             tuple(graph.group), edges)


def code_from_jax(code):
    """A ``qec_ldpc_tpu`` QuantumLDPCCode, BicycleCode or
    HypergraphProductCode -> the port's, rebuilt from its dataclass fields
    (arrays copied; cached matrices are derived again on use)."""
    cls = CODE_TYPES.get(type(code).__name__)
    if cls is None:
        raise TypeError(f"no port of code type {type(code).__name__}")
    fields = {f.name: getattr(code, f.name) for f in dataclasses.fields(code)}
    return cls(**{k: np.array(v) if isinstance(v, np.ndarray) else v
                  for k, v in fields.items()})


def graphs_from_jax(graphs) -> CodeGraphs:
    """A ``qec_ldpc_tpu`` CodeGraphs -> the port's, code included."""
    return CodeGraphs(code=code_from_jax(graphs.code),
                      x=graph_from_jax(graphs.x), z=graph_from_jax(graphs.z))


def rank_basis_test_from_numpy(test, device: torch.device | str) -> RankBasisTest:
    """A RankBasisTest whose fields are arrays (numpy or anything
    ``np.asarray`` reads) -> the port's, on ``device``."""
    def t(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return RankBasisTest(basis_x=t(test.basis_x, torch.int8),
                         pivots_x=t(test.pivots_x, torch.int64),
                         basis_z=t(test.basis_z, torch.int8),
                         pivots_z=t(test.pivots_z, torch.int64))


def bpconfig_from_jax(cfg) -> BPConfig:
    """A ``qec_ldpc_tpu`` BPConfig -> the port's (same fields)."""
    return BPConfig(**dataclasses.asdict(cfg))


def prior_llr_from_jax(llr) -> float:
    """JAX's float32 prior LLR (``log1p(-p) - log(p)`` as XLA evaluates it)
    -> the Python float the port's min-sum runs take.  XLA's ``log`` and
    PyTorch's differ by an ulp or two on some priors, so a test that must
    match JAX bit for bit carries JAX's value across."""
    return float(np.float32(np.asarray(llr)))


def float32_from_numpy(a, device: torch.device | str) -> torch.Tensor:
    """A damping or gamma array (numpy, or anything ``np.asarray`` reads)
    -> a contiguous float32 tensor on ``device``."""
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)


def lanes_to_rows(a, P: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """A K8 operand in the TPU kernel's layout, (blocks, batch, P padded to
    128) (numpy, or anything ``np.asarray`` reads) -> the port's row layout
    (blocks*P, batch) float32 on ``device``; the pad lanes are dropped."""
    a = np.asarray(a, dtype=np.float32)[:, :, :P]
    return torch.tensor(np.ascontiguousarray(
        a.transpose(0, 2, 1).reshape(-1, a.shape[1])), device=device)


def done_to_lanes(done: torch.Tensor) -> np.ndarray:
    """A (batch,) bool done mask -> the TPU kernel's (batch, 128) float32
    mask (column 0 read)."""
    d = done.detach().cpu().numpy().astype(np.float32)
    return np.repeat(d[:, None], 128, axis=1)
