"""Batched BP decoding over circulant Tanner graphs (PyTorch)."""

from qec_ldpc_tpu_torch.decoder.layout import CirculantGraph
from qec_ldpc_tpu_torch.decoder.sum_product import BPConfig, bp_run
from qec_ldpc_tpu_torch.decoder.decode import (
    CONVERGENCE_FAIL_X,
    CONVERGENCE_FAIL_Z,
    SUCCESS,
    SYNDROME_FAIL_X,
    SYNDROME_FAIL_Z,
    CodeGraphs,
    DecodeResult,
    decode_batch,
    syndromes_from_errors,
)

__all__ = [
    "CirculantGraph", "BPConfig", "bp_run", "CodeGraphs", "DecodeResult",
    "decode_batch", "syndromes_from_errors", "SUCCESS", "SYNDROME_FAIL_X",
    "SYNDROME_FAIL_Z", "CONVERGENCE_FAIL_X", "CONVERGENCE_FAIL_Z",
]
