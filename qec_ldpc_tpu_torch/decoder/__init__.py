"""Batched BP decoding over circulant and lifted Tanner graphs (PyTorch):
sum-product, min-sum, layered min-sum (circulant only), the relay decoder,
and OSD post-processing (host solver, and device OSD-0)."""

from qec_ldpc_tpu_torch.decoder.layout import CirculantGraph
from qec_ldpc_tpu_torch.decoder.lifted import LiftedGraph
from qec_ldpc_tpu_torch.decoder.sum_product import (
    BPConfig,
    bp_run,
    cn_update,
    vn_update,
)
from qec_ldpc_tpu_torch.decoder.min_sum import min_sum_run, prior_llr
from qec_ldpc_tpu_torch.decoder.layered import layered_min_sum_run
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
from qec_ldpc_tpu_torch.decoder.relay import relay_decode_batch
from qec_ldpc_tpu_torch.decoder.osd_device import DeviceOSD0
from qec_ldpc_tpu_torch.decoder.osd import CSSPostprocessor, OSDecoder
from qec_ldpc_tpu_torch.decoder.validate import (
    checked_decode_batch,
    validate_decode_result,
)

__all__ = [
    "CirculantGraph", "LiftedGraph", "BPConfig", "bp_run", "min_sum_run",
    "prior_llr", "layered_min_sum_run", "relay_decode_batch", "CodeGraphs", "DecodeResult",
    "decode_batch", "syndromes_from_errors", "SUCCESS", "SYNDROME_FAIL_X",
    "SYNDROME_FAIL_Z", "CONVERGENCE_FAIL_X", "CONVERGENCE_FAIL_Z",
    "OSDecoder", "CSSPostprocessor", "DeviceOSD0", "cn_update", "vn_update",
    "checked_decode_batch", "validate_decode_result",
]
