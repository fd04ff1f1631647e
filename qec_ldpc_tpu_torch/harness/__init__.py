"""Run records (PyTorch port)."""

from qec_ldpc_tpu_torch.harness.stats import (
    CodeStatistics,
    parse_code_params,
    parse_reference_text,
)
