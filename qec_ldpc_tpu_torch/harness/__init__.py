"""Run configuration, journal, records and debug tools (PyTorch port); the
experiment CLI is ``qec_ldpc_tpu_torch.harness.cli``."""

from qec_ldpc_tpu_torch.harness import debug
from qec_ldpc_tpu_torch.harness.config import (
    RunConfig,
    format_result_filename,
    load_init_file,
)
from qec_ldpc_tpu_torch.harness.journal import Journal
from qec_ldpc_tpu_torch.harness.stats import (
    CodeStatistics,
    parse_code_params,
    parse_reference_text,
)

__all__ = [
    "debug",
    "RunConfig",
    "load_init_file",
    "format_result_filename",
    "CodeStatistics",
    "parse_code_params",
    "parse_reference_text",
    "Journal",
]
