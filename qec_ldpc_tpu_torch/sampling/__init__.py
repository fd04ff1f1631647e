"""Pauli error sampling and outcome classification (PyTorch)."""

from qec_ldpc_tpu_torch.sampling.classify import (
    C_CONV_X, C_CONV_Z, C_CORRECTED, C_LOGICAL, C_SYN_X, C_SYN_Z, C_TESTED,
    C_X_TESTED, C_Z_TESTED, NUM_COUNTERS, RankBasisTest, classify_batch,
    classify_batch_np, logical_error_mask, logical_error_mask_basis,
    make_rank_basis_test, rank_basis_test,
)
from qec_ldpc_tpu_torch.sampling.errors import (
    sample_depolarizing_errors,
    sample_weight_w_errors,
    sample_weight_w_errors_dynamic,
)
