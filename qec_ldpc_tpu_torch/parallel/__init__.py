"""Monte-Carlo drivers (PyTorch; single device)."""

from qec_ldpc_tpu_torch.parallel.montecarlo import (
    effective_steps_per_call,
    run_monte_carlo,
)
