"""Monte-Carlo drivers (PyTorch; single device), the OSD quality mode
included."""

from qec_ldpc_tpu_torch.parallel.montecarlo import (
    effective_steps_per_call,
    run_monte_carlo,
    run_monte_carlo_osd,
)
