"""Hand-written CUDA kernels (sources in ``qec_ldpc_tpu_torch/csrc/``) and
their PyTorch wrappers.  Nothing is compiled at import: a kernel is built by
``nvcc`` the first time its wrapper launches it."""
