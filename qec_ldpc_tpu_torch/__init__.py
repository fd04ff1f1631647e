"""qec_ldpc_tpu_torch — the PyTorch / CUDA port of ``qec_ldpc_tpu``.

The same Monte-Carlo decoding pipeline for quasi-cyclic CSS quantum-LDPC
codes, written for an NVIDIA GPU: plain PyTorch functions on tensors with an
explicit device, explicit ``torch.Generator``s, and hand-written Hopper CUDA
kernels where the JAX package has Pallas TPU kernels.  The JAX package stays
beside it as the reference the port is held against; this package never
imports ``jax`` or anything of ``qec_ldpc_tpu``.

Layers (mirroring ``qec_ldpc_tpu``):
  codes/     the port's copy of the NumPy-only code layer (QC-CSS, bivariate
             bicycle, hypergraph-product and toric codes)
  decoder/   circulant and lifted layouts, plain sum-product, min-sum and
             layered min-sum, X/Z decode + decisions and soft outputs, relay
             retries, OSD post-processing (host solver and device OSD-0)
  kernels/   hand-written CUDA kernels (csrc/) with their ctypes wrappers
  native/    the host GF(2) library (gf2.cpp, built by g++ at first use)
  sampling/  Pauli error sampling and outcome classification
  parallel/  single-device Monte-Carlo loop (relay mode included) and the
             OSD quality mode
  harness/   CodeStatistics record (reference-exact text)
  convert    carries graphs, logical tests and configs across from JAX
"""

__version__ = "0.1.0"

from qec_ldpc_tpu_torch.codes import QuantumLDPCCode, construct_code, load_code_file

__all__ = ["QuantumLDPCCode", "construct_code", "load_code_file"]
