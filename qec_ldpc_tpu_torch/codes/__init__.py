"""Code construction, shared with the JAX package.

``qec_ldpc_tpu.codes`` is NumPy-only (importing ``qec_ldpc_tpu`` pulls in
nothing but this layer), so the port imports it instead of copying it.  No
other ``qec_ldpc_tpu`` submodule may be imported from the port: the decoder,
sampling and harness layers import ``jax`` at module level.
"""

from qec_ldpc_tpu.codes.construction import find_code_params, gf2_rref
from qec_ldpc_tpu.codes.css import QuantumLDPCCode, construct_code
from qec_ldpc_tpu.codes.loader import load_code_file

__all__ = ["QuantumLDPCCode", "construct_code", "find_code_params", "gf2_rref",
           "load_code_file"]
