"""Code construction: the port's own copy of ``qec_ldpc_tpu/codes``.

NumPy only, like the JAX package's code layer, with the same exports.  The
port copies it rather than importing it, so that nothing of the port loads
``qec_ldpc_tpu``; the families that build lifted graphs (``bicycle``,
``hypergraph``) build the port's ``LiftedGraph`` and ``CodeGraphs``.
"""

from qec_ldpc_tpu_torch.codes.construction import (
    build_exponent_tables,
    build_i_minus_p,
    check_css_orthogonal,
    expand_circulant,
    find_code_params,
    gf2_annihilator,
    gf2_rref,
    multiplicative_order,
)
from qec_ldpc_tpu_torch.codes.bicycle import (
    BicycleCode,
    bicycle_code,
    find_bicycle_codes,
    known_bicycle_code,
    lifted_has_4cycles,
)
from qec_ldpc_tpu_torch.codes.hypergraph import (
    HypergraphProductCode,
    hgp_code,
    toric_code,
)
from qec_ldpc_tpu_torch.codes.analysis import girth_report, qc_has_4cycles, tanner_girth
from qec_ldpc_tpu_torch.codes.css import QuantumLDPCCode, construct_code, exponents_from_pcm
from qec_ldpc_tpu_torch.codes.loader import load_code_file, save_code_file

__all__ = [
    "QuantumLDPCCode",
    "BicycleCode",
    "bicycle_code",
    "known_bicycle_code",
    "find_bicycle_codes",
    "lifted_has_4cycles",
    "HypergraphProductCode",
    "hgp_code",
    "toric_code",
    "construct_code",
    "load_code_file",
    "save_code_file",
    "build_exponent_tables",
    "expand_circulant",
    "build_i_minus_p",
    "check_css_orthogonal",
    "find_code_params",
    "multiplicative_order",
    "gf2_annihilator",
    "gf2_rref",
    "exponents_from_pcm",
    "tanner_girth",
    "qc_has_4cycles",
    "girth_report",
]
