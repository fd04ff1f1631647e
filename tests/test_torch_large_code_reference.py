"""The reference that ``benchmarks_torch/large_code_real.py`` holds its
P=2081 probe to, reproduced: the JAX package's own chunk loop on the CPU
(kernel "xla") at the probe's code, key, weight, batch, chunks and
iteration limit sums to ``large_code_real.JAX_CPU_P2081``.

The JAX package's r5 record of that probe is not its decoder's answer
(every Z syndrome failing, its Pallas and XLA rows disagreeing), so the
script's gate reads this constant instead; this test is where it comes
from.  One process, ~50 s and ~3.5 GB on the CPU."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np

from benchmarks_torch import large_code_real
from qec_ldpc_tpu.codes import construct_code, find_code_params
from qec_ldpc_tpu.decoder import BPConfig
from qec_ldpc_tpu.decoder.decode import CodeGraphs, kernel_consts
from qec_ldpc_tpu.parallel.montecarlo import mc_chunk
from qec_ldpc_tpu.sampling.classify import make_rank_basis_test

P = 2081


def test_jax_cpu_p2081_is_the_jax_decoders_answer():
    defaults = inspect.signature(large_code_real.main).parameters
    batch = defaults["probe_batch"].default
    chunks = defaults["probe_chunks"].default
    iters = defaults["probe_iters"].default
    code = construct_code(4, 5, 10, P, *find_code_params(4, 5, 10, P)[0])
    weight = max(1, round(15 * code.n / 610))
    assert (weight, batch, chunks, iters) == (512, 256, 8, 10)
    graphs = CodeGraphs.build(code)
    cfg = BPConfig(max_iters=iters, check_every=iters + 1,
                   algorithm="min-sum", kernel="xla")
    consts = kernel_consts(graphs, cfg)
    test = make_rank_basis_test(code)
    key = jax.random.PRNGKey(large_code_real.SEED)
    total = np.zeros(9, np.int64)
    for c in range(chunks):
        counters, _ = mc_chunk(graphs, test, jax.random.fold_in(key, c),
                               weight, jnp.float32(large_code_real.P_ERR),
                               cfg, batch, "weight", consts)
        total += np.asarray(counters)
    assert tuple(total.tolist()) == large_code_real.JAX_CPU_P2081
    # the script's gate reads it at exactly this shape
    assert large_code_real.jax_row(f"qc_P{P}_probe", weight, batch, chunks,
                                   iters, True)["counters"] == list(
                                       large_code_real.JAX_CPU_P2081)
