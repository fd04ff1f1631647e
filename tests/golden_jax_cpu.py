"""The JAX package's corpus scripts' per-point body, run through XLA on the
CPU: what ``benchmarks/golden_*.py`` give on an IEEE device.

Each JAX script jits one body per point (``golden_sweep.py:80-96``,
``golden_deep.py:171-187``, ``golden_dated.py:143-159``; golden_sweep42's
is the same split into 64-chunk scans): chunk c draws
``sample_weight_w_errors_dynamic(fold_in(PRNGKey(seed), c), n, W, cap,
2048)``, decodes with ``decode_batch`` at the traced prior and classifies
with the rank-basis test, and the counters are summed over the chunks.
:func:`run_point` is that body with ``kernel="xla"``.  On the CPU it gives
the JAX decoder's answer on IEEE arithmetic, which the TPU records do not
(their arithmetic is the TPU's); ``benchmarks_torch/common.py``
``JAX_CPU_RUNS`` keeps three full-depth points, which the port's JAX-stream
runs (``golden_*.py --stream jax``) must equal on the card:

    JAX_PLATFORMS=cpu python -m tests.golden_jax_cpu 3,3,6,7,2,3 5 100 0.02 \\
        5208 48 512        # golden_dated's archive [[42,0]] W=5 (~2 min)

The port never imports this module (its tests and this command do).
"""

from __future__ import annotations

import json
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from qec_ldpc_tpu.codes import construct_code
from qec_ldpc_tpu.decoder import BPConfig, CodeGraphs
from qec_ldpc_tpu.decoder.decode import decode_batch, kernel_consts
from qec_ldpc_tpu.sampling import (
    NUM_COUNTERS,
    classify_batch,
    sample_weight_w_errors_dynamic,
)
from qec_ldpc_tpu.sampling.classify import make_rank_basis_test


def run_point(params, weight: int, max_iters: int, prior: float, seed: int,
              w_cap: int, chunks: int, batch: int = 2048) -> np.ndarray:
    """The JAX scripts' point: (NUM_COUNTERS,) int64 counters over chunks
    0..``chunks - 1`` of ``PRNGKey(seed)``."""
    code = construct_code(*params)
    graphs = CodeGraphs.build(code)
    cfg = BPConfig(max_iters=max_iters, kernel="xla")

    @partial(jax.jit, static_argnames=("num_chunks",))
    def point(lt, consts, key, weight, p, num_chunks):
        def body(counters, c):
            ck = jax.random.fold_in(key, c)
            xe, ze = sample_weight_w_errors_dynamic(
                ck, graphs.code.n, weight, w_cap, batch)
            xe_i, ze_i = xe.astype(jnp.int32), ze.astype(jnp.int32)
            res = decode_batch(graphs, graphs.x.syndrome(xe_i),
                               graphs.z.syndrome(ze_i), p, cfg,
                               consts=consts)
            cnt = classify_batch(lt, xe_i, ze_i,
                                 res.decisions_x.astype(jnp.int32),
                                 res.decisions_z.astype(jnp.int32),
                                 res.error_code)
            return counters + cnt, None

        counters, _ = jax.lax.scan(
            body, jnp.zeros(NUM_COUNTERS, jnp.int32),
            jnp.arange(num_chunks, dtype=jnp.uint32))
        return counters

    return np.asarray(point(make_rank_basis_test(code),
                            kernel_consts(graphs, cfg),
                            jax.random.PRNGKey(seed), jnp.int32(weight),
                            jnp.float32(prior), chunks), dtype=np.int64)


def main(argv: list[str]) -> int:
    params = tuple(int(x) for x in argv[0].split(","))
    weight, max_iters = int(argv[1]), int(argv[2])
    prior = float(argv[3])
    seed, w_cap, chunks = (int(x) for x in argv[4:7])
    counters = run_point(params, weight, max_iters, prior, seed, w_cap,
                         chunks)
    print(json.dumps({"params": params, "weight": weight,
                      "max_iters": max_iters, "prior": prior, "seed": seed,
                      "w_cap": w_cap, "chunks": chunks,
                      "counters": counters.tolist(),
                      "jax": jax.__version__}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
