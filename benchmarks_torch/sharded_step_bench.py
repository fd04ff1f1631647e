"""One card's timing of the between-halos step (K8) against its plain
PyTorch version.

The port of ``benchmarks/sharded_step_bench.py``.  The graph-sharded
engines' collectives cannot be timed on one card, but the local work of an
iteration (everything between two halo all_gathers) can: one shard
position's step runs alone on the card, the kernel
(``kernels/sharded_step_cuda.py::sharded_min_sum_step``, K8) against the
engine's own body in plain PyTorch (``sharded_min_sum_step_plain``), on
shard 0 of 2 of the [[5210,521]]-class code the graph axis exists for, and
of [[610,61]].

Both iterate the same (V, partials) recurrence: the other-shard input of a
step is the previous step's partials.  (The JAX script feeds back
``|partials| + 0.1``, which turns the signs into 1.1; the kernel takes the
+-1 signs the engine makes, so the partials go back as they are, and the
timed loop holds nothing but the steps.)  The two are held bit for bit
before timing (gated).  Times are CUDA events around ``iters`` steps, best
of 3 after a warm-up.

Keys of the JAX record without a counterpart: the XLA lane-layout image
(``ms_per_iter_xla_lane_layout``, ``speedup_vs_lane_layout``: the port has
no second plain body) and the compile seconds are null;
``ms_per_iter_pallas`` is the kernel's time and ``ms_per_iter_xla_engine_body``
the plain version's.  Batch 256 is the JAX record's; 1024 is the lanes per
rank on the main path (PERF.md §6, K8 row).

    python benchmarks_torch/sharded_step_bench.py [--out PATH]
    python benchmarks_torch/sharded_step_bench.py --device cpu --batches 8 --iters 3
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmarks_torch.common import (  # noqa: E402
    bits_equal,
    card,
    event_time,
    gate,
    out_path,
    resolve_device,
    write_records,
)
from qec_ldpc_tpu_torch import construct_code  # noqa: E402
from qec_ldpc_tpu_torch.decoder.layout import CirculantGraph  # noqa: E402
from qec_ldpc_tpu_torch.kernels.sharded_step_cuda import (  # noqa: E402
    sharded_min_sum_step,
    sharded_min_sum_step_plain,
)
from qec_ldpc_tpu_torch.parallel.graph_sharded import ShardRouter  # noqa: E402

ITERS = 400
BATCHES = (256, 1024)
CODES = ((4, 5, 10, 521, 25, 1, 2), (4, 5, 10, 61, 9, 49, 2))
PRIOR_LLR = 4.59
ALPHA = 0.75


def inputs(router: ShardRouter, batch: int, device):
    """(syndrome signs, V0, other0, done) of the JAX script's recurrence,
    in the port's row layout, from NumPy's generator of seed 0."""
    B, Lc, P = router.B, router.Lc, router.P
    rng = np.random.default_rng(0)
    syn = np.where(rng.random((B * P, batch)) < 0.3, -1.0, 1.0)
    v0 = rng.standard_normal((Lc * B * P, batch)) * 4
    other0 = np.concatenate([
        np.abs(rng.standard_normal((B * P, batch))) + 0.5,
        np.where(rng.random((B * P, batch)) < 0.5, -1.0, 1.0)])

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()

    return (t(syn), t(v0), t(other0),
            torch.zeros(batch, dtype=torch.bool, device=device))


def loop(step, router, syn, v0, other0, done, iters: int):
    """``iters`` steps of the recurrence; returns the last (V, partials)."""
    v, part = v0, other0
    for _ in range(iters):
        v, part = step(router, PRIOR_LLR, False, syn, part, done, v, ALPHA)
    return v, part


def main(device: str = "cuda", codes=CODES, batches=BATCHES,
         iters: int = ITERS, out: str | None = None) -> list:
    """One record per (code, batch); returns them (meta line first).
    Raises if the kernel and the plain version differ in a bit."""
    device = resolve_device(device)
    where = card(device)
    records = []
    for (J, K, L, P, s, t, G) in codes:
        code = construct_code(J, K, L, P, s, t)
        router = ShardRouter(CirculantGraph.from_table(code.hc, P), G, 0)
        for batch in batches:
            args = inputs(router, batch, device)
            outs, times = {}, {}
            for name, step in (("pallas", sharded_min_sum_step),
                               ("xla_engine_body", sharded_min_sum_step_plain)):
                outs[name] = loop(step, router, *args, iters)
                times[name] = event_time(
                    lambda step=step: loop(step, router, *args, iters))
            (vk, pk), (vp, pp) = outs["pallas"], outs["xla_engine_body"]
            bit_equal = bits_equal(vk, vp) and bits_equal(pk, pp)
            gate(bit_equal, f"K8 differs from its plain version on P={P} "
                            f"shard 0 of {G} at batch {batch}")
            rec = {
                "code": f"P{P} shard g=0 of G={G}", "Lc": router.Lc,
                "batch": batch, "iters_per_dispatch": iters,
                # kernel and plain version (the JAX lane-layout image has
                # no counterpart)
                "bit_equal_all_three": bit_equal,
                "ms_per_iter_pallas": round(times["pallas"] / iters * 1e3, 4),
                "compile_s_pallas": None,
                "ms_per_iter_xla_lane_layout": None,
                "compile_s_xla_lane_layout": None,
                "ms_per_iter_xla_engine_body": round(
                    times["xla_engine_body"] / iters * 1e3, 4),
                "compile_s_xla_engine_body": None,
                "speedup_vs_engine_body": round(
                    times["xla_engine_body"] / times["pallas"], 2),
                "speedup_vs_lane_layout": None,
            }
            records.append(rec)
            print(f"P={P} batch={batch}: K8 {rec['ms_per_iter_pallas']} "
                  f"ms/iter | plain {rec['ms_per_iter_xla_engine_body']} "
                  f"({rec['speedup_vs_engine_body']}x) bit_equal={bit_equal}",
                  flush=True)
    records.insert(0, {
        "artifact": "sharded_step_bench",
        "device_kind": where["device_kind"],
        "note": ("one card's timing of ONE shard position's between-halos "
                 "step: K8 (ms_per_iter_pallas) against the engine's plain "
                 "PyTorch body (ms_per_iter_xla_engine_body), iterating the "
                 "same (V, partials) recurrence with the other-shard input "
                 "fed back from the previous step's partials; outputs held "
                 "bit for bit before timing; CUDA events, best of 3"),
    })
    write_records(out_path("sharded_step_bench", out), records, where)
    return records


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batches", default=",".join(map(str, BATCHES)))
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    main(a.device, CODES, tuple(int(b) for b in a.batches.split(",")),
         a.iters, a.out)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
