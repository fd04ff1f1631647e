"""Relay damping-range tuning on the codes that matter, on the card.

The port of ``benchmarks/relay_tuning.py``: draw a batch, decode with
flooding min-sum, take the lanes whose hard decision violates the syndrome
(the relay's actual input population), and measure, per candidate gamma
range over several seeds, the fraction of those failures a 16-retry relay
repairs (``decoder/relay.py::relay_decode_batch``), plus the corrected
fraction after classification of the repaired batch.  The [[610,61]]
workloads run K2, damped in the retries; the gross code [[144,12,12]] runs
K5, damped likewise.

Seed s draws its samples from the generator of (s, chunk 0) and its relay
gammas from the relay stream of (s, chunk 0), as the Monte-Carlo driver
would (``parallel/montecarlo.py``); each seed's samples and flooding
decode are made once and serve every range, so a record's ``seconds`` is
its range's relay decodes and classification.  The torch generators are
not JAX's, so each record is held to the JAX package's record of the same
code and range (``benchmarks/data/relay_tuning_r4.jsonl``) by
two-proportion tests: |z| < 4 on the BP failure rate and on the repair
rate (gated).

The JAX script picks its Pallas or XLA engine by backend; on a CUDA tensor
the port always runs the kernels (the plain versions take 100-800 ms a
decode on the card, PERF.md §6, and no switch routes the sweep through
them).

    python benchmarks_torch/relay_tuning.py [--out PATH]
    python benchmarks_torch/relay_tuning.py --device cpu --workloads qc610_W40 \\
        --ranges 0.2:0.95 --seeds 3 --batch 64
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmarks_torch.common import (  # noqa: E402
    card,
    gate,
    graphs_of,
    jax_records,
    out_path,
    resolve_device,
    two_proportion_z,
    write_records,
)
from qec_ldpc_tpu_torch.decoder import BPConfig, decode_batch  # noqa: E402
from qec_ldpc_tpu_torch.decoder.decode import (  # noqa: E402
    SYNDROME_FAIL_X,
    SYNDROME_FAIL_Z,
)
from qec_ldpc_tpu_torch.decoder.relay import relay_decode_batch  # noqa: E402
from qec_ldpc_tpu_torch.parallel.chunk import (  # noqa: E402
    chunk_generator,
    relay_draws,
    sample_syndromes,
)
from qec_ldpc_tpu_torch.sampling import (  # noqa: E402
    C_CORRECTED,
    C_TESTED,
    classify_batch,
    make_rank_basis_test,
)

RANGES = ((0.2, 0.95), (0.1, 0.9), (0.5, 0.99), (0.3, 0.8),
          (0.05, 1.0), (0.4, 0.95), (0.2, 0.7))
RETRIES = 16
SEEDS = (3, 7, 11)
#: name -> (code, error model, weight, p): [[610,61]] at the high-weight end
#: of the corpus (prior 0.02), where relay has work to do, and the gross
#: code at depolarizing p where BP starts failing; the tests run the [[42]]
#: code and [[72,12,6]]
WORKLOADS = {
    "qc610_W40": ((4, 5, 10, 61, 9, 49), "weight", 40, 0.02),
    "qc610_W50": ((4, 5, 10, 61, 9, 49), "weight", 50, 0.02),
    "bb144_p0.02": ("[[144,12,12]]", "depolarizing", 0, 0.02),
    "bb144_p0.03": ("[[144,12,12]]", "depolarizing", 0, 0.03),
    "qc42_W3": ((3, 3, 6, 7, 2, 3), "weight", 3, 0.02),
    "bb72_p0.05": ("[[72,12,6]]", "depolarizing", 0, 0.05),
}
DEFAULT_WORKLOADS = ("qc610_W40", "qc610_W50", "bb144_p0.02", "bb144_p0.03")
SYN_BITS = SYNDROME_FAIL_X | SYNDROME_FAIL_Z
Z_LIMIT = 4.0


def jax_row(name: str, lo: float, hi: float) -> dict | None:
    """The JAX package's record of this code and range, if it has one."""
    for rec in jax_records("data/relay_tuning_r4.jsonl")[1:]:
        if (rec["code"], rec["gamma_low"], rec["gamma_high"]) == (name, lo, hi):
            return rec
    return None


def main(device: str = "cuda", workloads=DEFAULT_WORKLOADS, ranges=RANGES,
         seeds=SEEDS, batch: int = 4096, retries: int = RETRIES,
         out: str | None = None) -> list:
    """One record per (workload, range); returns them (meta line first).
    Raises if a record's BP failure or repair rate is off the JAX
    package's (|z| >= 4)."""
    device = resolve_device(device)
    where = card(device)
    records = []
    for name in workloads:
        spec, model, weight, p = WORKLOADS[name]
        graphs = graphs_of(spec)
        test = make_rank_basis_test(graphs.code, device)
        cfg = BPConfig(max_iters=100, algorithm="min-sum")

        # each seed's samples and base decode, which no range changes
        drawn = []
        for seed in seeds:
            xe, ze, sx, sz = sample_syndromes(
                graphs, chunk_generator(seed, 0, device), weight, p, batch,
                model)
            base = decode_batch(graphs, sx, sz, p, cfg)
            drawn.append((seed, xe, ze, sx, sz,
                          int(((base.error_code & SYN_BITS) != 0).sum())))

        for lo, hi in ranges:
            fail0 = fail1 = corrected = tested = 0
            t0 = time.perf_counter()
            for seed, xe, ze, sx, sz, n_fail0 in drawn:
                res, _, _ = relay_decode_batch(
                    graphs, sx, sz, p, relay_draws(seed, 0, device), cfg,
                    retries=retries, gamma_low=lo, gamma_high=hi)
                cnt = classify_batch(test, xe, ze,
                                     res.decisions_x.to(xe.dtype),
                                     res.decisions_z.to(ze.dtype),
                                     res.error_code).cpu().numpy()
                fail0 += n_fail0
                fail1 += int(((res.error_code & SYN_BITS) != 0).sum())
                corrected += int(cnt[C_CORRECTED])
                tested += int(cnt[C_TESTED])
            rec = {
                "code": name, "gamma_low": lo, "gamma_high": hi,
                "retries": retries, "seeds": len(seeds),
                "batch_per_seed": batch,
                "bp_failures": fail0, "unrepaired": fail1,
                "repair_rate": round(1 - fail1 / max(fail0, 1), 4),
                "corrected_fraction": round(corrected / tested, 5),
                "seconds": round(time.perf_counter() - t0, 2),
            }
            records.append(rec)
            ref = jax_row(name, lo, hi)
            z_fail = z_repair = None
            if ref is not None:
                z_fail = two_proportion_z(
                    fail0, tested, ref["bp_failures"],
                    ref["seeds"] * ref["batch_per_seed"])
                # no failure, no repair rate to test
                z_repair = two_proportion_z(
                    fail0 - fail1, fail0,
                    ref["bp_failures"] - ref["unrepaired"],
                    ref["bp_failures"]) if fail0 else 0.0
            print(f"{name} gamma[{lo},{hi}): repair {rec['repair_rate']:.4f} "
                  f"({fail0} failures of {tested}), corrected "
                  f"{rec['corrected_fraction']:.5f}; vs JAX "
                  + ("no record" if ref is None else
                     f"repair {ref['repair_rate']} ({ref['bp_failures']} "
                     f"failures): z_fail={z_fail:+.2f} "
                     f"z_repair={z_repair:+.2f}"), flush=True)
            if ref is not None:
                gate(abs(z_fail) < Z_LIMIT and abs(z_repair) < Z_LIMIT,
                     f"{name} gamma[{lo},{hi}): z_fail={z_fail:+.2f} "
                     f"z_repair={z_repair:+.2f} against the JAX record")
    records.insert(0, {
        "artifact": "relay_tuning",
        "note": ("gamma-range sweep on flagship codes; repair_rate = "
                 "fraction of BP syndrome failures fixed by a 16-retry "
                 "relay (damped K2 on [[610,61]], damped K5 on the gross "
                 "code); corrected_fraction is post-relay classification of "
                 "the full batch; each record held to "
                 "benchmarks/data/relay_tuning_r4.jsonl (|z| < 4)"),
    })
    write_records(out_path("relay_tuning", out), records, where)
    return records


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workloads", default=",".join(DEFAULT_WORKLOADS))
    ap.add_argument("--ranges", default=",".join(f"{lo}:{hi}"
                                                 for lo, hi in RANGES))
    ap.add_argument("--seeds", default=",".join(map(str, SEEDS)))
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--retries", type=int, default=RETRIES)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    ranges = tuple(tuple(float(x) for x in r.split(":"))
                   for r in a.ranges.split(","))
    main(a.device, tuple(a.workloads.split(",")), ranges,
         tuple(int(s) for s in a.seeds.split(",")), a.batch, a.retries, a.out)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
