"""Best-logical-error-rate pipeline: layered min-sum + ensemble relay + OSD.

The PyTorch port of examples/quality_pipeline.py: the full repair stack
(docs/DECODERS.md) at a heavy error weight where plain BP fails on ~20% of
samples.  On a CUDA card the layered decode runs K3
(csrc/layered_min_sum.cu) and the relay retries the damped min-sum kernel
K2 (csrc/min_sum.cu); OSD with a combination sweep (lam = 60) runs on the
host library.  ``--device cpu`` runs the plain PyTorch versions.

    python3 examples_torch/quality_pipeline.py [weight] [--device cpu]

The same pipeline through the Monte-Carlo driver:
    run_monte_carlo_osd(..., relay_retries=12, lam=60)
or the CLI's init extensions ``algorithm=layered-min-sum relay=12 osd=60``.
"""

import argparse
import pathlib
import sys

# runnable from anywhere without installing the package
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch

from examples_torch.quickstart import device_of
from qec_ldpc_tpu_torch.codes import construct_code
from qec_ldpc_tpu_torch.decoder import (
    BPConfig,
    CodeGraphs,
    CSSPostprocessor,
    decode_batch,
    relay_decode_batch,
    syndromes_from_errors,
)
from qec_ldpc_tpu_torch.decoder.relay import RelayDraws
from qec_ldpc_tpu_torch.sampling import classify_batch_np, sample_weight_w_errors


def main(argv=None) -> dict:
    """Returns each stage's counters, by stage name."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("weight", type=int, nargs="?", default=40)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--code", type=int, nargs=6, default=[4, 5, 10, 61, 9, 49],
                    metavar=("J", "K", "L", "P", "SIGMA", "TAU"),
                    help="construct_code parameters (default: [[610,61]])")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--retries", type=int, default=12)
    ap.add_argument("--lam", type=int, default=60)
    args = ap.parse_args(argv)
    device = device_of(args.device)

    code = construct_code(*args.code)
    graphs = CodeGraphs.build(code)
    p = 0.02
    gen = torch.Generator(device=device).manual_seed(0)
    xe, ze = sample_weight_w_errors(gen, code.n, args.weight, args.batch)
    xe, ze = xe.to(torch.int32), ze.to(torch.int32)
    sx, sz = syndromes_from_errors(graphs, xe, ze)
    cfg = BPConfig(max_iters=100, algorithm="layered-min-sum",
                   return_soft=True)
    out = {}

    def report(name, dx, dz, ec):
        c = classify_batch_np(code.i_minus_p, xe, ze, dx, dz, ec)
        print(f"{name:24s} corrected {c[3]:5d}  logical {c[6]:5d}  "
              f"syndrome-fail {c[4] + c[5]:5d}   (of {c[0]})")
        out[name] = c

    # stage 0: plain layered BP
    res = decode_batch(graphs, sx, sz, p, cfg)
    report("layered BP", res.decisions_x, res.decisions_z, res.error_code)

    # stage 1: + on-device ensemble relay, the gammas from the generators
    # of (7, graph, retry)
    res_r, _, _ = relay_decode_batch(graphs, sx, sz, p, RelayDraws([7], device),
                                     cfg, retries=args.retries)
    report(f"+ relay({args.retries})", res_r.decisions_x, res_r.decisions_z,
           res_r.error_code)

    # stage 2: + host OSD with combination sweep on whatever remains
    dx, dz, ec = CSSPostprocessor(graphs, lam=args.lam).apply(sx, sz, res_r)
    report(f"+ OSD(lam={args.lam})", dx, dz, ec)
    return out


if __name__ == "__main__":
    main()
