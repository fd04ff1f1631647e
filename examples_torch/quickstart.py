"""Quickstart: construct the flagship code, decode a batch, read the outcome.

The PyTorch port of examples/quickstart.py.  On a CUDA card the decode runs
the sum-product kernel (K1, csrc/bp_sum_product.cu); ``--device cpu`` runs
its plain PyTorch version.  The errors come from an explicit
``torch.Generator`` on the device.  See docs/DECODERS.md for algorithm
selection.

    python3 examples_torch/quickstart.py [--device cpu]
"""

import argparse
import pathlib
import sys

# runnable from anywhere without installing the package
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from qec_ldpc_tpu_torch.codes import construct_code
from qec_ldpc_tpu_torch.decoder import (
    BPConfig,
    CodeGraphs,
    decode_batch,
    syndromes_from_errors,
)
from qec_ldpc_tpu_torch.sampling import classify_batch, sample_weight_w_errors


def device_of(name: str) -> torch.device:
    """The device to run on; a CUDA device without a card raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    return device


def main(argv=None) -> np.ndarray:
    """Decode one batch; returns the counter vector (sampling/classify.py)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--code", type=int, nargs=6, default=[4, 5, 10, 61, 9, 49],
                    metavar=("J", "K", "L", "P", "SIGMA", "TAU"),
                    help="construct_code parameters (default: [[610,61]])")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--weight", type=int, default=15)
    ap.add_argument("--max-iters", type=int, default=100)
    args = ap.parse_args(argv)
    device = device_of(args.device)

    code = construct_code(*args.code)
    graphs = CodeGraphs.build(code)
    print(f"code: {code}  (n={code.n}, checks: {code.num_eqs_x}+{code.num_eqs_z})")

    gen = torch.Generator(device=device).manual_seed(0)
    xe, ze = sample_weight_w_errors(gen, code.n, args.weight, args.batch)
    xe, ze = xe.to(torch.int32), ze.to(torch.int32)
    sx, sz = syndromes_from_errors(graphs, xe, ze)
    res = decode_batch(graphs, sx, sz, 0.01, BPConfig(max_iters=args.max_iters))

    counters = classify_batch(
        torch.as_tensor(code.i_minus_p, device=device), xe, ze,
        res.decisions_x.to(torch.int32), res.decisions_z.to(torch.int32),
        res.error_code).cpu().numpy()
    tested, _, _, corrected, syn_x, syn_z, logical, conv_x, conv_z = counters
    print(f"tested {tested}: corrected {corrected}, logical {logical}, "
          f"syndrome-fail {syn_x}+{syn_z}, convergence-fail {conv_x}+{conv_z}")
    return counters


if __name__ == "__main__":
    main()
