"""Bivariate bicycle codes end to end: construct, decode, repair, search.

The PyTorch port of examples/bicycle_demo.py.  On a CUDA card the min-sum
decode runs the lifted min-sum kernel (K5, csrc/lifted_min_sum.cu); OSD
with a combination sweep (lam = 20) runs on the host library.
``--device cpu`` runs the plain PyTorch versions.

    python3 examples_torch/bicycle_demo.py [published-label] [--device cpu]
"""

import argparse
import pathlib
import sys

# runnable from anywhere without installing the package
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch

from examples_torch.quickstart import device_of
from qec_ldpc_tpu_torch.codes import find_bicycle_codes, known_bicycle_code
from qec_ldpc_tpu_torch.decoder import (
    BPConfig,
    CSSPostprocessor,
    decode_batch,
    syndromes_from_errors,
)
from qec_ldpc_tpu_torch.sampling import (
    classify_batch,
    classify_batch_np,
    sample_depolarizing_errors,
)


def main(argv=None) -> dict:
    """Returns the counters of BP alone and of BP+OSD, and the search's
    hits."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("label", nargs="?", default="[[144,12,12]]")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--p", type=float, default=0.03)
    ap.add_argument("--lam", type=int, default=20)
    args = ap.parse_args(argv)
    device = device_of(args.device)

    code = known_bicycle_code(args.label)
    graphs = code.build_graphs()
    print(f"code: {code}  (n={code.n}, k={code.k_logical})")

    # --- decode a batch of depolarizing errors with flooding min-sum -------
    p = args.p
    gen = torch.Generator(device=device).manual_seed(0)
    xe, ze = sample_depolarizing_errors(gen, code.n, p, args.batch)
    xe, ze = xe.to(torch.int32), ze.to(torch.int32)
    sx, sz = syndromes_from_errors(graphs, xe, ze)
    cfg = BPConfig(max_iters=100, algorithm="min-sum", return_soft=True)
    res = decode_batch(graphs, sx, sz, p, cfg)
    c = classify_batch(torch.as_tensor(code.i_minus_p, device=device), xe, ze,
                       res.decisions_x.to(torch.int32),
                       res.decisions_z.to(torch.int32),
                       res.error_code).cpu().numpy()
    print(f"BP alone     @ p={p}: corrected {c[3]}/{c[0]}, "
          f"syndrome-fail {c[4] + c[5]}, logical {c[6]}")

    # --- BP+OSD: repair the failures on the host ---------------------------
    dx, dz, ec = CSSPostprocessor(graphs, lam=args.lam).apply(sx, sz, res)
    c2 = classify_batch_np(code.i_minus_p, xe, ze, dx, dz, ec)
    print(f"BP+OSD({args.lam})   @ p={p}: corrected {c2[3]}/{c2[0]}, "
          f"syndrome-fail {c2[4] + c2[5]}, logical {c2[6]}")

    # --- search for new instances at the same lattice shape ----------------
    hits = find_bicycle_codes(6, 6, count=2, min_k=8)
    print("BB(6,6) search, k>=8, girth>=6:",
          ", ".join(f"{h}" for h in hits))
    return {"bp": c, "bp_osd": c2, "hits": hits}


if __name__ == "__main__":
    main()
