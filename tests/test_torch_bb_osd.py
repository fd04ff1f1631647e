"""BP-OSD on bivariate bicycle codes through the quality mode
(``run_monte_carlo_osd``, min-sum + OSD-0) on the CPU, held to the plain
reference of the port's benchmark (``perfbench/reference``: plain PyTorch,
importing neither JAX nor the port) on the same seed and chunks: the nine
counters and the lane-iterations exactly, and the ``osd.system_bits``
counter against the lanes handed to OSD."""

import sys
from pathlib import Path

import pytest
import torch

from qec_ldpc_tpu_torch import tracing
from qec_ldpc_tpu_torch.codes import bicycle_code
from qec_ldpc_tpu_torch.codes.bicycle import KNOWN_CODES
from qec_ldpc_tpu_torch.decoder import BPConfig
from qec_ldpc_tpu_torch.parallel import montecarlo

sys.path.insert(0, str(Path(__file__).resolve().parent.parent
                       / "perfbench" / "reference"))
import ref_codes  # noqa: E402
import ref_decoders  # noqa: E402

torch.set_num_threads(1)

BATCH, CHUNKS, MAX_ITERS, SEED = 128, 2, 20, 2**31 + 20
CODES = ["[[144,12,12]]", "[[756,16,34]]"]


def traffic(p: float) -> dict:
    """The run as the reference reads it (a benchmark cell's keys)."""
    return {"error_model": "depolarizing", "p": p, "batch": BATCH,
            "osd_lam": 0, "relay_retries": 0,
            "decoder": {"algorithm": "min-sum", "max_iters": MAX_ITERS,
                        "check_every": 10, "conv_low": 0.01,
                        "conv_high": 0.99, "alpha": 0.75}}


@pytest.mark.parametrize("p", [0.06, 0.10])
@pytest.mark.parametrize("name", CODES)
def test_quality_mode_matches_the_reference(name, p, monkeypatch):
    l, m, a, b = KNOWN_CODES[name]
    graphs = bicycle_code(l, m, a, b).build_graphs()
    tr = traffic(p)
    d = tr["decoder"]
    cfg = BPConfig(max_iters=MAX_ITERS, check_every=d["check_every"],
                   conv_low=d["conv_low"], conv_high=d["conv_high"],
                   algorithm="min-sum", min_sum_alpha=d["alpha"])
    handed = []
    orig = montecarlo._repair_and_classify

    def counted(post, i_minus_p, counts, bundle):
        handed.append((int(counts[1]), int(counts[2])))
        return orig(post, i_minus_p, counts, bundle)

    monkeypatch.setattr(montecarlo, "_repair_and_classify", counted)
    with tracing.recording() as rec:
        counters, lane_iters = montecarlo.run_monte_carlo_osd(
            graphs, 0, CHUNKS * BATCH, p, cfg, seed=SEED, batch_size=BATCH,
            lam=0, error_model="depolarizing", device="cpu")

    code = ref_codes.build_code({"family": "bb", "l": l, "m": m, "a": a,
                                 "b": b})
    ref = ref_decoders.Reference(code, tr, "cpu")
    want, records = ref.replay(SEED, list(range(CHUNKS)))
    assert counters.tolist() == want.tolist()
    # the plain path runs each decode call to its slowest lane
    assert lane_iters == sum(r["loop_iters"] * r["lanes"] for r in records)

    k_x, k_z = (sum(h[i] for h in handed) for i in (0, 1))
    assert k_x + k_z > 0
    assert rec.counters["osd.lanes"] == k_x + k_z
    n = graphs.code.n
    m_x, m_z = graphs.code.pcm_x.shape[0], graphs.code.pcm_z.shape[0]
    assert rec.counters["osd.system_bits"] == (k_x * m_x * (n + 1)
                                               + k_z * m_z * (n + 1))
