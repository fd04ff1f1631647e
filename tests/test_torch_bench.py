"""``bench_torch.py``, the port's headline benchmark, on the CPU at one
small chunk per workload: one JSON line with exactly bench.py's keys
(``bench.py:379-425``), the keys bench.py derives from its TPU vector-unit
peak null, and every gate passed at that count."""

import contextlib
import io
import json

import pytest
import torch

import bench_torch

torch.set_num_threads(1)

# bench.py's result keys, in its order
BENCH_KEYS = [
    "metric", "value", "unit", "vs_baseline", "corrected_fraction",
    "reference_corrected_fraction", "executed_bp_lane_iters_per_s",
    "layered_min_sum_samples_per_s", "layered_min_sum_vs_baseline",
    "layered_min_sum_corrected_fraction",
    "fixed_work_bp_iter_codewords_per_s_per_chip", "fixed_work_vs_baseline",
    "achieved_vpu_flops_per_s", "vpu_peak_estimate_flops_per_s",
    "vpu_peak_measured_flops_per_s", "vpu_utilization",
    "min_sum_fixed_work_iter_cw_per_s", "min_sum_achieved_flops_per_s",
    "min_sum_vpu_utilization", "layered_fixed_work_sweep_cw_per_s",
    "layered_achieved_flops_per_s", "layered_vpu_utilization", "device_kind",
    "headline_first_dispatch_s", "headline_steady_dispatch_s",
    "headline_compile_phase_s", "small_code_42_samples_per_s",
    "small_code_42_vs_baseline", "small_code_42_corrected_fraction",
    "bicycle_gross_samples_per_s", "bicycle_gross_corrected_fraction",
]
VPU_KEYS = {"vpu_peak_estimate_flops_per_s", "vpu_peak_measured_flops_per_s",
            "vpu_utilization", "min_sum_vpu_utilization",
            "layered_vpu_utilization"}


@pytest.fixture(scope="module")
def run():
    """bench_torch.main at one chunk of 128 lanes per workload."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = bench_torch.main(device="cpu", batch=128, headline_chunks=1,
                                  fixed_chunks=1, small_batch=128,
                                  small_chunks=1, gross_chunks=1, repeats=1)
    return out.getvalue(), result


def test_one_json_line_with_bench_keys(run):
    text, result = run
    lines = text.splitlines()
    assert len(lines) == 1
    printed = json.loads(lines[0])
    assert printed == result
    assert list(printed) == BENCH_KEYS


def test_tpu_peak_keys_are_null(run):
    _, result = run
    assert {k for k, v in result.items() if v is None} == VPU_KEYS


def test_values_at_one_chunk(run):
    _, result = run
    assert result["device_kind"] == "cpu"
    assert result["reference_corrected_fraction"] == 0.99539
    for k in BENCH_KEYS:
        if k not in VPU_KEYS | {"metric", "unit", "device_kind"}:
            assert isinstance(result[k], float) and result[k] >= 0, k
    assert result["bicycle_gross_corrected_fraction"] > 0.99
    # bench.py's 18 operations per edge and iteration, X (4 x 10 blocks of
    # 61) and Z (5 x 10) edges
    assert result["achieved_vpu_flops_per_s"] == pytest.approx(
        result["fixed_work_bp_iter_codewords_per_s_per_chip"] * 18
        * (4 + 5) * 10 * 61, rel=1e-4)  # the rate is rounded to 0.1


def test_card_is_required_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="is_available"):
        bench_torch.main()
