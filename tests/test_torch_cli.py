"""The port's experiment CLI (harness/cli.py) end to end on the CPU, held
against the JAX package's CLI: result files and records, journal run_ids,
resume from a cut or torn journal, the quality mode, the flag form, the
run log, and the refusal to run on a card that is not there.  Codes come
from ``qc:`` specs or files written by the port's ``save_code_file``."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qec_ldpc_tpu.harness import cli as jax_cli
from qec_ldpc_tpu.harness import config as jax_config
from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.codes import save_code_file
from qec_ldpc_tpu_torch.decoder.relay import GAMMA_HIGH, GAMMA_LOW
from qec_ldpc_tpu_torch.harness import (
    Journal,
    load_init_file,
    parse_reference_text,
)
from qec_ldpc_tpu_torch.harness import cli

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SPEC = "qc:3,3,6,7,2,3"


def two_proportion_z(k1, n1, k2, n2) -> float:
    p = (k1 + k2) / (n1 + n2)
    se = (p * (1 - p) * (1 / n1 + 1 / n2)) ** 0.5
    return 0.0 if se == 0 else (k1 / n1 - k2 / n2) / se


def init_file(tmp_path: Path, line: str, name: str = "init.txt") -> str:
    path = tmp_path / name
    path.write_text(line + "\n")
    return str(path)


def journal_lines(results_dir) -> list[str]:
    return Path(results_dir, "journal.jsonl").read_text().splitlines()


def run_ids(results_dir) -> set[str]:
    return {rec["run_id"] for rec in Journal(
        os.path.join(results_dir, "journal.jsonl")).records()}


def result_files(results_dir) -> list[str]:
    return sorted(f for f in os.listdir(results_dir) if f.endswith(".txt"))


def test_weight_sweep_writes_records_and_resumes(tmp_path):
    """W = 1..2 writes both result files; a rerun replays the journal to
    the same statistics and appends no journal line."""
    cfg = load_init_file(init_file(
        tmp_path, f"{SPEC} 1 2 256 20 0.02 seed=5 batch_size=32 "
                  f"steps_per_call=2 device=cpu results_dir={tmp_path}/r "
                  f"log_file={tmp_path}/log.txt"))
    first = cli.run_sweep(cfg)
    assert [s.error_weight for s in first] == [1, 2]
    assert all(s.num_errors_tested == 256 for s in first)
    files = result_files(f"{tmp_path}/r")
    assert len(files) == 2 and "_W_1_MAX_20_p_0.02.txt" in files[0]
    rec = parse_reference_text(Path(tmp_path, "r", files[0]).read_text())[0]
    assert rec["Errors Tested"] == "256" and rec["Rand Seed"] == "5"
    lines = journal_lines(f"{tmp_path}/r")
    assert len(lines) == 8  # 4 groups of 2 chunks per weight
    second = cli.run_sweep(cfg)
    for a, b in zip(first, second):
        assert (a.corrected, a.logical_errors, a.syndrome_errors_x,
                a.syndrome_errors_z, a.total_bp_iterations) == (
            b.corrected, b.logical_errors, b.syndrome_errors_x,
            b.syndrome_errors_z, b.total_bp_iterations)
    assert journal_lines(f"{tmp_path}/r") == lines
    assert Path(tmp_path, "log.txt").read_text().count("resuming") == 2
    # each point's file holds one record per run
    assert len(parse_reference_text(
        Path(tmp_path, "r", files[1]).read_text())) == 2


@pytest.mark.parametrize("cut", [0, 3, 7])
def test_cut_and_torn_journal_resumes_exactly(tmp_path, cut):
    """A journal cut to its first ``cut`` lines, ending in a torn line,
    resumes to the uncut run's counters bit for bit."""
    line = (f"{SPEC} 3 3 512 20 0.02 seed=11 batch_size=32 steps_per_call=2 "
            f"algorithm=min-sum device=cpu log_file={tmp_path}/log.txt")
    whole = cli.run_sweep(load_init_file(init_file(
        tmp_path, line + f" results_dir={tmp_path}/whole")))[0]
    lines = journal_lines(f"{tmp_path}/whole")
    assert len(lines) == 8
    os.makedirs(f"{tmp_path}/cut")
    Path(tmp_path, "cut", "journal.jsonl").write_text(
        "".join(x + "\n" for x in lines[:cut]) + lines[cut][: len(lines[cut]) // 2])
    resumed = cli.run_sweep(load_init_file(init_file(
        tmp_path, line + f" results_dir={tmp_path}/cut")))[0]
    for f in ("corrected", "logical_errors", "syndrome_errors_x",
              "syndrome_errors_z", "convergence_fail_x", "convergence_fail_z",
              "num_x_errors_tested", "num_z_errors_tested",
              "total_bp_iterations"):
        assert getattr(resumed, f) == getattr(whole, f), f
    # the torn line is ended; the resumed records follow it line by line
    after = journal_lines(f"{tmp_path}/cut")
    assert after[:cut] == lines[:cut] and after[cut + 1:] == lines[cut:]


@pytest.fixture(scope="module")
def jax_and_port_runs(tmp_path_factory):
    """The same init file through both CLIs (JAX without a mesh), 4,096
    samples; then the port again in the JAX run's results directory."""
    tmp = tmp_path_factory.mktemp("both")
    code_file = tmp / "code.txt"
    save_code_file(construct_code(3, 3, 6, 7, 2, 3), str(code_file))
    line = ("code.txt 3 3 4096 20 0.02 seed=5 batch_size=512 "
            "use_mesh=false steps_per_call=4")
    theirs = jax_cli.run_sweep(jax_config.load_init_file(init_file(
        tmp, line + f" results_dir={tmp}/jax log_file={tmp}/jax.txt")))
    ours = cli.run_sweep(load_init_file(init_file(
        tmp, line + f" device=cpu results_dir={tmp}/port "
                    f"log_file={tmp}/port.txt")))
    jax_lines = journal_lines(f"{tmp}/jax")
    jax_ids = run_ids(f"{tmp}/jax")
    again = cli.run_sweep(load_init_file(init_file(
        tmp, line + f" device=cpu results_dir={tmp}/jax "
                    f"log_file={tmp}/again.txt")))
    return tmp, theirs, ours, jax_lines, jax_ids, again


def test_same_files_records_and_counts_as_jax(jax_and_port_runs):
    tmp, theirs, ours, *_ = jax_and_port_runs
    assert result_files(f"{tmp}/port") == result_files(f"{tmp}/jax")
    name = result_files(f"{tmp}/port")[0]
    port_rec = parse_reference_text(Path(tmp, "port", name).read_text())[0]
    jax_rec = parse_reference_text(Path(tmp, "jax", name).read_text())[0]
    assert list(port_rec) == list(jax_rec)
    (a,), (b,) = ours, theirs
    assert a.num_errors_tested == b.num_errors_tested == 4096
    assert a.code_str == b.code_str and a.rand_seed == b.rand_seed
    z = two_proportion_z(a.corrected, 4096, b.corrected, 4096)
    assert abs(z) < 4, (a, b, z)
    assert a.num_devices == 1


def test_port_run_id_is_jax_plus_device(jax_and_port_runs):
    tmp, _, _, _, jax_ids, _ = jax_and_port_runs
    (jax_id,) = jax_ids
    assert run_ids(f"{tmp}/port") == {jax_id + "|torch=cpu"}


def test_jax_journal_is_not_resumed(jax_and_port_runs):
    """The port's draw streams differ from JAX's: a JAX-written journal in
    the results directory starts the port afresh, never blends."""
    tmp, _, ours, jax_lines, _, again = jax_and_port_runs
    assert "resuming" not in Path(tmp, "again.txt").read_text()
    lines = journal_lines(f"{tmp}/jax")
    assert lines[: len(jax_lines)] == jax_lines
    assert len(lines) == 2 * len(jax_lines)
    assert again[0].corrected == ours[0].corrected


def _stub(progress=None, **_):
    progress(0, 1, np.zeros(9, np.int64), 0)
    return np.zeros(9, np.int64), 0


@pytest.mark.parametrize("extra", [
    "", "algorithm=min-sum relay=3", "algorithm=min-sum osd=0",
    "osd=2 relay=2 algorithm=layered-min-sum", "logical_test=physical",
    "p_values=0.01,0.03", "error_model=depolarizing", "steps_per_call=5"])
@pytest.mark.parametrize("weights", ["2 2", "1 3"])
def test_run_id_matches_jax(tmp_path, monkeypatch, extra, weights):
    """The port's run_id is JAX's followed by ``|torch=cpu``, with relay's
    draw rule (``RELAY_DRAWS_TAG``) after the relay fields: plain, relay,
    osd, physical test, p sweeps and the multi-weight (``wcap``) sweep.
    JAX's drivers are stubbed (its run_id does not depend on their
    results); the port's run for real."""
    line = f"{SPEC} {weights} 64 10 0.02 seed=3 batch_size=32 {extra}"
    monkeypatch.setattr(jax_cli, "run_monte_carlo",
                        lambda *a, **k: _stub(**k))
    monkeypatch.setattr(jax_cli, "run_monte_carlo_osd",
                        lambda *a, **k: _stub(**k))
    jax_cli.run_sweep(jax_config.load_init_file(init_file(
        tmp_path, line + f" use_mesh=false results_dir={tmp_path}/jax "
                         f"log_file={tmp_path}/jax.txt")))
    cli.run_sweep(load_init_file(init_file(
        tmp_path, line + f" device=cpu results_dir={tmp_path}/port "
                         f"log_file={tmp_path}/port.txt")))
    gammas = f"|g={GAMMA_LOW:g}:{GAMMA_HIGH:g}"
    want = {rid.replace(gammas, gammas + cli.RELAY_DRAWS_TAG) + "|torch=cpu"
            for rid in run_ids(f"{tmp_path}/jax")}
    assert run_ids(f"{tmp_path}/port") == want
    assert all((cli.RELAY_DRAWS_TAG in rid) == ("relay" in extra)
               for rid in want)
    assert any("|wcap=8" in rid for rid in want) == (
        weights == "1 3" and "osd" not in extra and "p_values" not in extra
        and "depolarizing" not in extra)


def test_osd_mode_and_its_resume(tmp_path):
    """``osd=`` runs the quality mode on the same samples: no syndrome
    failures, corrected never below plain BP's; it journals post-repair
    counters per chunk, and a rerun resumes to the same record without a
    new journal line."""
    common = (f"{SPEC} 4 4 64 15 0.02 seed=5 batch_size=32 device=cpu "
              f"algorithm=min-sum log_file={tmp_path}/log.txt ")
    base = cli.run_sweep(load_init_file(init_file(
        tmp_path, common + f"results_dir={tmp_path}/base")))[0]
    for lam in (0, 4):
        results = f"{tmp_path}/osd{lam}"
        cfg = load_init_file(init_file(
            tmp_path, common + f"results_dir={results} osd={lam}"))
        first = cli.run_sweep(cfg)[0]
        assert first.num_errors_tested == base.num_errors_tested
        assert first.syndrome_errors_x == first.syndrome_errors_z == 0
        assert first.corrected >= base.corrected
        assert first.corrected + first.logical_errors == first.num_errors_tested
        lines = journal_lines(results)
        assert len(lines) == 2  # one record per chunk (64 / 32)
        second = cli.run_sweep(cfg)[0]
        assert (second.corrected, second.logical_errors) == (
            first.corrected, first.logical_errors)
        assert journal_lines(results) == lines
    assert "resuming" in Path(tmp_path, "log.txt").read_text()


def test_flag_form_and_run_log(tmp_path):
    rc = cli.main(["--code", SPEC, "--w", "2", "--count", "64", "--max", "20",
                   "--p", "0.02", "--seed", "5", "--batch_size", "32",
                   "--algorithm", "min-sum", "--device", "cpu",
                   f"--results_dir={tmp_path}/results",
                   f"--log_file={tmp_path}/log.txt"])
    assert rc == 0
    out = list((tmp_path / "results").glob("*_W_2_MAX_20_p_0.02.txt"))
    assert len(out) == 1
    assert parse_reference_text(out[0].read_text())[0]["Errors Tested"] == "64"
    assert "Run complete." in (tmp_path / "log.txt").read_text()
    with pytest.raises(ValueError, match="malformed code spec"):
        cli.main(["--code", "qc:3,3,6", "--count", "32", "--device", "cpu",
                  f"--results_dir={tmp_path}/r2",
                  f"--log_file={tmp_path}/log.txt"])
    assert "ERROR: malformed code spec" in (tmp_path / "log.txt").read_text()


def test_init_file_form_with_overrides(tmp_path):
    code_file = tmp_path / "code.txt"
    save_code_file(construct_code(3, 3, 6, 7, 2, 3), str(code_file))
    init = init_file(tmp_path, "code.txt 1 1 32 10 0.02 seed=1 batch_size=32")
    assert cli.main([init, "--device", "cpu", "--count=64",
                     f"--results_dir={tmp_path}/r",
                     f"--log_file={tmp_path}/log.txt"]) == 0
    (name,) = result_files(f"{tmp_path}/r")
    assert parse_reference_text(
        Path(tmp_path, "r", name).read_text())[0]["Errors Tested"] == "64"


def test_default_device_without_a_card_raises(tmp_path):
    """``device=cuda`` is the default; with no card the run raises before
    any work, naming ``--device cpu``, and never falls back."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--code", SPEC, "--count", "32",
                  f"--results_dir={tmp_path}/r",
                  f"--log_file={tmp_path}/log.txt"])
    assert not (tmp_path / "r").exists()
    assert "ERROR: device='cuda'" in (tmp_path / "log.txt").read_text()


def test_module_without_arguments_prints_usage_and_loads_no_jax():
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m",
         "qec_ldpc_tpu_torch.harness.cli"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert "Usage: python -m qec_ldpc_tpu_torch.harness.cli" in proc.stderr
    imported = {line.rsplit("|", 1)[1].strip()
                for line in proc.stderr.splitlines()
                if line.startswith("import time:") and "|" in line}
    assert "qec_ldpc_tpu_torch.harness.cli" in imported or "torch" in imported
    bad = sorted(m for m in imported
                 if m in ("jax", "qec_ldpc_tpu")
                 or m.startswith(("jax.", "qec_ldpc_tpu.")))
    assert not bad, bad
