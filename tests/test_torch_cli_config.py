"""The port's run configuration and code specs (harness/config.py and
harness/cli.py's parsing) against the JAX package's, in one process: init
files, options, result-file names, sweep points, the decode config, the
flag form, every code-spec form and the shipped-iMinusP rule.  Code files
are written with the port's ``save_code_file`` (the reference directory the
JAX package's own CLI tests read is not needed)."""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from qec_ldpc_tpu.harness import cli as jax_cli
from qec_ldpc_tpu.harness import config as jax_config
from qec_ldpc_tpu_torch import construct_code
from qec_ldpc_tpu_torch.codes import save_code_file
from qec_ldpc_tpu_torch.convert import bpconfig_from_jax
from qec_ldpc_tpu_torch.harness import cli, config
from qec_ldpc_tpu_torch.sampling import RankBasisTest

torch.set_num_threads(1)

SPECS = ["qc:3,3,6,7,2,3", "qc:4,5,10,61,9,49", "bb:[[144,12,12]]",
         "bb:l=12,m=6,A=x3+y+y2,B=y3+x+x2", "toric:3",
         "hgp:n1=7,n2=7,h1=1+x+x3,h2=1+y+y3"]
MALFORMED = ["toric:abc", "hgp:n1=3,h1=1+x", "bb:l=12,m=6,A=x3",
             "qc:3,3,6", "hgp:n1=x,n2=7,h1=1,h2=1"]
INIT_TEXTS = [
    "code.txt 1 3 1000 50 0.02\n",
    "code.txt 2 2 4096 100 0.01 seed=7 batch_size=256 algorithm=min-sum\n",
    "qc:3,3,6,7,2,3 1 1 10 5 0.01 use_mesh=off osd=0 relay=4 "
    "logical_test=physical steps_per_call=8 kernel=pallas num_graph=2\n",
    "code.txt 5 5 64 20 0.05 p_values=0.01,0.02 error_model=depolarizing "
    "profile_dir=prof results_dir=out log_file=out/log.txt\n",
]


def fields(cfg) -> dict:
    """The config's fields without the port's ``device``."""
    out = dataclasses.asdict(cfg)
    out.pop("device", None)
    return out


@pytest.fixture(scope="module")
def code_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("code") / "code.txt"
    save_code_file(construct_code(3, 3, 6, 7, 2, 3), str(path))
    return path


def test_same_fields_and_defaults():
    names = [f.name for f in dataclasses.fields(config.RunConfig)]
    assert names == [f.name for f in dataclasses.fields(jax_config.RunConfig)] + ["device"]
    ours = config.RunConfig("c", 1, 2, 3, 4, 0.5)
    assert fields(ours) == fields(jax_config.RunConfig("c", 1, 2, 3, 4, 0.5))
    assert ours.device == "cuda"


@pytest.mark.parametrize("text", INIT_TEXTS)
def test_init_file_fields_match(tmp_path, code_file, text):
    """The same init text gives the same fields; a relative codeFile found
    beside the init file resolves to that file in both."""
    (tmp_path / "code.txt").write_bytes(code_file.read_bytes())
    init = tmp_path / "init.txt"
    init.write_text(text)
    ours = config.load_init_file(str(init))
    assert fields(ours) == fields(jax_config.load_init_file(str(init)))
    if text.startswith("code.txt"):
        assert ours.code_file == str(tmp_path / "code.txt")


@pytest.mark.parametrize("text", ["code.txt 1 1 10 5 0.01 use_mesh=ture\n",
                                  "code.txt 1 1 10 5 0.01 bogus=1\n",
                                  "code.txt 1 1 10 5\n"])
def test_init_file_rejects_in_both(tmp_path, text):
    init = tmp_path / "init.txt"
    init.write_text(text)
    with pytest.raises(ValueError) as ours:
        config.load_init_file(str(init))
    with pytest.raises(ValueError) as theirs:
        jax_config.load_init_file(str(init))
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("key,value", [("use_mesh", "ture"), ("bogus", "1"),
                                       ("count", "x"), ("seed", "1.5")])
def test_apply_option_rejects_in_both(key, value):
    for module in (config, jax_config):
        with pytest.raises(ValueError):
            module.apply_option(module.RunConfig("c", 1, 1, 1, 1, 0.1), key,
                                value)


@pytest.mark.parametrize("value,want", [("on", True), ("No", False),
                                        ("1", True), ("false", False)])
def test_apply_option_booleans(value, want):
    ours = config.RunConfig("c", 1, 1, 1, 1, 0.1)
    theirs = jax_config.RunConfig("c", 1, 1, 1, 1, 0.1)
    config.apply_option(ours, "use_mesh", value)
    jax_config.apply_option(theirs, "use_mesh", value)
    assert ours.use_mesh is theirs.use_mesh is want


@pytest.mark.parametrize("spec", SPECS)
def test_code_specs_match(spec):
    """Every spec form builds the JAX package's code: the same name and the
    same parity-check matrices."""
    code, graphs = cli.load_code_and_graphs(spec)
    jcode, _ = jax_cli.load_code_and_graphs(spec)
    assert str(code) == str(jcode)
    for ours, theirs in (("pcm_x", "pcm_x"), ("pcm_z", "pcm_z")):
        np.testing.assert_array_equal(getattr(code, ours), getattr(jcode, theirs))
    assert graphs.x.num_checks == code.pcm_x.shape[0]


def test_code_file_spec_matches(code_file):
    code, _ = cli.load_code_and_graphs(str(code_file))
    jcode, _ = jax_cli.load_code_and_graphs(str(code_file))
    assert str(code) == str(jcode)
    np.testing.assert_array_equal(code.i_minus_p, jcode.i_minus_p)


@pytest.mark.parametrize("spec", MALFORMED)
def test_malformed_specs_raise_in_both(spec):
    with pytest.raises(ValueError, match="malformed code spec") as ours:
        cli.load_code_and_graphs(spec)
    with pytest.raises(ValueError, match="malformed code spec") as theirs:
        jax_cli.load_code_and_graphs(spec)
    assert str(ours.value).split(" (")[0] == str(theirs.value).split(" (")[0]


@pytest.mark.parametrize("spec", SPECS)
def test_result_filename_matches(spec):
    code, _ = cli.load_code_and_graphs(spec)
    jcode, _ = jax_cli.load_code_and_graphs(spec)
    assert (config.format_result_filename(str(code), 15, 100, 0.01)
            == jax_config.format_result_filename(str(jcode), 15, 100, 0.01))


@settings(max_examples=60, deadline=None)
@given(p=st.floats(min_value=1e-9, max_value=0.999, allow_nan=False),
       w=st.integers(min_value=0, max_value=100000),
       m=st.integers(min_value=1, max_value=10000))
def test_result_filename_matches_any_point(p, w, m):
    name = "[J=4,K=5,L=10,P=61,s=9,t=49][[n=610,k=61]]"
    assert (config.format_result_filename(name, w, m, p)
            == jax_config.format_result_filename(name, w, m, p))


@pytest.mark.parametrize("p_values", ["", "0.001, 0.01 0.02", "0.05"])
def test_sweep_points_match(p_values):
    ours = config.RunConfig("c", 2, 5, 100, 50, 0.01, p_values=p_values)
    theirs = jax_config.RunConfig("c", 2, 5, 100, 50, 0.01, p_values=p_values)
    assert ours.sweep_points() == theirs.sweep_points()


@pytest.mark.parametrize("kernel", ["auto", "xla", "pallas"])
@pytest.mark.parametrize("num_graph", [1, 2])
@pytest.mark.parametrize("algorithm", ["sum-product", "min-sum",
                                       "layered-min-sum"])
def test_bp_config_matches_cpu_backend(kernel, num_graph, algorithm):
    kw = dict(kernel=kernel, num_graph=num_graph, algorithm=algorithm)
    ours = config.RunConfig("c", 1, 1, 10, 37, 0.01, **kw).bp_config()
    theirs = jax_config.RunConfig("c", 1, 1, 10, 37, 0.01, **kw).bp_config()
    assert ours == bpconfig_from_jax(theirs)


@pytest.mark.parametrize("argv", [
    ["--code", "qc:3,3,6,7,2,3", "--w", "2", "--count", "64", "--max", "20",
     "--p", "0.02", "--seed", "5", "--batch_size=32", "--algorithm",
     "min-sum", "--results_dir=out/r", "--use_mesh", "false"],
    ["--code=bb:[[144,12,12]]", "--error_model", "depolarizing",
     "--p_values", "0.01", "--osd", "0", "--relay=3"],
    ["--code", "x", "--w", "3", "--W", "7"],
])
def test_flag_form_parses_equally(argv):
    assert fields(cli._config_from_flags(argv)) == fields(
        jax_cli._config_from_flags(argv))


@pytest.mark.parametrize("argv,match", [
    (["--w", "3"], "--code"),
    (["--code", "x", "--bogus", "1"], "unknown option"),
    (["--code"], "needs a value"),
    (["--code", "x", "--w", "5", "--W", "2"], "below"),
    (["--code", "x", "--use_mesh", "ture"], "use_mesh"),
    (["code", "x"], "expected --flag"),
])
def test_flag_form_raises_in_both(argv, match):
    with pytest.raises(ValueError, match=match) as ours:
        cli._config_from_flags(argv)
    with pytest.raises(ValueError, match=match) as theirs:
        jax_cli._config_from_flags(argv)
    assert str(ours.value) == str(theirs.value)


def test_flag_overrides_on_an_init_file(tmp_path, code_file):
    init = tmp_path / "init.txt"
    init.write_text(f"{code_file} 1 1 100 5 0.01\n")
    tokens = ["--results_dir", "out/x", "--count=5", "--device", "cpu"]
    ours = config.load_init_file(str(init))
    cli._apply_flag_values(ours, cli._parse_flag_tokens(tokens))
    theirs = jax_config.load_init_file(str(init))
    jax_cli._apply_flag_values(theirs, jax_cli._parse_flag_tokens(tokens[:-2]))
    assert fields(ours) == fields(theirs)
    assert ours.count == 5 and ours.device == "cpu"


def test_shipped_i_minus_p_wins_when_it_differs(tmp_path):
    """A code file whose iMinusP has another kernel than the PCM-derived
    one classifies with the file's matrix, with the JAX package's note; an
    equivalent one keeps the rank-basis test."""
    code = construct_code(3, 3, 6, 7, 2, 3)
    same, odd = tmp_path / "same.txt", tmp_path / "odd.txt"
    save_code_file(code, str(same))
    shipped = code.i_minus_p.copy()
    shipped[: len(shipped) // 2] = 0  # drop the X sector: another kernel
    save_code_file(dataclasses.replace(code, _i_minus_p=shipped), str(odd))

    test, note = cli.resolve_logical_test_for_code(
        cli.load_code_and_graphs(str(same))[0], "reference", "cpu")
    assert isinstance(test, RankBasisTest) and note is None

    ours, note = cli.resolve_logical_test_for_code(
        cli.load_code_and_graphs(str(odd))[0], "reference", "cpu")
    jcode, _ = jax_cli.load_code_and_graphs(str(odd))
    theirs, jnote = jax_cli.resolve_logical_test_for_code(jcode, "reference")
    assert note is not None and note == jnote
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    # the physical convention never takes the file's matrix
    test, note = cli.resolve_logical_test_for_code(
        cli.load_code_and_graphs(str(odd))[0], "physical", "cpu")
    assert isinstance(test, RankBasisTest) and note is None
