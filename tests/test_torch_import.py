"""The PyTorch port stands apart from JAX: importing it loads no ``jax`` and
no ``qec_ldpc_tpu``, and no file of it imports ``jax`` or anything of
``qec_ldpc_tpu`` (the port keeps its own copy of the NumPy code layer); the
port's benchmark suite (``benchmarks_torch/``) imports none of those nor
the JAX package's ``benchmarks``."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "qec_ldpc_tpu_torch"
PORT_FILES = sorted(p for p in PORT.rglob("*.py") if "_build" not in p.parts) + [
    ROOT / "chip_smoke.py", ROOT / "bench_torch.py", ROOT / "workloads.py",
    # the rank functions that spawned processes import, and the OSD-0
    # kernel's corner cases, which the card's test run imports
    ROOT / "tests" / "torch_mesh_workers.py", ROOT / "tests" / "osd0_cases.py",
    # the examples, which use the port alone
    *sorted((ROOT / "examples_torch").glob("*.py")),
    # the benchmark suite
    *sorted((ROOT / "benchmarks_torch").glob("*.py"))]
BENCHMARK_SCRIPTS = sorted(p.stem for p in (ROOT / "benchmarks_torch").glob("*.py")
                           if p.stem != "__init__")
KERNEL_MODULES = sorted(p.stem for p in (PORT / "kernels").glob("*.py")
                        if p.stem != "__init__")

IMPORT_JAX = re.compile(r"^\s*(import|from)\s+jax\b", re.M)
IMPORT_REFERENCE = re.compile(r"^\s*(?:import|from)\s+qec_ldpc_tpu(?!_torch)\b",
                              re.M)
IMPORT_JAX_BENCHMARKS = re.compile(
    r"^\s*(?:import|from)\s+benchmarks(?!_torch)\b", re.M)


def test_import_leaves_jax_out():
    code = ("import sys\n"
            "import qec_ldpc_tpu_torch, qec_ldpc_tpu_torch.convert\n"
            "import qec_ldpc_tpu_torch.decoder, qec_ldpc_tpu_torch.kernels.bp_cuda\n"
            "import qec_ldpc_tpu_torch.kernels.min_sum_cuda\n"
            "import qec_ldpc_tpu_torch.kernels.layered_cuda\n"
            "import qec_ldpc_tpu_torch.kernels.lifted_min_sum_cuda\n"
            "import qec_ldpc_tpu_torch.kernels.lifted_bp_cuda\n"
            "import qec_ldpc_tpu_torch.kernels.osd0_cuda, qec_ldpc_tpu_torch.native\n"
            "import qec_ldpc_tpu_torch.kernels.sharded_step_cuda\n"
            "import qec_ldpc_tpu_torch.parallel.mesh, qec_ldpc_tpu_torch.parallel.graph_sharded\n"
            "import qec_ldpc_tpu_torch.parallel.mc_graph\n"
            "import qec_ldpc_tpu_torch.parallel.lifted_sharded\n"
            "from qec_ldpc_tpu_torch.parallel import make_lifted_sharded_decoder\n"
            "from qec_ldpc_tpu_torch.decoder import (checked_decode_batch,\n"
            "    validate_decode_result, cn_update, vn_update)\n"
            "from qec_ldpc_tpu_torch.sampling import (classify_batch_np,\n"
            "    logical_error_mask, logical_error_mask_basis)\n"
            "import examples_torch.quickstart, examples_torch.bicycle_demo\n"
            "import examples_torch.quality_pipeline, examples_torch.graph_parallel_demo\n"
            "from qec_ldpc_tpu_torch.parallel import make_mesh, spawn, make_graph_sharded_decoder\n"
            "import tests.torch_mesh_workers\n"
            "import qec_ldpc_tpu_torch.decoder.osd, qec_ldpc_tpu_torch.decoder.osd_device\n"
            "from qec_ldpc_tpu_torch.parallel import run_monte_carlo_osd\n"
            "import qec_ldpc_tpu_torch.sampling, qec_ldpc_tpu_torch.parallel\n"
            "import qec_ldpc_tpu_torch.harness, qec_ldpc_tpu_torch.codes\n"
            "import qec_ldpc_tpu_torch.harness.cli, qec_ldpc_tpu_torch.harness.config\n"
            "import qec_ldpc_tpu_torch.harness.journal, qec_ldpc_tpu_torch.harness.debug\n"
            "import qec_ldpc_tpu_torch.decoder.validate\n"
            "from qec_ldpc_tpu_torch.parallel import (mc_chunk, mc_chunk_arrays,\n"
            "    make_graph_sharded_arrays_chunk, make_graph_sharded_osd_chunk)\n"
            "import bench_torch\n"
            + "".join(f"import benchmarks_torch.{m}\n" for m in BENCHMARK_SCRIPTS) +
            "qec_ldpc_tpu_torch.codes.known_bicycle_code('[[144,12,12]]').build_graphs()\n"
            "qec_ldpc_tpu_torch.codes.toric_code(3).build_graphs()\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m in ('jax', 'qec_ldpc_tpu', 'benchmarks')\n"
            "             or m.startswith(('jax.', 'qec_ldpc_tpu.', 'benchmarks.')))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", KERNEL_MODULES)
def test_kernel_module_imports_first(module):
    """Each module of ``kernels/`` imports in a fresh process before
    anything else of the port: the kernels and the decoder import each
    other, so a module-level use of a half-imported one would fail."""
    proc = subprocess.run(
        [sys.executable, "-c", f"import qec_ldpc_tpu_torch.kernels.{module}"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax(path):
    text = path.read_text()
    assert not IMPORT_JAX.search(text), path
    assert not IMPORT_REFERENCE.search(text), path
    assert not IMPORT_JAX_BENCHMARKS.search(text), path


def test_scan_covers_the_osd_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"qec_ldpc_tpu_torch/native/__init__.py",
            "qec_ldpc_tpu_torch/decoder/osd.py",
            "qec_ldpc_tpu_torch/decoder/osd_device.py",
            "qec_ldpc_tpu_torch/kernels/osd0_cuda.py"} <= names


def test_scan_covers_the_cli_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"qec_ldpc_tpu_torch/harness/cli.py",
            "qec_ldpc_tpu_torch/harness/config.py",
            "qec_ldpc_tpu_torch/harness/journal.py",
            "qec_ldpc_tpu_torch/harness/debug.py",
            "qec_ldpc_tpu_torch/decoder/validate.py"} <= names


def test_scan_covers_the_mesh_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"qec_ldpc_tpu_torch/parallel/mesh.py",
            "qec_ldpc_tpu_torch/parallel/graph_sharded.py",
            "qec_ldpc_tpu_torch/parallel/mc_graph.py",
            "qec_ldpc_tpu_torch/kernels/sharded_step_cuda.py",
            "tests/torch_mesh_workers.py"} <= names


def test_scan_covers_the_bench_and_the_quality_chunks():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert "bench_torch.py" in names
    from qec_ldpc_tpu_torch import parallel

    for name in ("mc_chunk", "mc_chunk_arrays",
                 "make_graph_sharded_arrays_chunk",
                 "make_graph_sharded_osd_chunk"):
        assert callable(getattr(parallel, name)), name


def test_scan_covers_the_lifted_engine_and_the_examples():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"qec_ldpc_tpu_torch/parallel/lifted_sharded.py",
            "examples_torch/quickstart.py", "examples_torch/bicycle_demo.py",
            "examples_torch/quality_pipeline.py",
            "examples_torch/graph_parallel_demo.py"} <= names


def test_scan_covers_the_benchmark_suite():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert set(BENCHMARK_SCRIPTS) == {
        "common", "throughput", "dynamic_weight_real", "relay_tuning",
        "bicycle_ler", "sharded_step_bench", "large_code_real", "scaling",
        "large_code_scaling", "roofline_breakdown",
        # the reference-corpus scripts, and the JAX random stream their
        # --stream jax runs draw
        "golden_sweep", "golden_sweep42", "golden_deep", "golden_dated",
        "ler_sweep", "jax_stream"}
    assert {f"benchmarks_torch/{m}.py" for m in BENCHMARK_SCRIPTS} <= names


# the JAX package's exported names that the port had lacked
EXPORTS = {"decoder": ("checked_decode_batch", "validate_decode_result",
                       "cn_update", "vn_update"),
           "sampling": ("classify_batch_np", "logical_error_mask",
                        "logical_error_mask_basis"),
           "parallel": ("make_lifted_sharded_decoder",)}


@pytest.mark.parametrize("package,name", [(p, n) for p, names in
                                          EXPORTS.items() for n in names])
def test_exports_the_jax_packages_names(package, name):
    import importlib

    port = importlib.import_module(f"qec_ldpc_tpu_torch.{package}")
    assert callable(getattr(port, name))
    assert name in getattr(port, "__all__", [name])
    jax_init = (ROOT / "qec_ldpc_tpu" / package / "__init__.py").read_text()
    assert name in jax_init


def _parallel_imports(name: str):
    """(module imported, inside a function) for each import statement of
    ``qec_ldpc_tpu_torch/parallel/<name>.py``, read from its syntax tree:
    importing it at run time would load every module of the package."""
    import ast

    tree = ast.parse((PORT / "parallel" / f"{name}.py").read_text())
    nested = {id(node) for fn in ast.walk(tree)
              if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
              for node in ast.walk(fn)}
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mods = [f"{node.module}.{a.name}" for a in node.names]
        elif isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        else:
            continue
        out += [(m, id(node) in nested) for m in mods]
    return out


def test_monte_carlo_imports_point_one_way():
    """The Monte-Carlo layer's imports point one way: ``parallel/chunk.py``
    imports neither driver, ``mc_graph`` imports ``chunk`` and never
    ``montecarlo``, and ``montecarlo`` imports everything at module
    level."""
    drivers = ("qec_ldpc_tpu_torch.parallel.montecarlo",
               "qec_ldpc_tpu_torch.parallel.mc_graph")
    chunk = _parallel_imports("chunk")
    assert not [m for m, _ in chunk if m.startswith(drivers)], chunk
    mc_graph = _parallel_imports("mc_graph")
    assert not [m for m, _ in mc_graph if m.startswith(drivers[0])], mc_graph
    assert any(m.startswith("qec_ldpc_tpu_torch.parallel.chunk.")
               for m, _ in mc_graph), mc_graph
    montecarlo = _parallel_imports("montecarlo")
    assert not [m for m, nested in montecarlo if nested], montecarlo
    assert any(m.startswith(drivers[1]) for m, _ in montecarlo), montecarlo
