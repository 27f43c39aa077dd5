"""What the benchmark may not do: import JAX or the JAX package, read
the JAX package's benchmark scripts, or fall back to the CPU."""
import ast
import json
import os
import subprocess
import sys

from portbench.serve import loaded_forbidden
from portbench.tests.conftest import CHECKOUT, make_tiny

PB = CHECKOUT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _sources():
    return [p for p in PB.rglob("*.py") if "tests" not in p.parts]


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)


def test_no_source_names_the_jax_benchmarks():
    for path in _sources():
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value,
                                                             str):
                assert "benchmarks" not in node.value.replace(
                    "portbench", ""), (path, node.value)


def test_forbidden_names_compared_whole():
    assert loaded_forbidden(["repro_torch", "repro_torch.models",
                             "jaxtyping", "numpy"]) == []
    assert loaded_forbidden(["repro.models", "jax._src"]) == ["jax",
                                                             "repro"]


def _run(cwd, *extra_env):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **dict(extra_env))
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "opt13b.mixed",
         "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_run_without_a_card_fails_and_prints_no_result():
    p = _run(CHECKOUT)
    assert p.returncode != 0
    lines = p.stdout.strip().splitlines()
    assert not lines or not lines[-1].startswith("{")
    with_tiny = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    assert with_tiny["workloads"]


def test_run_without_the_program_fails(tmp_path):
    root = make_tiny(tmp_path)
    (root / "BENCHMARK.json").write_text(
        (CHECKOUT / "BENCHMARK.json").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "opt13b.mixed",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert not p.stdout.strip()
    assert "repro_torch" in p.stderr
