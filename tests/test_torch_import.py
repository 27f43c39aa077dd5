"""The PyTorch port stands alone: every module of ``repro_torch`` imports
with JAX blocked, and no module of it (nor ``chip_smoke.py``) imports
``jax`` or the JAX package ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_every_port_module_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib, pkgutil, repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    # configs, core, core.sched, kernels, kvcache, models, runtime + leaves
    assert int(res.stdout.strip()) >= 20


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__", "importorskip")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_no_port_file_imports_jax_or_the_jax_package():
    files = _port_files()
    assert (ROOT / "chip_smoke.py") in files and len(files) > 20
    bad = []
    for f in files:
        for name in _imported_roots(f):
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "repro") or name.startswith(
                    "jax."):
                bad.append(f"{f.relative_to(ROOT)}: {name}")
    assert not bad, bad


def test_kernel_sources_ship_with_the_port():
    """Both CUDA kernels build from sources in the checkout."""
    from repro_torch.kernels import build
    for name in build.NAMES:
        assert (build.CSRC / f"{name}.cu").is_file(), name
        text = (build.CSRC / f"{name}.cu").read_text()
        assert f'extern "C" int {name}_launch(' in text
        assert "src/repro/kernels/" in text     # names the TPU kernel


def test_async_slice_modules_stand_alone():
    """The wall-clock runtime, the open-loop client and the arrival
    processes import with JAX and ``repro`` blocked, and none names
    either."""
    mods = ("repro_torch.serving.async_runtime",
            "repro_torch.serving.arrivals", "repro_torch.fleet.traces")
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for n in {mods!r}:\n"
            "    importlib.import_module(n)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    for name in mods:
        path = ROOT / "src" / (name.replace(".", "/") + ".py")
        roots = {n.split(".")[0] for n in _imported_roots(path)}
        assert not roots & {"jax", "jaxlib", "repro"}, (name, roots)
