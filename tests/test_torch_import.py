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
    """Every CUDA kernel builds from sources in the checkout."""
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


def test_training_slice_modules_stand_alone():
    """The training slice (the train package, the classifier's config,
    the training launcher and the two example modules) imports with JAX
    and ``repro`` blocked, and none names either: ``train/data.py``
    takes ``bucket_of`` and ``generate`` from the port's own copies."""
    mods = ("repro_torch.train.optimizer", "repro_torch.train.trainer",
            "repro_torch.train.data", "repro_torch.launch.train",
            "repro_torch.train_lm", "repro_torch.finetune_predictor",
            "repro_torch.configs.opt_125m_cls", "repro_torch.core.predictor")
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for n in {mods!r}:\n"
            "    importlib.import_module(n)\n"
            "from repro_torch.core.predictor import ModelPredictor\n"
            "from repro_torch.models.model import classify, forward_train\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    for name in mods:
        path = ROOT / "src" / (name.replace(".", "/") + ".py")
        names = set(_imported_roots(path))
        assert not {n.split(".")[0] for n in names} & {
            "jax", "jaxlib", "repro"}, (name, names)
    data = set(_imported_roots(PORT / "train" / "data.py"))
    assert {"repro_torch.core.predictor",
            "repro_torch.runtime.workload"} <= data, data


def test_multi_device_modules_stand_alone():
    """The multi-device layer (sharding rules, the pod handoff, the
    meshes, the specs, op_cost and the dry run) imports with JAX and
    ``repro`` blocked, without joining a process group; the only
    ``torch.testing._internal`` import of the port is the fake group of
    the dry run, inside ``launch/mesh.py`` or ``launch/dryrun.py``."""
    mods = ("repro_torch.models.sharding", "repro_torch.core.disagg",
            "repro_torch.launch.mesh", "repro_torch.launch.specs",
            "repro_torch.launch.op_cost", "repro_torch.launch.dryrun")
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for n in {mods!r}:\n"
            "    importlib.import_module(n)\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized()\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
    allowed = {PORT / "launch" / "mesh.py", PORT / "launch" / "dryrun.py"}
    bad = []
    for f in _port_files():
        for name in _imported_roots(f):
            if name.startswith("torch.testing._internal") and (
                    f not in allowed or name != (
                        "torch.testing._internal.distributed.fake_pg")):
                bad.append(f"{f.relative_to(ROOT)}: {name}")
    assert not bad, bad
