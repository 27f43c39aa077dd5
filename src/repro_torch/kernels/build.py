"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, loaded with ``ctypes``.
Libraries land in ``build/`` beside this file (listed in .gitignore),
named by a hash of the sources and flags, so an edited source never
loads a stale library.  All missing libraries are built at once, one
``nvcc`` process per source started together.  Nothing is built when
this module is imported: the first ``load`` builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
NAMES = ("paged_prefill_attention", "paged_decode_attention",
         "paged_mla_decode_attention", "paged_cross_decode_attention")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or CUDA_HOME)")


def library_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=NAMES) -> Dict[str, str]:
    """Compile every library of ``names`` that is not built yet, all in
    parallel.  Returns {name: ptxas report} for the ones compiled now.
    Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    procs: List[tuple] = []
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    reports, failed = {}, []
    for n, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}:\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        reports[n] = log
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build()
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


# -- binding helpers shared by the kernel wrappers -----------------------
DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}
MAX_SMEM = 232_448      # bytes of shared memory one H100 block may use


def check_smem(kernel: str, rows: int, hd: int, hd_v: int,
               tile_pages: int, page: int) -> None:
    """Raise if a block of ``rows`` query rows needs more shared memory
    than the card gives one block (mirrors ``smem_bytes`` in
    ``csrc/paged_attention.cuh``)."""
    tile_tok = tile_pages * page
    need = 4 * (rows * (hd + 1) + tile_tok * (hd + 1) + tile_tok * hd_v
                + rows * (tile_tok + 1) + rows * hd_v + 3 * rows
                + tile_pages)
    if need > MAX_SMEM:
        raise ValueError(f"{kernel}: {need} B of shared memory needed, "
                         f"{MAX_SMEM} B available (head dims too wide)")


def check_cuda(name: str, t, *, ndim: int, dtypes, device) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``ndim`` dims,
    one of ``dtypes`` (names such as "torch.int32"), on ``device``."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()} dims, expected {ndim}")
    if str(t.dtype) not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {sorted(dtypes)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def check_pool_rows(kernel: str, pool, width: int) -> None:
    """The kernels load pool rows 16 bytes at a time (and split value
    rows into groups of 4): each token's ``width`` values and the pool's
    start must be 16-byte aligned."""
    if (width * pool.element_size()) % 16 or pool.data_ptr() % 16:
        raise ValueError(f"{kernel}: pool rows of {width} "
                         f"{pool.dtype} values at {pool.data_ptr():#x} are "
                         "not 16-byte aligned")


def raise_on_error(kernel: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")
