"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, loaded with ``ctypes``.
Libraries land in ``build/`` beside this file (listed in .gitignore),
named by a hash of the sources and flags, so an edited source never
loads a stale library.  All missing libraries are built at once, one
``nvcc`` process per source started together.  Nothing is built when
this module is imported: the first ``load`` builds.  ``load`` is safe to
call from several threads: one lock makes the first use compile each
library once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
# -split-compile=0: optimise a library's kernels on every core (the
# decode libraries hold 64 instantiations each)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-split-compile=0"]
NAMES = ("paged_prefill_attention", "paged_decode_attention",
         "paged_mla_decode_attention", "paged_cross_decode_attention",
         "chunked_prefill_attention")

_loaded: Dict[str, ctypes.CDLL] = {}
# one build at a time in this process: two threads' first uses would
# otherwise compile the same libraries into the same temporary files
# (reentrant: ``load`` holds it around ``build``)
_build_lock = threading.RLock()


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
    with _build_lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = [n for n in names if not library_path(n).exists()]
        procs: List[tuple] = []
        for n in todo:
            out = library_path(n)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{n}.cu")]
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
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failed))
        return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        with _build_lock:
            lib = _loaded.get(name)
            if lib is None:
                build()
                lib = ctypes.CDLL(str(library_path(name)))
                _loaded[name] = lib
    return lib


# -- binding helpers shared by the kernel wrappers -----------------------
DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}
MAX_SMEM = 232_448      # bytes of shared memory one H100 block may use


def attend_smem(rows: int, hd: int, hd_v: int, tile_pages: int,
                page: int) -> int:
    """Shared-memory bytes of one block of the CUDA-core body for
    ``rows`` query rows (mirrors ``smem_bytes`` in
    ``csrc/paged_attention.cuh``)."""
    tile_tok = tile_pages * page
    return 4 * (rows * (hd + 1) + tile_tok * (hd + 1) + tile_tok * hd_v
                + rows * (tile_tok + 1) + rows * hd_v + 3 * rows
                + tile_pages)


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


def raw_stream(device) -> int:
    """The current CUDA stream of ``device`` as a pointer, without the
    Stream object ``torch.cuda.current_stream`` builds (several
    microseconds a call on a busy host)."""
    import torch
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


# (device, raw stream) -> (float32 partial states, int32 split counters)
# of the decode kernels (2, 3 and 4), kept between calls: the counters
# must start at zero and every launch leaves them there.  Launches on one
# stream use them in turn; two streams never share them.  A buffer that
# grows is allocated on its own stream and the old one goes back to the
# caching allocator there, which hands it out again only to later work
# of that stream, after the launches already queued on it.
_workspaces: dict = {}
_workspace_lock = threading.Lock()


def workspace(device, stream: int, n_part: int, n_counters: int):
    """The workspace of ``device``'s raw ``stream`` (the current stream,
    as ``raw_stream`` reads it), grown to at least ``n_part`` floats and
    ``n_counters`` zeroed int32 counters."""
    import torch
    key = (device, stream)
    with _workspace_lock:
        part, counters = _workspaces.get(key, (None, None))
        if part is None or part.numel() < n_part:
            part = torch.empty(max(n_part, 1), dtype=torch.float32,
                               device=device)
        if counters is None or counters.numel() < n_counters:
            counters = torch.zeros(n_counters, dtype=torch.int32,
                                   device=device)
        _workspaces[key] = part, counters
    return part, counters


# the wrappers' launch counters are read-modify-writes shared by every
# thread that launches
_count_lock = threading.Lock()


def count(wrapper, *counters: str) -> None:
    """Add one to each named launch counter of ``wrapper``."""
    with _count_lock:
        for c in counters:
            setattr(wrapper, c, getattr(wrapper, c) + 1)


def raise_on_error(kernel: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")
