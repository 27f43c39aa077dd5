"""Paged decode attention (one query token per slot): CUDA kernel wrapper.

Replaces ``src/repro/kernels/paged_decode_attention.py``
(``paged_decode_attention`` -> ``pl.pallas_call``).  Every decode
iteration runs the whole slot batch through it, every layer; empty
slots carry ``lens = 0`` and get zeros.

The kernel (``csrc/paged_decode_attention.cu``) runs the decode body of
``csrc/decode_attention.cuh``, shared with the cross decode kernel: one
block per (slot, KV head, split of the slot's live pages), the rep query
heads of a KV head sharing each page the block reads, and the splits
combined in the same launch.  On an H100 decode is bound by those
bytes; see the sources for the design and ``decode_plan`` for the
launch.  ``launch`` here is the host side of both decode wrappers.

On a CPU tensor the wrapper runs the plain version
(``ref.paged_decode_attention``); on a CUDA tensor it launches the
kernel or raises.  ``paged_decode_attention.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
from array import array

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.decode_plan import decode_plan
from repro_torch.kernels.prefill_plan import sm_count

NAME = "paged_decode_attention"
_FLOATS = ("torch.float32", "torch.bfloat16")
_I32 = ("torch.int32",)
_launchers: dict = {}


def _launcher(name: str, symbol: str):
    fn = _launchers.get(symbol)
    if fn is None:
        fn = getattr(build.load(name), symbol)
        # the launch's pointers and sizes packed in one int64 array
        fn.argtypes = [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launchers[symbol] = fn
    return fn


def _fits(q, k_pool, v_pool, block_table, lens) -> bool:
    """What ``_check`` holds, in one pass for the common case: types,
    ranks, one device, contiguity, 16-byte rows."""
    dev, dt = q.device, q.dtype
    return ((dt is torch.bfloat16 or dt is torch.float32)
            and k_pool.dtype is dt and v_pool.dtype is dt
            and block_table.dtype is torch.int32
            and lens.dtype is torch.int32 and q.dim() == 3
            and k_pool.dim() == 4 and v_pool.dim() == 4
            and block_table.dim() == 2 and lens.dim() == 1
            and k_pool.device == dev and v_pool.device == dev
            and block_table.device == dev and lens.device == dev
            and q.is_contiguous() and k_pool.is_contiguous()
            and v_pool.is_contiguous() and block_table.is_contiguous()
            and lens.is_contiguous()
            and not q.shape[2] * q.element_size() % 16
            and not v_pool.shape[3] * q.element_size() % 16
            and not (q.data_ptr() | k_pool.data_ptr()
                     | v_pool.data_ptr()) % 16)


def _check(name, q, k_pool, v_pool, block_table, lens) -> None:
    """Raise, naming the fault, unless the tensors fit the kernel."""
    dev = q.device
    build.check_cuda("q", q, ndim=3, dtypes=_FLOATS, device=dev)
    for arg, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        build.check_cuda(arg, t, ndim=4, dtypes=(str(q.dtype),), device=dev)
    build.check_cuda("block_table", block_table, ndim=2, dtypes=_I32,
                     device=dev)
    build.check_cuda("lens", lens, ndim=1, dtypes=_I32, device=dev)
    build.check_pool_rows(name, q, q.shape[2])
    build.check_pool_rows(name, k_pool, k_pool.shape[3])
    build.check_pool_rows(name, v_pool, v_pool.shape[3])


def launch(name: str, symbol: str, q, k_pool, v_pool, block_table, lens,
           window: int):
    """Check a decode call's CUDA tensors, plan it and launch ``symbol``
    of kernel ``name``'s library: the host side of kernels 2 and 4."""
    if not _fits(q, k_pool, v_pool, block_table, lens):
        _check(name, q, k_pool, v_pool, block_table, lens)
    dev = q.device
    b, h, hd = q.shape
    n_pages, page, kvh, hd_k = k_pool.shape
    hd_v = v_pool.shape[3]
    n_slots = block_table.shape[1]
    if (hd_k != hd or v_pool.shape[:3] != k_pool.shape[:3] or h % kvh
            or block_table.shape[0] != b or lens.shape[0] != b
            or min(b, n_slots) < 1):
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, block_table "
            f"{tuple(block_table.shape)}, lens {tuple(lens.shape)} do not "
            "fit")
    plan = decode_plan(q.dtype, b, h, kvh, hd, hd_v, page, n_slots,
                       sm_count(dev))
    out = q.new_empty((b, h, hd_v))
    part, counters = build.workspace(
        dev, 0 if plan.splits == 1 else b * h * plan.splits * (hd_v + 2),
        b * kvh)
    args = array("q", (
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_table.data_ptr(), lens.data_ptr(), out.data_ptr(),
        part.data_ptr(), counters.data_ptr(), b, h, kvh, hd, page, n_slots,
        plan.splits, int(window), build.DTYPE_CODES[str(q.dtype)]))
    err = _launcher(name, symbol)(args.buffer_info()[0], hd ** -0.5,
                                  build.raw_stream(dev))
    build.raise_on_error(name, err)
    return out


def paged_decode_attention(q, k_pool, v_pool, block_table, lens, *,
                           window: int = 0):
    """q: (b, h, hd), contiguous; k_pool/v_pool: (n_pages, page, kvh,
    hd); block_table: (b, n_slots) int32 physical page ids (pad slots and
    slots that slid out of ``window`` may point at a scratch page — they
    are never read); lens: (b,) int32 tokens in cache per slot; window:
    sliding window in tokens (0 = unlimited).  Returns (b, h, hd_v)."""
    if q.device.type == "cpu":
        return ref.paged_decode_attention(q, k_pool, v_pool, block_table,
                                          lens, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {q.device}")
    out = launch(NAME, "paged_decode_attention_launch", q, k_pool, v_pool,
                 block_table, lens, window)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
