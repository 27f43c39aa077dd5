"""Paged MLA decode attention (absorbed form): CUDA kernel wrapper.

Replaces ``src/repro/kernels/paged_mla_decode_attention.py``
(``paged_mla_decode_attention`` -> ``pl.pallas_call``).  Every decode
iteration of an MLA model runs the whole slot batch through it, every
layer; empty slots carry ``lens = 0`` and get zeros.

The kernel (``csrc/paged_mla_decode_attention.cu``) runs one block per
(slot, block of heads, split of the slot's live pages): each latent
tile is loaded once a block, in the pool's type, and serves both the
scores and PV; the splits are merged by the last block of a (slot, head
block) in the same launch.  bf16 pools run on the tensor cores
(``mma.sync``; f32 queries as three bf16 terms each, so the f32 output
stays within 2e-5 of the plain version), f32 pools on the CUDA cores;
``mla_plan`` gives the launch and refuses an uninstantiated (lora,
rope).  The queries, the pools and the output may differ in dtype, as
in the reference (f32 queries against a bf16 pool): the output takes
q_lat's dtype.

On a CPU tensor the wrapper runs the plain version
(``ref.paged_mla_decode_attention``); on a CUDA tensor it launches the
kernel or raises.  ``paged_mla_decode_attention.launches`` counts kernel
launches, ``tensor_core_launches`` those on the tensor-core body.
"""
from __future__ import annotations

import ctypes
import functools
from array import array

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.mla_plan import mla_plan
from repro_torch.kernels.prefill_plan import TENSOR_CORE, sm_count

NAME = "paged_mla_decode_attention"
_FLOATS = ("torch.float32", "torch.bfloat16")
_I32 = ("torch.int32",)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load(NAME).paged_mla_decode_attention_launch
    # the launch's pointers and sizes packed in one int64 array
    fn.argtypes = [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _float(t) -> bool:
    return t.dtype is torch.float32 or t.dtype is torch.bfloat16


def _fits(q_lat, q_rope, ckv_pool, kr_pool, block_table, lens) -> bool:
    """What ``_check`` holds, in one pass for the common case: types,
    ranks, one device, contiguity, 16-byte rows."""
    dev = q_lat.device
    return (_float(q_lat) and q_rope.dtype is q_lat.dtype
            and _float(ckv_pool) and kr_pool.dtype is ckv_pool.dtype
            and block_table.dtype is torch.int32
            and lens.dtype is torch.int32 and q_lat.dim() == 3
            and q_rope.dim() == 3 and ckv_pool.dim() == 3
            and kr_pool.dim() == 3 and block_table.dim() == 2
            and lens.dim() == 1 and q_rope.device == dev
            and ckv_pool.device == dev and kr_pool.device == dev
            and block_table.device == dev and lens.device == dev
            and q_lat.is_contiguous() and q_rope.is_contiguous()
            and ckv_pool.is_contiguous() and kr_pool.is_contiguous()
            and block_table.is_contiguous() and lens.is_contiguous()
            and not ckv_pool.shape[2] * ckv_pool.element_size() % 16
            and not kr_pool.shape[2] * kr_pool.element_size() % 16
            and not (q_lat.data_ptr() | q_rope.data_ptr()
                     | ckv_pool.data_ptr() | kr_pool.data_ptr()) % 16)


def _check(q_lat, q_rope, ckv_pool, kr_pool, block_table, lens) -> None:
    """Raise, naming the fault, unless the tensors fit the kernel."""
    dev = q_lat.device
    build.check_cuda("q_lat", q_lat, ndim=3, dtypes=_FLOATS, device=dev)
    build.check_cuda("q_rope", q_rope, ndim=3, dtypes=(str(q_lat.dtype),),
                     device=dev)
    build.check_cuda("ckv_pool", ckv_pool, ndim=3, dtypes=_FLOATS,
                     device=dev)
    build.check_cuda("kr_pool", kr_pool, ndim=3,
                     dtypes=(str(ckv_pool.dtype),), device=dev)
    build.check_cuda("block_table", block_table, ndim=2, dtypes=_I32,
                     device=dev)
    build.check_cuda("lens", lens, ndim=1, dtypes=_I32, device=dev)
    build.check_pool_rows(NAME, q_lat, q_lat.shape[2])
    build.check_pool_rows(NAME, q_rope, q_rope.shape[2])
    build.check_pool_rows(NAME, ckv_pool, ckv_pool.shape[2])
    build.check_pool_rows(NAME, kr_pool, kr_pool.shape[2])


def paged_mla_decode_attention(q_lat, q_rope, ckv_pool, kr_pool,
                               block_table, lens, *, scale: float,
                               window: int = 0):
    """q_lat: (b, h, lora) W_uk-absorbed queries; q_rope: (b, h, rope),
    both contiguous and of one dtype; ckv_pool: (n_pages, page, lora)
    latent pages and kr_pool: (n_pages, page, rope) RoPE-key pages, of
    one dtype; block_table: (b, n_slots) int32 physical page ids (pad
    and slid-out slots may point at a scratch page — they are never
    read); lens: (b,) int32 tokens in cache per slot; scale: softmax
    scale; window: sliding window in tokens (0 = unlimited).  Returns
    o_lat (b, h, lora) in q_lat's dtype."""
    if q_lat.device.type == "cpu":
        return ref.paged_mla_decode_attention(
            q_lat, q_rope, ckv_pool, kr_pool, block_table, lens,
            scale=scale, window=window)
    if q_lat.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {q_lat.device}")
    if not _fits(q_lat, q_rope, ckv_pool, kr_pool, block_table, lens):
        _check(q_lat, q_rope, ckv_pool, kr_pool, block_table, lens)
    dev = q_lat.device
    b, h, lora = q_lat.shape
    rope = q_rope.shape[2]
    n_pages, page = ckv_pool.shape[:2]
    n_slots = block_table.shape[1]
    if (q_rope.shape[:2] != (b, h) or ckv_pool.shape[2] != lora
            or kr_pool.shape != (n_pages, page, rope)
            or block_table.shape[0] != b or lens.shape[0] != b
            or min(b, n_slots) < 1):
        raise ValueError(
            f"{NAME}: shapes q_lat {tuple(q_lat.shape)}, q_rope "
            f"{tuple(q_rope.shape)}, pools {tuple(ckv_pool.shape)}/"
            f"{tuple(kr_pool.shape)}, block_table "
            f"{tuple(block_table.shape)}, lens {tuple(lens.shape)} do not "
            "fit")
    plan = mla_plan(q_lat.dtype, ckv_pool.dtype, b, h, lora, rope, page,
                    n_slots, sm_count(dev))
    out = q_lat.new_empty((b, h, lora))
    n_pairs = b * plan.head_blocks
    part, counters = build.workspace(
        dev, 0 if plan.splits == 1
        else n_pairs * plan.splits * plan.heads * (lora + 2), n_pairs)
    args = array("q", (
        q_lat.data_ptr(), q_rope.data_ptr(), ckv_pool.data_ptr(),
        kr_pool.data_ptr(), block_table.data_ptr(), lens.data_ptr(),
        out.data_ptr(), part.data_ptr(), counters.data_ptr(), b, h, lora,
        rope, page, n_slots, plan.splits, int(window), plan.smem,
        plan.threads, build.DTYPE_CODES[str(q_lat.dtype)],
        build.DTYPE_CODES[str(ckv_pool.dtype)]))
    err = _launcher()(args.buffer_info()[0], float(scale),
                      build.raw_stream(dev))
    build.raise_on_error(NAME, err)
    paged_mla_decode_attention.launches += 1
    if plan.body == TENSOR_CORE:
        paged_mla_decode_attention.tensor_core_launches += 1
    return out


paged_mla_decode_attention.launches = 0
paged_mla_decode_attention.tensor_core_launches = 0
