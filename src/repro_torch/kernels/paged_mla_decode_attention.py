"""Paged MLA decode attention (absorbed form): CUDA kernel wrapper.

Replaces ``src/repro/kernels/paged_mla_decode_attention.py``
(``paged_mla_decode_attention`` -> ``pl.pallas_call``).  Every decode
iteration of an MLA model runs the whole slot batch through it, every
layer; empty slots carry ``lens = 0`` and get zeros.

The kernel (``csrc/paged_mla_decode_attention.cu``) runs one block per
(slot, group of ``hg`` heads, split of the block-table slots): each live
latent page is loaded once per block as one [ckv | kr] tile that serves
both the scores and PV, and a second small launch combines the splits'
partial softmax states.  The head count must be a multiple of 4 and the
latent widths multiples of 4 (of 8 for bf16 pools).  The queries, the
pools and the output may differ in dtype, as in the reference (f32
queries against a bf16 pool): the output takes q_lat's dtype.

On a CPU tensor the wrapper runs the plain version
(``ref.paged_mla_decode_attention``); on a CUDA tensor it launches the
kernel or raises.  ``paged_mla_decode_attention.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

NAME = "paged_mla_decode_attention"
SLOTS_PER_SPLIT = 8     # block-table slots one block covers
HEAD_GROUPS = (16, 8, 4)   # heads per block, largest that fits
MAX_ACC = 8192          # hg * lora: 2 PV items of 4 x 4 per thread
_FLOATS = ("torch.float32", "torch.bfloat16")
_I32 = ("torch.int32",)
_P, _I = ctypes.c_void_p, ctypes.c_int


def smem_bytes(hg: int, lora: int, rope: int, page: int) -> int:
    """Shared memory of one block (mirrors ``smem_bytes`` in the .cu)."""
    w = lora + rope
    wp = w + (4 if (w // 4) % 2 == 0 else 8)
    return 4 * (hg * wp + page * wp + page * hg + 3 * hg)


def head_group(h: int, lora: int, rope: int, page: int) -> int:
    """Heads per block: the largest of HEAD_GROUPS that divides h, keeps
    the PV accumulators in registers and fits one block's shared
    memory."""
    for hg in HEAD_GROUPS:
        if (h % hg == 0 and hg * lora <= MAX_ACC
                and smem_bytes(hg, lora, rope, page) <= build.MAX_SMEM):
            return hg
    raise ValueError(f"{NAME}: no head group of {HEAD_GROUPS} fits h {h}, "
                     f"lora {lora}, rope {rope}, page {page} (h must be a "
                     f"multiple of 4, hg * lora at most {MAX_ACC}, shared "
                     f"memory at most {build.MAX_SMEM} B)")


def _launcher():
    fn = build.load(NAME).paged_mla_decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 8 + [_I] * 9 + [ctypes.c_float, _I, _I, _P]
        fn.restype = _I
    return fn


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
    b, h, lora = q_lat.shape
    rope = q_rope.shape[2]
    n_pages, page = ckv_pool.shape[:2]
    n_slots = block_table.shape[1]
    if (q_rope.shape[:2] != (b, h) or ckv_pool.shape[2] != lora
            or kr_pool.shape != (n_pages, page, rope)
            or block_table.shape[0] != b or lens.shape != (b,)
            or min(b, n_slots) < 1):
        raise ValueError(
            f"{NAME}: shapes q_lat {tuple(q_lat.shape)}, q_rope "
            f"{tuple(q_rope.shape)}, pools {tuple(ckv_pool.shape)}/"
            f"{tuple(kr_pool.shape)}, block_table "
            f"{tuple(block_table.shape)}, lens {tuple(lens.shape)} do not "
            "fit")
    hg = head_group(h, lora, rope, page)
    build.check_pool_rows(NAME, ckv_pool, lora)
    build.check_pool_rows(NAME, kr_pool, rope)
    splits = -(-n_slots // SLOTS_PER_SPLIT)
    part = torch.empty((b, h // hg, splits, hg * (lora + 2)),
                       dtype=torch.float32, device=dev)
    out = torch.empty((b, h, lora), dtype=q_lat.dtype, device=dev)
    err = _launcher()(
        q_lat.data_ptr(), q_rope.data_ptr(), ckv_pool.data_ptr(),
        kr_pool.data_ptr(), block_table.data_ptr(), lens.data_ptr(),
        part.data_ptr(), out.data_ptr(), b, h, hg, lora, rope, page,
        n_slots, SLOTS_PER_SPLIT, int(window), float(scale),
        build.DTYPE_CODES[str(q_lat.dtype)],
        build.DTYPE_CODES[str(ckv_pool.dtype)],
        torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on_error(NAME, err)
    paged_mla_decode_attention.launches += 1
    return out


paged_mla_decode_attention.launches = 0
