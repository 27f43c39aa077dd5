"""Chunked-prefill attention over the paged KV pool: CUDA kernel wrapper.

Replaces ``src/repro/kernels/paged_prefill_attention.py``
(``paged_prefill_attention`` -> ``pl.pallas_call``).  One fused call
covers a whole fixed-size prefill chunk: its segments, slices of
different requests, each attend (written prefix ++ this segment)
through their own block-table row, with per-segment ``q_offset`` and
``kv_len``.

The kernel (``csrc/paged_prefill_attention.cu``) runs one block per
(segment, KV head, q tile); the rep query heads of a KV head share
each K/V page the block reads.  On an H100 the work is bound by its
operations, which this first version does as f32 FMAs on the CUDA
cores; see the source for the design.

On a CPU tensor the wrapper runs the plain version
(``ref.paged_prefill_attention``); on a CUDA tensor it launches the
kernel or raises.  ``paged_prefill_attention.launches`` counts kernel
launches, and ``paged_prefill_attention.noncausal_launches`` those of
them with ``causal=False`` (the cross-attention read of a chunk).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

NAME = "paged_prefill_attention"
ROWS_PER_BLOCK = 64     # query rows (positions x rep heads) per block
TILE_TOKENS = 64        # keys per shared-memory K/V tile
_FLOATS = ("torch.float32", "torch.bfloat16")
_I32 = ("torch.int32",)
_P, _I = ctypes.c_void_p, ctypes.c_int


def _launcher():
    fn = build.load(NAME).paged_prefill_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 7 + [_I] * 12 + [ctypes.c_float, _I, _P]
        fn.restype = _I
    return fn


def paged_prefill_attention(q, k_pool, v_pool, block_table, kv_len,
                            q_offset, *, window: int = 0,
                            causal: bool = True):
    """q: (segs, sq, h, hd); k_pool/v_pool: (n_pages, page, kvh, hd)
    with each segment's tokens already scattered into its pages;
    block_table: (segs, n_slots) int32 physical page ids (pad slots may
    point at a scratch page — masked by ``kv_len``); kv_len: (segs,)
    int32 valid tokens after the segment append; q_offset: (segs,) int32
    absolute position of each segment's first query.
    Returns (segs, sq, h, hd_v) in q's dtype."""
    if q.device.type == "cpu":
        return ref.paged_prefill_attention(
            q, k_pool, v_pool, block_table, kv_len, q_offset,
            window=window, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {q.device}")
    dev = q.device
    build.check_cuda("q", q, ndim=4, dtypes=_FLOATS, device=dev)
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        build.check_cuda(name, t, ndim=4, dtypes=(str(q.dtype),),
                         device=dev)
    build.check_cuda("block_table", block_table, ndim=2, dtypes=_I32,
                     device=dev)
    build.check_cuda("kv_len", kv_len, ndim=1, dtypes=_I32, device=dev)
    build.check_cuda("q_offset", q_offset, ndim=1, dtypes=_I32, device=dev)
    b, sq, h, hd = q.shape
    n_pages, page, kvh, hd_k = k_pool.shape
    hd_v = v_pool.shape[3]
    n_slots = block_table.shape[1]
    if (hd_k != hd or v_pool.shape[:3] != k_pool.shape[:3] or h % kvh
            or block_table.shape[0] != b or kv_len.shape != (b,)
            or q_offset.shape != (b,) or min(b, sq, n_slots) < 1):
        raise ValueError(
            f"{NAME}: shapes q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, block_table "
            f"{tuple(block_table.shape)}, kv_len {tuple(kv_len.shape)}, "
            f"q_offset {tuple(q_offset.shape)} do not fit")
    block_q = max(1, ROWS_PER_BLOCK // (h // kvh))
    tile_pages = max(1, TILE_TOKENS // page)
    build.check_smem(NAME, block_q * (h // kvh), hd, hd_v, tile_pages,
                     page)
    build.check_pool_rows(NAME, k_pool, hd)
    build.check_pool_rows(NAME, v_pool, hd_v)
    out = torch.empty((b, sq, h, hd_v), dtype=q.dtype, device=dev)
    err = _launcher()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_table.data_ptr(), kv_len.data_ptr(), q_offset.data_ptr(),
        out.data_ptr(), b, sq, h, kvh, hd, hd_v, page, n_slots, block_q,
        tile_pages, int(window), int(bool(causal)), hd ** -0.5,
        build.DTYPE_CODES[str(q.dtype)],
        torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on_error(NAME, err)
    paged_prefill_attention.launches += 1
    if not causal:
        paged_prefill_attention.noncausal_launches += 1
    return out


paged_prefill_attention.launches = 0
paged_prefill_attention.noncausal_launches = 0
