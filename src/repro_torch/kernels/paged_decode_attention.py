"""Paged decode attention (one query token per slot): CUDA kernel wrapper.

Replaces ``src/repro/kernels/paged_decode_attention.py``
(``paged_decode_attention`` -> ``pl.pallas_call``).  Every decode
iteration runs the whole slot batch through it, every layer; empty
slots carry ``lens = 0`` and get zeros.

The kernel (``csrc/paged_decode_attention.cu``) runs one block per
(slot, KV head, split of the block-table slots); the rep query heads of
a KV head share each live page the block reads, so each page crosses
from device memory once, and a second small launch combines the splits'
partial softmax states.  On an H100 decode is bound by those bytes; see
the source for the design.

On a CPU tensor the wrapper runs the plain version
(``ref.paged_decode_attention``); on a CUDA tensor it launches the
kernel or raises.  ``paged_decode_attention.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

NAME = "paged_decode_attention"
TILE_TOKENS = 64        # keys per shared-memory K/V tile
# block-table slots one block covers: fixed, as a self table is live
# only up to each slot's length (the cross kernel, whose tables are
# live over their whole width, sizes its splits to the card instead)
SLOTS_PER_SPLIT = 8
_FLOATS = ("torch.float32", "torch.bfloat16")
_I32 = ("torch.int32",)
_P, _I = ctypes.c_void_p, ctypes.c_int


def _launcher():
    fn = build.load(NAME).paged_decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 7 + [_I] * 10 + [ctypes.c_float, _I, _P]
        fn.restype = _I
    return fn


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
    dev = q.device
    build.check_cuda("q", q, ndim=3, dtypes=_FLOATS, device=dev)
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        build.check_cuda(name, t, ndim=4, dtypes=(str(q.dtype),),
                         device=dev)
    build.check_cuda("block_table", block_table, ndim=2, dtypes=_I32,
                     device=dev)
    build.check_cuda("lens", lens, ndim=1, dtypes=_I32, device=dev)
    b, h, hd = q.shape
    n_pages, page, kvh, hd_k = k_pool.shape
    hd_v = v_pool.shape[3]
    n_slots = block_table.shape[1]
    if (hd_k != hd or v_pool.shape[:3] != k_pool.shape[:3] or h % kvh
            or block_table.shape[0] != b or lens.shape != (b,)
            or min(b, n_slots) < 1):
        raise ValueError(
            f"{NAME}: shapes q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, block_table "
            f"{tuple(block_table.shape)}, lens {tuple(lens.shape)} do not "
            "fit")
    tile_pages = max(1, TILE_TOKENS // page)
    build.check_smem(NAME, h // kvh, hd, hd_v, tile_pages, page)
    build.check_pool_rows(NAME, k_pool, hd)
    build.check_pool_rows(NAME, v_pool, hd_v)
    splits = -(-n_slots // SLOTS_PER_SPLIT)
    part = torch.empty((b, kvh, splits, h // kvh, hd_v + 2),
                       dtype=torch.float32, device=dev)
    out = torch.empty((b, h, hd_v), dtype=q.dtype, device=dev)
    err = _launcher()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_table.data_ptr(), lens.data_ptr(), part.data_ptr(),
        out.data_ptr(), b, h, kvh, hd, hd_v, page, n_slots, SLOTS_PER_SPLIT,
        tile_pages, int(window), hd ** -0.5,
        build.DTYPE_CODES[str(q.dtype)],
        torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on_error(NAME, err)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
