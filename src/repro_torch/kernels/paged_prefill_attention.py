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
operations.  bf16 inputs run the tensor-core body (bf16 ``wgmma``,
f32 sums; head widths 32, 64 and 128, or 256 for both K and V, any
other raises ``ValueError``);
f32 inputs run the CUDA-core body, since the tensor cores would take
them as TF32 (about three decimal digits) and the f32 served runs are
held token-identical to the CPU.  ``prefill_plan.prefill_plan`` picks
the body and the block; see the sources for the design.

On a CPU tensor the wrapper runs the plain version
(``ref.paged_prefill_attention``); on a CUDA tensor it launches the
kernel or raises.  ``paged_prefill_attention.launches`` counts kernel
launches, ``paged_prefill_attention.tensor_core_launches`` those of
them that ran the tensor-core body, and
``paged_prefill_attention.noncausal_launches`` those with
``causal=False`` (the cross-attention read of a chunk).
"""
from __future__ import annotations

import ctypes
from array import array

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.prefill_plan import (TENSOR_CORE, prefill_plan,
                                              sm_count)

NAME = "paged_prefill_attention"
_FLOATS = ("torch.float32", "torch.bfloat16")
_I32 = ("torch.int32",)
_P = ctypes.c_void_p


def _launcher():
    fn = build.load(NAME).paged_prefill_attention_launch
    if fn.argtypes is None:
        # the launch's pointers and sizes packed in one int64 array
        fn.argtypes = [_P, ctypes.c_float, _P]
        fn.restype = ctypes.c_int
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
    dev = q.device
    if dev.type == "cpu":
        return ref.paged_prefill_attention(
            q, k_pool, v_pool, block_table, kv_len, q_offset,
            window=window, causal=causal)
    if dev.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {dev}")
    build.check_cuda("q", q, ndim=4, dtypes=_FLOATS, device=dev)
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        build.check_cuda(name, t, ndim=4, dtypes=(str(q.dtype),),
                         device=dev)
    build.check_cuda("block_table", block_table, ndim=2, dtypes=_I32,
                     device=dev)
    build.check_cuda("kv_len", kv_len, ndim=1, dtypes=_I32, device=dev)
    build.check_cuda("q_offset", q_offset, ndim=1, dtypes=_I32, device=dev)
    b, sq, h, hd = q.shape
    k_shape, v_shape = k_pool.shape, v_pool.shape
    n_pages, page, kvh, hd_k = k_shape
    hd_v = v_shape[3]
    b_bt, n_slots = block_table.shape
    if (hd_k != hd or v_shape[:3] != k_shape[:3] or h % kvh
            or b_bt != b or kv_len.shape != (b,)
            or q_offset.shape != (b,) or min(b, sq, n_slots) < 1):
        raise ValueError(
            f"{NAME}: shapes q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, block_table "
            f"{tuple(block_table.shape)}, kv_len {tuple(kv_len.shape)}, "
            f"q_offset {tuple(q_offset.shape)} do not fit")
    plan = prefill_plan(q.dtype, b, sq, h, kvh, hd, hd_v, page,
                        n_slots * page, sm_count(dev))
    build.check_pool_rows(NAME, k_pool, hd)
    build.check_pool_rows(NAME, v_pool, hd_v)
    if plan.body == TENSOR_CORE:      # its Q rows are copied 16 B at a time
        build.check_pool_rows(NAME, q, hd)
    out = q.new_empty((b, sq, h, hd_v))
    # split launches leave their partial states here for the combine
    part = None if plan.splits == 1 else torch.empty(
        plan.splits * b * sq * h * (hd_v + 2), dtype=torch.float32,
        device=dev)
    args = array("q", (
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_table.data_ptr(), kv_len.data_ptr(), q_offset.data_ptr(),
        out.data_ptr(), 0 if part is None else part.data_ptr(), b, sq, h,
        kvh, hd, hd_v, page, n_slots, plan.block_q, plan.tile_pages,
        plan.splits, int(window), int(bool(causal)),
        int(plan.body == TENSOR_CORE)))
    err = _launcher()(args.buffer_info()[0], hd ** -0.5,
                      build.raw_stream(dev))
    build.raise_on_error(NAME, err)
    build.count(paged_prefill_attention, "launches",
                *(("tensor_core_launches",) if plan.body == TENSOR_CORE
                  else ()),
                *(() if causal else ("noncausal_launches",)))
    return out


paged_prefill_attention.launches = 0
paged_prefill_attention.tensor_core_launches = 0
paged_prefill_attention.noncausal_launches = 0
