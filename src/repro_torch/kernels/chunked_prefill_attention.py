"""Dense chunked-prefill attention: CUDA kernel wrapper.

Replaces ``src/repro/kernels/chunked_prefill_attention.py``
(``chunked_prefill_attention`` -> ``pl.pallas_call``): a chunk of
``sq`` queries of each request, all starting at one shared absolute
position ``q_offset``, attends that request's dense K/V cache, causal,
with an optional sliding window.

The kernel (``csrc/chunked_prefill_attention.cu``) runs one block per
(request, KV head, q tile); the rep query heads of a KV head share each
K/V tile the block reads, and the tiles walk only the live keys.  On an
H100 the work is bound by its operations.  bf16 inputs run the
tensor-core body it shares with the paged kernel (bf16 ``wgmma``,
f32 sums; head widths 32, 64 and 128, any other raises ``ValueError``);
f32 inputs run the CUDA-core body, since the tensor cores would take
them as TF32 (about three decimal digits) and the f32 runs are held
token-identical to the CPU.  ``prefill_plan.prefill_plan`` picks the
body and the block; see the sources for the design.

On a CPU tensor the wrapper runs the plain version
(``ref.chunked_prefill_attention``); on a CUDA tensor it launches the
kernel or raises.  ``chunked_prefill_attention.launches`` counts kernel
launches, ``chunked_prefill_attention.tensor_core_launches`` those of
them that ran the tensor-core body.  ``q_offset`` is a host int here:
the reference passes the shared chunk start as a (1,) array, and
``ops.prefill_attention`` reads it to the host once, so the wrapper can
check it against the cache without a device sync.
"""
from __future__ import annotations

import ctypes
from array import array

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.prefill_plan import (TENSOR_CORE, TILE_TOKENS,
                                              prefill_plan, sm_count)

NAME = "chunked_prefill_attention"
_FLOATS = ("torch.float32", "torch.bfloat16")
_I32 = ("torch.int32",)
_P = ctypes.c_void_p


def _launcher():
    fn = build.load(NAME).chunked_prefill_attention_launch
    if fn.argtypes is None:
        # the launch's pointers and sizes packed in one int64 array
        fn.argtypes = [_P, ctypes.c_float, _P]
        fn.restype = ctypes.c_int
    return fn


def chunked_prefill_attention(q, k_cache, v_cache, kv_len, q_offset: int,
                              *, window: int = 0, causal: bool = True):
    """q: (b, sq, h, hd); k_cache: (b, skv, kvh, hd) and v_cache: (b, skv,
    kvh, hd_v) with the chunk already written at [q_offset, q_offset +
    sq); kv_len: (b,) int32 valid tokens after the write; q_offset: the
    chunk's shared start, with q_offset + sq <= skv.
    Returns (b, sq, h, hd_v) in q's dtype."""
    b, sq, h, hd = q.shape
    skv = k_cache.shape[1]
    q_offset = int(q_offset)
    if q_offset < 0 or q_offset + sq > skv:
        raise ValueError(f"{NAME}: chunk [{q_offset}, {q_offset + sq}) "
                         f"outside a cache of {skv} positions")
    if q.device.type == "cpu":
        return ref.chunked_prefill_attention(
            q, k_cache, v_cache, kv_len, q_offset, window=window,
            causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {q.device}")
    dev = q.device
    build.check_cuda("q", q, ndim=4, dtypes=_FLOATS, device=dev)
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        build.check_cuda(name, t, ndim=4, dtypes=(str(q.dtype),),
                         device=dev)
    build.check_cuda("kv_len", kv_len, ndim=1, dtypes=_I32, device=dev)
    kvh, hd_k = k_cache.shape[2], k_cache.shape[3]
    hd_v = v_cache.shape[3]
    if (hd_k != hd or k_cache.shape[0] != b
            or v_cache.shape[:3] != k_cache.shape[:3] or h % kvh
            or kv_len.shape != (b,) or min(b, sq) < 1):
        raise ValueError(
            f"{NAME}: shapes q {tuple(q.shape)}, caches "
            f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}, kv_len "
            f"{tuple(kv_len.shape)} do not fit")
    # the cache is a pool of one-token pages
    plan = prefill_plan(q.dtype, b, sq, h, kvh, hd, hd_v, 1, skv,
                        sm_count(dev))
    build.check_pool_rows(NAME, k_cache, hd)
    build.check_pool_rows(NAME, v_cache, hd_v)
    if plan.body == TENSOR_CORE:      # its Q rows are copied 16 B at a time
        build.check_pool_rows(NAME, q, hd)
    out = q.new_empty((b, sq, h, hd_v))
    # split launches leave their partial states here for the combine
    part = None if plan.splits == 1 else torch.empty(
        plan.splits * b * sq * h * (hd_v + 2), dtype=torch.float32,
        device=dev)
    args = array("q", (
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        kv_len.data_ptr(), out.data_ptr(),
        0 if part is None else part.data_ptr(), b, q_offset, sq, skv, h,
        kvh, hd, hd_v, plan.block_q, TILE_TOKENS, plan.splits, int(window),
        int(bool(causal)), int(plan.body == TENSOR_CORE)))
    err = _launcher()(args.buffer_info()[0], hd ** -0.5,
                      build.raw_stream(dev))
    build.raise_on_error(NAME, err)
    build.count(chunked_prefill_attention, "launches",
                *(("tensor_core_launches",) if plan.body == TENSOR_CORE
                  else ()))
    return out


chunked_prefill_attention.launches = 0
chunked_prefill_attention.tensor_core_launches = 0
