"""Dense chunked-prefill attention: CUDA kernel wrapper.

Replaces ``src/repro/kernels/chunked_prefill_attention.py``
(``chunked_prefill_attention`` -> ``pl.pallas_call``): a chunk of
``sq`` queries of each request, all starting at one shared absolute
position ``q_offset``, attends that request's dense K/V cache, causal,
with an optional sliding window.

The kernel (``csrc/chunked_prefill_attention.cu``) runs one block per
(request, KV head, q tile); the rep query heads of a KV head share each
K/V tile the block reads, and the tiles walk only the live keys.  On an
H100 the work is bound by its operations, which this first version
does as f32 FMAs on the CUDA cores; see the source for the design.

On a CPU tensor the wrapper runs the plain version
(``ref.chunked_prefill_attention``); on a CUDA tensor it launches the
kernel or raises.  ``chunked_prefill_attention.launches`` counts kernel
launches.  ``q_offset`` is a host int here: the reference passes the
shared chunk start as a (1,) array, and ``ops.prefill_attention`` reads
it to the host once, so the wrapper can check it against the cache
without a device sync.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

NAME = "chunked_prefill_attention"
ROWS_PER_BLOCK = 64     # query rows (positions x rep heads) per block
TILE_TOKENS = 64        # keys per shared-memory K/V tile
_FLOATS = ("torch.float32", "torch.bfloat16")
_I32 = ("torch.int32",)
_P, _I = ctypes.c_void_p, ctypes.c_int


def _launcher():
    fn = build.load(NAME).chunked_prefill_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 12 + [ctypes.c_float, _I, _P]
        fn.restype = _I
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
    rep = h // kvh
    block_q = max(1, ROWS_PER_BLOCK // rep)
    build.check_smem(NAME, block_q * rep, hd, hd_v, TILE_TOKENS, 1)
    build.check_pool_rows(NAME, k_cache, hd)
    build.check_pool_rows(NAME, v_cache, hd_v)
    out = torch.empty((b, sq, h, hd_v), dtype=q.dtype, device=dev)
    err = _launcher()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        kv_len.data_ptr(), out.data_ptr(), b, q_offset, sq, skv, h, kvh, hd,
        hd_v, block_q, TILE_TOKENS, int(window), int(bool(causal)),
        hd ** -0.5, build.DTYPE_CODES[str(q.dtype)],
        torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on_error(NAME, err)
    chunked_prefill_attention.launches += 1
    return out


chunked_prefill_attention.launches = 0
