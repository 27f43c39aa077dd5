"""Dense chunked-prefill attention: CUDA kernel wrapper.

Replaces ``src/repro/kernels/chunked_prefill_attention.py``
(``chunked_prefill_attention`` -> ``pl.pallas_call``): a chunk of
``sq`` queries of each request, all starting at one shared absolute
position ``q_offset``, attends that request's dense K/V cache, causal
with an optional sliding window, or non-causal (the dense
cross-attention read: every query attends the kv_len encoder keys,
however many queries there are).

The kernel (``csrc/chunked_prefill_attention.cu``) runs one block per
(request, KV head, q tile); the rep query heads of a KV head share each
K/V tile the block reads, and the tiles walk only the live keys.  On an
H100 the work is bound by its operations.  bf16 inputs run the
tensor-core body it shares with the paged kernel (bf16 ``wgmma``,
f32 sums; head widths 32, 64 and 128, 256 for both K and V, or 192
for K with 128 for V (MLA), any other raises ``ValueError``);
f32 inputs run the CUDA-core body, since the tensor cores would take
them as TF32 (about three decimal digits) and the f32 runs are held
token-identical to the CPU.  ``prefill_plan.prefill_plan`` picks the
body and the block; see the sources for the design.

On a CPU tensor the wrapper runs the plain version
(``ref.chunked_prefill_attention``); on a CUDA tensor it launches the
kernel or raises.  ``chunked_prefill_attention.launches`` counts kernel
launches, ``chunked_prefill_attention.tensor_core_launches`` those of
them that ran the tensor-core body, and
``chunked_prefill_attention.noncausal_launches`` those with
``causal=False`` (the dense cross-attention read).  ``q_offset`` is a
host int here: the reference passes the shared chunk start as a (1,)
array, and ``ops.prefill_attention`` reads it to the host once, so the
wrapper can check it against the cache without a device sync.

Training: ``chunked_prefill_attention_bwd`` is the backward, a second
hand-written kernel (``csrc/chunked_prefill_attention_bwd.cu``) in
place of JAX's autodiff of the reference's ``flash_attn``, on the
tensor cores in both dtypes (``bwd_plan.bwd_plan``: bf16 exactly with
P and dS as three bf16 terms, f32 as three bf16 terms an operand); on
a CPU tensor it runs ``ref.chunked_prefill_attention_bwd``, on a CUDA
tensor the kernel or a raise.  ``chunked_prefill_attention_bwd.launches``
counts its calls (one a backward, two launches on the card) and
``chunked_prefill_attention_bwd.tensor_core_launches`` those of them
that ran the tensor-core body.
``ChunkedPrefillAttention``, a ``torch.autograd.Function``, ties the
two together: its forward is this module's forward wrapper, its
backward the backward wrapper.
"""
from __future__ import annotations

import ctypes
from array import array

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.bwd_plan import bwd_plan
from repro_torch.kernels.prefill_plan import (TENSOR_CORE, prefill_plan,
                                              sm_count)

NAME = "chunked_prefill_attention"
BWD_NAME = "chunked_prefill_attention_bwd"
# what the backward's launch returns for head widths it has no
# instantiation for (its source lists the instantiated ones), and for a
# plan that is not its own
BWD_NO_WIDTHS, BWD_PLAN_MISMATCH = -1, -2
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
    chunk's shared start, with q_offset + sq <= skv.  Non-causal
    (``causal=False``, the cross read: q_offset 0, no window): the
    queries need not lie in the cache, so sq may exceed skv.
    Returns (b, sq, h, hd_v) in q's dtype."""
    b, sq, h, hd = q.shape
    skv = k_cache.shape[1]
    q_offset = int(q_offset)
    if q_offset < 0 or (causal and q_offset + sq > skv):
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
        kvh, hd, hd_v, plan.block_q, plan.tile_pages, plan.splits,
        int(window), int(bool(causal)), int(plan.body == TENSOR_CORE)))
    err = _launcher()(args.buffer_info()[0], hd ** -0.5,
                      build.raw_stream(dev))
    build.raise_on_error(NAME, err)
    build.count(chunked_prefill_attention, "launches",
                *(("tensor_core_launches",) if plan.body == TENSOR_CORE
                  else ()),
                *(() if causal else ("noncausal_launches",)))
    return out


chunked_prefill_attention.launches = 0
chunked_prefill_attention.tensor_core_launches = 0
chunked_prefill_attention.noncausal_launches = 0


def _bwd_launcher():
    fn = build.load(BWD_NAME).chunked_prefill_attention_bwd_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, ctypes.c_float, _P]
        fn.restype = ctypes.c_int
    return fn


def chunked_prefill_attention_bwd(q, k_cache, v_cache, out, dout, kv_len,
                                  q_offset: int, *, window: int = 0,
                                  causal: bool = True):
    """The gradients (dq, dk, dv) of ``chunked_prefill_attention(q,
    k_cache, v_cache, kv_len, q_offset, window=window, causal=causal)``,
    whose output was ``out``, for the output gradient ``dout`` (both (b,
    sq, h, hd_v)).  Each in its input's shape and dtype; a query row with
    no key it may attend, and a key row no query reaches (every row at
    or past kv_len), gets exactly 0."""
    b, sq, h, hd = q.shape
    skv, kvh = k_cache.shape[1], k_cache.shape[2]
    hd_v = v_cache.shape[3]
    q_offset = int(q_offset)
    if q_offset < 0 or (causal and q_offset + sq > skv):
        raise ValueError(f"{BWD_NAME}: chunk [{q_offset}, {q_offset + sq})"
                         f" outside a cache of {skv} positions")
    if q.device.type == "cpu":
        return ref.chunked_prefill_attention_bwd(
            q, k_cache, v_cache, out, dout, kv_len, q_offset,
            window=window, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"{BWD_NAME}: no kernel for device {q.device}")
    dev = q.device
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("out", out), ("dout", dout)):
        build.check_cuda(name, t, ndim=4,
                         dtypes=_FLOATS if t is q else (str(q.dtype),),
                         device=dev)
    build.check_cuda("kv_len", kv_len, ndim=1, dtypes=_I32, device=dev)
    if (k_cache.shape[0] != b or k_cache.shape[3] != hd
            or v_cache.shape[:3] != k_cache.shape[:3] or h % kvh
            or out.shape != (b, sq, h, hd_v) or dout.shape != out.shape
            or kv_len.shape != (b,) or min(b, sq, skv) < 1):
        raise ValueError(
            f"{BWD_NAME}: shapes q {tuple(q.shape)}, caches "
            f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}, out / dout "
            f"{tuple(out.shape)}/{tuple(dout.shape)}, kv_len "
            f"{tuple(kv_len.shape)} do not fit")
    try:
        plan = bwd_plan(q.dtype, b, sq, h, kvh, hd, hd_v, skv)
    except ValueError as e:
        raise ValueError(f"{BWD_NAME}: {e} (csrc/{BWD_NAME}.cu lists the "
                         "instantiated pairs)") from None
    # its tiles are copied 16 bytes a row chunk
    for t, width in ((q, hd), (k_cache, hd), (v_cache, hd_v), (dout, hd_v)):
        build.check_pool_rows(BWD_NAME, t, width)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k_cache, v_cache))
    # each query row's max, 1 / sum and dO . O, from the first launch to
    # the second
    stats = torch.empty(3 * b * h * sq, dtype=torch.float32, device=dev)
    args = array("q", (
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        out.data_ptr(), dout.data_ptr(), kv_len.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), b, q_offset, sq,
        skv, h, kvh, hd, hd_v, int(window), int(bool(causal)),
        build.DTYPE_CODES[str(q.dtype)], plan.rows, plan.tile, plan.stages,
        plan.q_parts, plan.kv_parts, plan.smem))
    err = _bwd_launcher()(args.buffer_info()[0], hd ** -0.5,
                          build.raw_stream(dev))
    if err == BWD_NO_WIDTHS:
        raise ValueError(f"{BWD_NAME}: no instantiation for head widths "
                         f"hd={hd}, hd_v={hd_v} (csrc/{BWD_NAME}.cu lists "
                         "the instantiated pairs)")
    if err == BWD_PLAN_MISMATCH:
        raise RuntimeError(f"{BWD_NAME}: bwd_plan's {plan} is not the "
                           "launch's own (Cfg in the source)")
    build.raise_on_error(BWD_NAME, err)
    build.count(chunked_prefill_attention_bwd, "launches",
                *(("tensor_core_launches",)
                  if plan.body == TENSOR_CORE else ()))
    return dq, dk, dv


chunked_prefill_attention_bwd.launches = 0
chunked_prefill_attention_bwd.tensor_core_launches = 0


class ChunkedPrefillAttention(torch.autograd.Function):
    """Kernel 5 with a gradient: ``apply(q, k_cache, v_cache, kv_len,
    q_offset, window, causal)`` runs ``chunked_prefill_attention``; the
    backward runs ``chunked_prefill_attention_bwd`` on the saved q, k,
    v, output and kv_len.  kv_len, q_offset, window and causal take no
    gradient."""

    @staticmethod
    def forward(ctx, q, k_cache, v_cache, kv_len, q_offset: int,
                window: int, causal: bool):
        out = chunked_prefill_attention(q, k_cache, v_cache, kv_len,
                                        q_offset, window=window,
                                        causal=causal)
        ctx.save_for_backward(q, k_cache, v_cache, out, kv_len)
        ctx.args = (q_offset, window, causal)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k_cache, v_cache, out, kv_len = ctx.saved_tensors
        q_offset, window, causal = ctx.args
        dq, dk, dv = chunked_prefill_attention_bwd(
            q, k_cache, v_cache, out, dout.contiguous(), kv_len, q_offset,
            window=window, causal=causal)
        return dq, dk, dv, None, None, None, None
