"""Public wrappers for the attention kernels, with the signatures of
``src/repro/kernels/ops.py``.

Where the reference switches the Pallas kernels to interpret mode off
the TPU, the port dispatches on the tensors' device inside each kernel
wrapper: the hand-written CUDA kernel for CUDA tensors, the plain
PyTorch version for CPU tensors.  The model calls these, never a
kernel directly.  Every form is ported: the dense and paged GQA
prefill (the paged one also non-causal, for the cross-attention read),
the paged GQA decode, the absorbed MLA decode and the cross-attention
decode.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.chunked_prefill_attention import (
    chunked_prefill_attention)
from repro_torch.kernels.paged_cross_decode_attention import (
    paged_cross_decode_attention)
from repro_torch.kernels.paged_decode_attention import paged_decode_attention
from repro_torch.kernels.paged_mla_decode_attention import (
    paged_mla_decode_attention)
from repro_torch.kernels.paged_prefill_attention import (
    paged_prefill_attention)


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device).contiguous()


def prefill_attention(q, k_cache, v_cache, kv_len, q_offset, *,
                      block_table=None, window: int = 0, causal: bool = True,
                      block_q: int = 0, block_kv: int = 0):
    """Chunked-prefill attention.

    Dense form (``block_table=None``): k_cache/v_cache are per-request
    (b, skv, kvh, hd) caches and ``q_offset`` is a (1,) shared chunk
    start (read to the host once).

    Paged form: k_cache/v_cache are the shared page pools
    (n_pages, page, kvh, hd), ``block_table`` is (b, n_slots) physical
    page ids and ``q_offset``/``kv_len`` are per-segment (b,) scalars —
    one fused call covers a whole multi-request chunk.

    ``block_q``/``block_kv`` were the Pallas kernels' block sizes; the
    CUDA kernels pick their own tiles, so they are accepted and not
    used.
    """
    dev = q.device
    if block_table is None:
        q0 = torch.as_tensor(q_offset).reshape(-1)
        if q0.numel() != 1:
            raise ValueError(f"dense prefill: q_offset {tuple(q0.shape)} "
                             "is not one shared chunk start")
        return chunked_prefill_attention(
            q, k_cache, v_cache, _i32(kv_len, dev), int(q0[0]),
            window=window, causal=causal)
    return paged_prefill_attention(
        q, k_cache, v_cache, _i32(block_table, dev), _i32(kv_len, dev),
        _i32(q_offset, dev), window=window, causal=causal)


def decode_attention(q, k_pool, v_pool, block_table, lens, *,
                     window: int = 0):
    dev = q.device
    return paged_decode_attention(
        q.contiguous(), k_pool, v_pool, _i32(block_table, dev),
        _i32(lens, dev), window=window)


def cross_decode_attention(q, k_pool, v_pool, block_table, enc_lens):
    """Non-causal decode attention over the read-only cross pages
    (encoder K/V) via the per-request cross block table."""
    dev = q.device
    return paged_cross_decode_attention(
        q.contiguous(), k_pool, v_pool, _i32(block_table, dev),
        _i32(enc_lens, dev))


def mla_decode_attention(q_lat, q_rope, ckv_pool, kr_pool, block_table,
                         lens, *, scale: float, window: int = 0):
    """Absorbed MLA decode over the paged latent pool: scores and PV run
    in the compressed latent space; the caller up-projects the returned
    (b, h, lora) through W_uv."""
    dev = q_lat.device
    return paged_mla_decode_attention(
        q_lat.contiguous(), q_rope.contiguous(), ckv_pool, kr_pool,
        _i32(block_table, dev), _i32(lens, dev), scale=scale,
        window=window)
