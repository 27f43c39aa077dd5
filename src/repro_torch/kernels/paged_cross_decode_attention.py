"""Paged cross-attention decode (one query token per slot against the
read-only encoder pages): CUDA kernel wrapper.

Replaces ``src/repro/kernels/paged_cross_decode_attention.py``
(``paged_cross_decode_attention`` -> ``pl.pallas_call``).  Every decode
iteration of a VLM or encoder-decoder model runs the whole slot batch
through it in every cross layer; empty slots carry ``enc_lens = 0`` and
get zeros.

The kernel (``csrc/paged_cross_decode_attention.cu``) runs one block per
(slot, KV head, split of the cross block-table slots), with the shared
body of the GQA kernels: the rep query heads of a KV head share each
cross page the block reads, and a second small launch combines the
splits' partial softmax states.  The only mask is ``tok < enc_len``.
On an H100 it is bound by the bytes of the cross pages; see the source.

On a CPU tensor the wrapper runs the plain version
(``ref.paged_cross_decode_attention``); on a CUDA tensor it launches the
kernel or raises.  ``paged_cross_decode_attention.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

NAME = "paged_cross_decode_attention"
TILE_TOKENS = 64        # keys per shared-memory K/V tile
BLOCKS_PER_SM = 2       # blocks in flight the splits aim for, per SM
_FLOATS = ("torch.float32", "torch.bfloat16")
_I32 = ("torch.int32",)
_P, _I = ctypes.c_void_p, ctypes.c_int


def _launcher():
    fn = build.load(NAME).paged_cross_decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 7 + [_I] * 9 + [ctypes.c_float, _I, _P]
        fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def slots_per_split(b: int, kvh: int, n_slots: int, n_sm: int) -> int:
    """Table slots one block covers: the fewest splits for which
    b * kvh * splits reaches BLOCKS_PER_SM blocks an SM (every cross
    table of a batch has the same width, so the split is even)."""
    splits = min(n_slots, max(1, -(-BLOCKS_PER_SM * n_sm // (b * kvh))))
    return -(-n_slots // splits)


def paged_cross_decode_attention(q, k_pool, v_pool, block_table, enc_lens):
    """q: (b, h, hd), contiguous; k_pool/v_pool: (n_pages, page, kvh, hd),
    the pool shared with the self-attention pages; block_table: (b,
    cross_slots) int32 physical ids of each slot's cross pages (pad slots
    may point at a scratch page — never read); enc_lens: (b,) int32
    encoder tokens per slot (0 for an empty slot).  Returns (b, h, hd_v)
    in q's dtype."""
    if q.device.type == "cpu":
        return ref.paged_cross_decode_attention(q, k_pool, v_pool,
                                                block_table, enc_lens)
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {q.device}")
    dev = q.device
    build.check_cuda("q", q, ndim=3, dtypes=_FLOATS, device=dev)
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        build.check_cuda(name, t, ndim=4, dtypes=(str(q.dtype),),
                         device=dev)
    build.check_cuda("block_table", block_table, ndim=2, dtypes=_I32,
                     device=dev)
    build.check_cuda("enc_lens", enc_lens, ndim=1, dtypes=_I32, device=dev)
    b, h, hd = q.shape
    n_pages, page, kvh, hd_k = k_pool.shape
    hd_v = v_pool.shape[3]
    n_slots = block_table.shape[1]
    if (hd_k != hd or v_pool.shape[:3] != k_pool.shape[:3] or h % kvh
            or block_table.shape[0] != b or enc_lens.shape != (b,)
            or min(b, n_slots) < 1):
        raise ValueError(
            f"{NAME}: shapes q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, block_table "
            f"{tuple(block_table.shape)}, enc_lens "
            f"{tuple(enc_lens.shape)} do not fit")
    tile_pages = max(1, TILE_TOKENS // page)
    build.check_smem(NAME, h // kvh, hd, hd_v, tile_pages, page)
    build.check_pool_rows(NAME, k_pool, hd)
    build.check_pool_rows(NAME, v_pool, hd_v)
    per = slots_per_split(b, kvh, n_slots, _sm_count(dev.index))
    splits = -(-n_slots // per)
    part = torch.empty((b, kvh, splits, h // kvh, hd_v + 2),
                       dtype=torch.float32, device=dev)
    out = torch.empty((b, h, hd_v), dtype=q.dtype, device=dev)
    err = _launcher()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_table.data_ptr(), enc_lens.data_ptr(), part.data_ptr(),
        out.data_ptr(), b, h, kvh, hd, hd_v, page, n_slots, per,
        tile_pages, hd ** -0.5, build.DTYPE_CODES[str(q.dtype)],
        torch.cuda.current_stream(dev).cuda_stream)
    build.raise_on_error(NAME, err)
    paged_cross_decode_attention.launches += 1
    return out


paged_cross_decode_attention.launches = 0
