"""Plain PyTorch versions of the attention kernels (paged GQA prefill,
paged GQA decode, absorbed MLA decode, cross-attention decode, dense
chunked prefill).

Each function computes what its CUDA kernel computes, with dense
tensor ops: gather the block-table pages (the paged forms), masked
softmax in f32, PV.
The kernel wrappers use them for CPU tensors (the CPU tests and the
CPU run of the engines), and ``chip_smoke.py`` holds each kernel
against its plain version on the card.

Empty rows follow the kernels, not the reference's ``ref.py`` oracles:
a query row with no key it may attend (``kv_len``/``lens`` = 0, or a
pad query of a windowed segment) gives 0, where a softmax over all
``NEG_INF`` would give the mean of V.  The TPU kernels, which the JAX
package runs in interpret mode on the CPU, also give 0 for such a row
when every page is skipped.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _masked_softmax(s, mask):
    """s: (..., k) f32 scores; mask: bool, broadcastable to s.  Rows
    without a True entry give all-zero probabilities."""
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    return torch.softmax(s, dim=-1) * mask.any(dim=-1, keepdim=True)


def _prefill(q, k, v, kv_len, q_pos, window, causal):
    """q: (b, sq, h, hd) against dense k (b, K, kvh, hd) / v (b, K, kvh,
    hd_v); q_pos: (b, sq) absolute query positions; key j sits at
    position j.  Returns (b, sq, h, hd_v) in q's dtype."""
    b, sq, h, hd = q.shape
    kvh, hd_v = v.shape[2], v.shape[3]
    qf = q.float().reshape(b, sq, kvh, h // kvh, hd)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qf, k.float()) * hd ** -0.5
    k_pos = torch.arange(k.shape[1], device=q.device)
    mask = k_pos[None, None, :] < kv_len.long()[:, None, None]  # (b,1,K)
    if causal:
        mask = mask & (q_pos[:, :, None] >= k_pos[None, None, :])
    if window:
        mask = mask & (k_pos[None, None, :] > q_pos[:, :, None] - window)
    p = _masked_softmax(s, mask[:, None, None])
    out = torch.einsum("bgrqk,bkgd->bqgrd", p, v.float())
    return out.reshape(b, sq, h, hd_v).to(q.dtype)


def paged_prefill_attention(q, k_pool, v_pool, block_table, kv_len,
                            q_offset, *, window: int = 0,
                            causal: bool = True):
    """q: (segs, sq, h, hd); k_pool/v_pool: (n_pages, page, kvh, hd);
    block_table: (segs, n_slots); kv_len, q_offset: (segs,).
    Returns (segs, sq, h, hd_v) in q's dtype."""
    b, sq = q.shape[:2]
    page, kvh = k_pool.shape[1], k_pool.shape[2]
    n_keys = block_table.shape[1] * page
    bt = block_table.long()
    k = k_pool[bt].reshape(b, n_keys, kvh, k_pool.shape[3])
    v = v_pool[bt].reshape(b, n_keys, kvh, v_pool.shape[3])
    q_pos = q_offset.long()[:, None] + torch.arange(sq, device=q.device)
    return _prefill(q, k, v, kv_len, q_pos, window, causal)


def chunked_prefill_attention(q, k_cache, v_cache, kv_len, q_offset: int,
                              *, window: int = 0, causal: bool = True):
    """Dense form: q (b, sq, h, hd) of every request starts at the one
    shared position ``q_offset`` (an int); k_cache/v_cache: (b, skv,
    kvh, hd / hd_v) per-request caches; kv_len: (b,).
    Returns (b, sq, h, hd_v) in q's dtype."""
    b, sq = q.shape[:2]
    q_pos = (q_offset + torch.arange(sq, device=q.device))[None].expand(
        b, sq)
    return _prefill(q, k_cache, v_cache, kv_len, q_pos, window, causal)


def paged_decode_attention(q, k_pool, v_pool, block_table, lens, *,
                           window: int = 0):
    """q: (b, h, hd); k_pool/v_pool: (n_pages, page, kvh, hd);
    block_table: (b, n_slots); lens: (b,).  Returns (b, h, hd_v)."""
    b, h, hd = q.shape
    n_pages, page, kvh, hd_v = v_pool.shape
    n_slots = block_table.shape[1]
    rep = h // kvh
    bt = block_table.long()
    k = k_pool[bt].reshape(b, n_slots * page, kvh, hd).float()
    v = v_pool[bt].reshape(b, n_slots * page, kvh, hd_v).float()
    qf = q.float().reshape(b, kvh, rep, hd)
    s = torch.einsum("bgrd,bkgd->bgrk", qf, k) * hd ** -0.5
    tok = torch.arange(n_slots * page, device=q.device)
    ln = lens.long()[:, None]
    mask = tok[None, :] < ln
    if window:
        mask = mask & (tok[None, :] > ln - 1 - window)
    p = _masked_softmax(s, mask[:, None, None])
    out = torch.einsum("bgrk,bkgd->bgrd", p, v)
    return out.reshape(b, h, hd_v).to(q.dtype)


def paged_cross_decode_attention(q, k_pool, v_pool, block_table,
                                 enc_lens):
    """One decode query per slot against the slot's read-only cross
    (encoder) pages, non-causal: every key tok < enc_len, no window.
    That is the decode read at window 0 with ``enc_lens`` as the
    lengths, so it gathers and masks through ``paged_decode_attention``;
    a slot with enc_len = 0 gives 0.  q: (b, h, hd); block_table: (b,
    cross_slots); enc_lens: (b,).  Returns (b, h, hd_v)."""
    return paged_decode_attention(q, k_pool, v_pool, block_table, enc_lens)


def paged_mla_decode_attention(q_lat, q_rope, ckv_pool, kr_pool,
                               block_table, lens, *, scale: float,
                               window: int = 0):
    """Absorbed MLA decode.  q_lat: (b, h, lora); q_rope: (b, h, rope);
    ckv_pool: (n_pages, page, lora); kr_pool: (n_pages, page, rope);
    block_table: (b, n_slots); lens: (b,).  Scores (q_lat . ckv +
    q_rope . kr) * scale in f32, PV on the latent itself.  Returns
    o_lat (b, h, lora) in q_lat's dtype."""
    b, h, lora = q_lat.shape
    page = kr_pool.shape[1]
    n_keys = block_table.shape[1] * page
    bt = block_table.long()
    ckv = ckv_pool[bt].reshape(b, n_keys, lora).float()
    kr = kr_pool[bt].reshape(b, n_keys, -1).float()
    s = (torch.einsum("bhl,bkl->bhk", q_lat.float(), ckv)
         + torch.einsum("bhr,bkr->bhk", q_rope.float(), kr)) * scale
    tok = torch.arange(n_keys, device=q_lat.device)
    ln = lens.long()[:, None]
    mask = tok[None, :] < ln
    if window:
        mask = mask & (tok[None, :] > ln - 1 - window)
    p = _masked_softmax(s, mask[:, None])
    return torch.einsum("bhk,bkl->bhl", p, ckv).to(q_lat.dtype)
