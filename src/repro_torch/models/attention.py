"""Attention: RoPE, GQA and MLA (DeepSeek-V2 multi-head latent
attention) projections, the prefill/decode attention against one
layer's page pool, the cross-attention of VLM and encoder-decoder
models against read-only cross pages of the same pool, and the dense
backend's GQA, MLA and cross-attention against per-request caches
(every dense prefill read and the dense cross read in decode through
kernel 5; the dense GQA and MLA decode in torch ops, as the
reference's plain jnp), and the train-mode forms ``gqa_forward`` /
``mla_forward`` over a whole sequence, whose kernel-5 reads carry
kernel 5's backward (``cross_kv`` / ``cross_forward`` serve training
as they are).

GQA attends through the CUDA kernels in ``kernels/ops.py`` in both
phases.  MLA attends in its absorbed form over a LATENT pool (the
compressed latent and the decoupled RoPE key per token): prefill is
plain torch ops over a block-table gather of the latent, as in the
reference, which has no kernel there; decode goes through the paged
MLA kernel.

The reference updates its pools functionally and returns them; here the
``*_paged`` functions scatter the new K/V (or latent) into the layer's
pool tensors IN PLACE (``index_put_``) and return only the attention
output.

Cross-attention reads the encoder K/V through a second, per-request
block table: the prefill chunk that holds a request's first segment
scatters it once (``cross_prefill_paged``), every later read goes
through the paged kernels non-causally (prefill: kernel 1 with
``causal=False``; decode: the cross decode kernel).
"""
from __future__ import annotations

import weakref

import torch

from repro_torch.kernels import ops, ref
from repro_torch.models import blocks as B
from repro_torch.models import sharding as SH
from repro_torch.models.config import ModelConfig


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    angles = positions[..., :, None].float() * freqs        # (..,S,hd/2)
    cos = torch.cos(angles)[..., :, None, :]                # (..,S,1,hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA self-attention module
# ---------------------------------------------------------------------------
def gqa_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor, positions):
    """(q, k, v) of x (b, s, d), each (b, s, heads, hd), RoPE applied.
    Inside ``sharding.activation_sharding`` with a model axis that
    divides the KV heads, each rank projects its own heads (the column
    shards of wq / wk / wv are whole heads, and its query heads are the
    groups of its KV heads); otherwise every rank holds all heads."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if SH.active():
        mine = SH.heads_local(kvh)
        q, k, v = (SH.col_heads(x, p[w], p[bias] if cfg.qkv_bias else None,
                                n, hd, mine)
                   for w, bias, n in (("wq", "bq", h), ("wk", "bk", kvh),
                                      ("wv", "bv", kvh)))
    else:
        q = x @ p["wq"]
        k = x @ p["wk"]
        v = x @ p["wv"]
        if cfg.qkv_bias:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        q = q.reshape(b, s, h, hd)
        k = k.reshape(b, s, kvh, hd)
        v = v.reshape(b, s, kvh, hd)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# training: the whole sequence, differentiable
# ---------------------------------------------------------------------------
def _train_attention(q, k, v, window: int) -> torch.Tensor:
    """Causal self-attention of a whole sequence through kernel 5's dense
    form (q_offset 0, kv_len the sequence length for every request),
    which carries its hand-written backward when grad is on.  The
    reference runs its blocked ``flash_attn`` and JAX's autodiff of it."""
    b, s = q.shape[:2]
    kv_len = torch.full((b,), s, dtype=torch.int32, device=q.device)
    return ops.prefill_attention(q.contiguous(), k.contiguous(),
                                 v.contiguous(), kv_len, 0, window=window)


def gqa_forward(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                window: int = 0) -> torch.Tensor:
    """Full-sequence (train-mode) GQA self-attention of x (b, s, d),
    causal with the layer's window.  Returns (b, s, d).

    Under "attn2d" (heads that the model axis cannot shard, so every
    rank holds them all) each rank attends its slice of the batch and
    the slices are gathered again before ``wo``: 2D batch parallelism
    in place of the reference's GSPMD constraints."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = gqa_qkv(p, cfg, x, positions)
    split = SH.opt_on("attn2d") and not SH.heads_local(cfg.n_kv_heads)
    if split:
        q, k, v = (SH.batch2d_constrain(t) for t in (q, k, v))
    out = _train_attention(q, k, v, window)
    if split:
        out = SH.batch2d_release(out, b)
    return SH.row(out.reshape(b, s, -1), p["wo"])


def _softmax_pv(scores: torch.Tensor, pv, sharded: bool) -> torch.Tensor:
    """``pv(softmax(scores))`` where ``pv`` contracts the probabilities
    with the values of the same keys.  With ``sharded`` the last dim of
    ``scores`` is this rank's shard of the keys: the row max, then the
    row sum, then the PV partials are all-reduced over the model axis,
    and no key leaves its rank."""
    if not sharded:
        return pv(torch.softmax(scores, dim=-1))
    m = SH.all_reduce(scores.amax(-1, keepdim=True), op="max")
    e = torch.exp(scores - m)
    return SH.all_reduce(pv(e / SH.all_reduce(e.sum(-1, keepdim=True))))


def seq_sharded_attn(q, k_cache, v_cache, *, q_offset: int, kv_len: int,
                     window: int = 0) -> torch.Tensor:
    """Masked partial-softmax attention over a sequence-sharded cache
    (the "seqkv" optimization): each rank scores q against its local KV
    shard; the softmax max / sum and the PV product reduce over the
    sharded seq dim as small all-reduces — no cache all-gather.

    q: (b, sq, h, hd) every head; caches: (b, S, kvh, hd / hd_v), plain
    tensors or DTensors whose seq dim may shard over the model axis.
    Keys at or past ``kv_len`` and after each query (and outside the
    window) are masked.  As the reference: scores and PV accumulate in
    f32 on inputs in the cache's dtype.  Plain torch ops, as the
    reference's plain jnp.  Returns (b, sq, h, hd_v) in q's dtype."""
    b, sq, h, hd = q.shape
    kc, lo, _, sharded = SH.seq_shard(k_cache)
    vc = SH.seq_shard(v_cache)[0]
    kvh, hd_v = kc.shape[2], vc.shape[3]
    qg = q.reshape(b, sq, kvh, h // kvh, hd).to(kc.dtype).float()
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, kc.float()) * hd ** -0.5
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(kc.shape[1], device=q.device)
    if lo:
        k_pos += lo
    mask = (q_pos[:, None] >= k_pos[None, :]) & (k_pos[None, :] < kv_len)
    if window:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    scores = scores.masked_fill(~mask, ref.NEG_INF)
    vf = vc.float()
    out = _softmax_pv(scores, lambda pr: torch.einsum(
        "bgrqk,bkgd->bqgrd", pr.to(vc.dtype).float(), vf), sharded)
    return out.reshape(b, sq, h, hd_v).to(q.dtype)


# ---------------------------------------------------------------------------
# dense backend (per-request caches)
# ---------------------------------------------------------------------------
def gqa_prefill(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict, *,
                q_offset: int = 0, window: int = 0):
    """Dense prefill chunk: write the chunk's K/V into the (b, S, kvh,
    hd) cache at [q_offset, q_offset + s) in place, then attend (written
    prefix ++ this chunk) through ``ops.prefill_attention``'s dense form,
    kernel 5, with kv_len = q_offset + s for every request.  The
    reference computes the same function with its blocked ``flash_attn``
    in jnp.  Returns (attention output (b, s, d), cache)."""
    b, s, _ = x.shape
    positions = q_offset + torch.arange(s, device=x.device)[None, :]
    q, k, v = gqa_qkv(p, cfg, x, positions)
    SH.write_seq(cache["k"], k, q_offset)
    SH.write_seq(cache["v"], v, q_offset)
    if SH.opt_on("seqkv"):
        out = seq_sharded_attn(q, cache["k"], cache["v"], q_offset=q_offset,
                               kv_len=q_offset + s, window=window)
    else:
        # a sequence-sharded cache is gathered whole before kernel 5
        kv_len = torch.full((b,), q_offset + s, dtype=torch.int32,
                            device=x.device)
        out = ops.prefill_attention(q.contiguous(), SH.gather_seq(cache["k"]),
                                    SH.gather_seq(cache["v"]), kv_len,
                                    q_offset, window=window)
    return SH.row(out.reshape(b, s, -1), p["wo"]), cache


def decode_attn_batched(q, k_cache, v_cache, pos, window: int = 0,
                        ring: bool = False) -> torch.Tensor:
    """One-token attention over the whole dense cache, per-request
    positions pos (b,).  q: (b, 1, h, hd); caches: (b, S, kvh, hd).
    ``ring``: the cache is a ring buffer of the window, and every slot
    below min(pos + 1, S) holds a live key.

    Plain torch ops, not a kernel's plain version: the reference's
    dense decode attention is plain jnp too, outside any Pallas kernel
    (``blocks.py:_decode_attn_batched``).  A cache whose seq dim shards
    over the model axis (a DTensor) is read where it lies: the softmax
    statistics and PV are all-reduced (sequence-parallel decode)."""
    k_cache, lo, s, sharded = SH.seq_shard(k_cache)
    v_cache = SH.seq_shard(v_cache)[0]
    b, s_loc, kvh, hd = k_cache.shape
    h = q.shape[2]
    rep = h // kvh
    qg = q.reshape(b, 1, kvh, rep, hd).float()
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg,
                          k_cache.float()) * hd ** -0.5
    idx = torch.arange(s_loc, device=q.device)[None, :]
    if lo:
        idx = idx + lo
    pb = pos.long()[:, None]
    if ring:
        valid = idx < torch.clamp(pb + 1, max=s)
    else:
        valid = idx <= pb
        if window:
            valid = valid & (idx > pb - window)
    scores = scores.masked_fill(~valid[:, None, None, None, :], ref.NEG_INF)
    vf = v_cache.float()
    out = _softmax_pv(scores, lambda pr: torch.einsum(
        "bgrqk,bkgd->bqgrd", pr, vf), sharded)
    return out.reshape(b, 1, h, hd).to(q.dtype)


def decode_attn(q, k_cache, v_cache, pos: int, *, window: int = 0,
                ring: bool = False) -> torch.Tensor:
    """``decode_attn_batched`` at one position ``pos`` (an int) shared
    by every request."""
    b = q.shape[0]
    return decode_attn_batched(
        q, k_cache, v_cache,
        torch.full((b,), pos, dtype=torch.long, device=q.device),
        window, ring)


def gqa_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict,
               pos: int, *, window: int = 0):
    """One-token decode at a position ``pos`` (an int) shared by the
    batch; the cache's seq dim may be a ring buffer of the window.
    Writes the token's K/V in place.  Returns (out (b, 1, d), cache)."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    q, k, v = gqa_qkv(p, cfg, x, positions)
    s_cache = cache["k"].shape[1]
    ring = window > 0 and s_cache <= window
    slot = pos % s_cache if ring else pos
    cache["k"][:, slot:slot + 1] = k
    cache["v"][:, slot:slot + 1] = v
    out = decode_attn(q, cache["k"], cache["v"], pos, window=window,
                      ring=ring)
    return out.reshape(b, 1, -1) @ p["wo"], cache


def gqa_prefill_paged(p: dict, cfg: ModelConfig, x: torch.Tensor,
                      k_layer: torch.Tensor, v_layer: torch.Tensor, *,
                      positions, q_offset, kv_len, block_tables,
                      pages_idx, offs_idx, window: int = 0) -> torch.Tensor:
    """Fused chunk prefill against one layer's page pool.

    x: (segs, sq, d) — the packed segments of one fixed-size chunk;
    k_layer/v_layer: (n_pages, page, kvh, hd) this layer's pool, updated
    in place; positions: (segs, sq) absolute token positions;
    pages_idx/offs_idx: (segs, sq) physical (page, in-page) slot per
    token (pad tokens point at the engine's scratch page).  The chunk's
    K/V is scattered into the pool first, then the paged-prefill kernel
    attends over (written prefix ++ this chunk) through the block
    tables.  Returns the attention output (segs, sq, d)."""
    b, s, _ = x.shape
    q, k, v = gqa_qkv(p, cfg, x, positions)
    idx = (pages_idx.long(), offs_idx.long())
    k_layer.index_put_(idx, k.to(k_layer.dtype))
    v_layer.index_put_(idx, v.to(v_layer.dtype))
    out = ops.prefill_attention(q, k_layer, v_layer, kv_len, q_offset,
                                block_table=block_tables, window=window)
    return out.reshape(b, s, -1) @ p["wo"]


def gqa_decode_paged(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     k_layer: torch.Tensor, v_layer: torch.Tensor, *,
                     pos, pages, offs, block_tables, lens,
                     window: int = 0) -> torch.Tensor:
    """Batched one-token decode against one layer's page pool.

    x: (slots, 1, d); pos: (slots,) append position per slot;
    pages/offs: (slots,) physical slot of the appended token (dead slots
    point at the scratch page), written in place into k_layer/v_layer;
    lens: (slots,) valid tokens incl. the append.  Returns the attention
    output (slots, 1, d)."""
    b = x.shape[0]
    q, k, v = gqa_qkv(p, cfg, x, pos[:, None])
    idx = (pages.long(), offs.long())
    k_layer.index_put_(idx, k[:, 0].to(k_layer.dtype))
    v_layer.index_put_(idx, v[:, 0].to(v_layer.dtype))
    # q[:, 0] is a view; the kernel takes a contiguous (slots, h, hd)
    out = ops.decode_attention(q[:, 0].contiguous(), k_layer, v_layer,
                               block_tables, lens, window=window)
    return out.reshape(b, 1, -1) @ p["wo"]


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek-V2), absorbed form
# ---------------------------------------------------------------------------
def _rms(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The reference's MLA norm (``attention._rms``): statistics in f32,
    cast back to x's dtype before the weight, eps 1e-6 whatever
    ``cfg.norm_eps`` says."""
    return B.rms_norm(x, w, 1e-6)


def _mla_q(p: dict, cfg: ModelConfig, x: torch.Tensor, positions):
    """(q_nope, q_rope), each (b, s, h, ·); q_rope carries RoPE.  The
    query is low-rank (wq_a, q_norm, wq_b) when q_lora_rank is set."""
    m = cfg.mla
    b, s, _ = x.shape
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    if SH.active():
        # this rank's heads when the model axis divides them
        mine = SH.heads_local(cfg.n_heads)
        if "wq_a" in p:
            q = SH.col_heads(_rms(SH.col_full(x, p["wq_a"]), p["q_norm"]),
                             p["wq_b"], None, cfg.n_heads, qk, mine)
        else:
            q = SH.col_heads(x, p["wq"], None, cfg.n_heads, qk, mine)
        q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim],
                                 -1)
        return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)
    if "wq_a" in p:
        q = _rms(x @ p["wq_a"], p["q_norm"]) @ p["wq_b"]
    else:
        q = x @ p["wq"]
    q = q.reshape(b, s, cfg.n_heads, qk)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_kv_latent(p: dict, cfg: ModelConfig, x: torch.Tensor, positions):
    """Per-token compressed latent: c_kv (b, s, lora), k_rope (b, s, rope)."""
    m = cfg.mla
    c_kv, k_rope = SH.col_full(x, p["wkv_a"]).split(
        [m.kv_lora_rank, m.qk_rope_head_dim], -1)
    c_kv = _rms(c_kv, p["kv_norm"])
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return c_kv, k_rope[:, :, 0, :]


def _wkv_b(p: dict, cfg: ModelConfig) -> torch.Tensor:
    """wkv_b as the heads this rank computes: its column shard when the
    model axis divides the heads, else the whole weight."""
    w = p["wkv_b"]
    if SH.heads_local(cfg.n_heads):
        return SH.weight(w)[0]
    return SH.full(w)


def _mla_absorb(p: dict, cfg: ModelConfig):
    """Split wkv_b into the absorbed up-projections W_uk (lora, h, nope)
    and W_uv (lora, h, v), for this rank's heads under a model axis."""
    m = cfg.mla
    wkv_b = _wkv_b(p, cfg).reshape(m.kv_lora_rank, -1,
                                   m.qk_nope_head_dim + m.v_head_dim)
    return wkv_b.split([m.qk_nope_head_dim, m.v_head_dim], -1)


def _latent_attn(p: dict, cfg: ModelConfig, q_nope, q_rope, ckv_cache,
                 kr_cache, mask_fn, cast: bool) -> torch.Tensor:
    """Absorbed MLA attention in the latent space: q_nope (b, sq, h, nope)
    absorbed through W_uk, scores (q_lat . ckv + q_rope . krope) * scale
    against every cache position (``mask_fn(k_pos)`` the live ones,
    broadcastable to (b, h, sq, S)), PV on the latent, W_uv on the way
    out; f32 sums.  ``cast``: the operands of the latent products in the
    cache's dtype and of the W_uv product in W_uv's, as the reference's
    ``_mla_absorbed_attn`` (preferred_element_type f32); else all f32, as
    its ``mla_decode``.

    Under a model axis: q holds this rank's heads and the latent caches
    (DTensors) may shard their sequence.  Then the (small) absorbed
    queries of every head are gathered, each rank scores its shard of
    the latent, the softmax statistics and o_lat are all-reduced, and
    each rank up-projects its own heads: no latent leaves its rank.
    Returns (b, sq, h, v_head_dim) f32."""
    ckv, lo, _, sharded = SH.seq_shard(ckv_cache)
    kr = SH.seq_shard(kr_cache)[0]
    w_uk, w_uv = _mla_absorb(p, cfg)
    lat_t = ckv.dtype if cast else torch.float32
    q_lat = torch.einsum("bqhd,lhd->bqhl", q_nope.float(), w_uk.float())
    spread = sharded and q_lat.shape[2] < cfg.n_heads
    if spread:
        q_lat, q_rope = SH.all_gather(q_lat, 2), SH.all_gather(q_rope, 2)
    ckvf = ckv.float()
    scores = torch.einsum("bqhl,bsl->bhqs", q_lat.to(lat_t).float(), ckvf)
    scores += torch.einsum("bqhr,bsr->bhqs", q_rope.float(), kr.float())
    scores *= mla_scale(cfg)
    k_pos = torch.arange(ckv.shape[1], device=ckv.device)
    if lo:
        k_pos += lo
    scores.masked_fill_(~mask_fn(k_pos), ref.NEG_INF)
    o_lat = _softmax_pv(scores, lambda pr: torch.einsum(
        "bhqs,bsl->bqhl", pr.to(lat_t).float(), ckvf), sharded)
    if spread:
        o_lat = SH.split(o_lat, 2)
    uv_t = w_uv.dtype if cast else torch.float32
    return torch.einsum("bqhl,lhv->bqhv", o_lat.to(uv_t).float(),
                        w_uv.float())


def _mla_absorbed_attn(p: dict, cfg: ModelConfig, q_nope, q_rope, ckv_cache,
                       kr_cache, *, q_offset: int, kv_len: int,
                       window: int = 0) -> torch.Tensor:
    """Absorbed MLA attention for a chunk of queries directly in the
    compressed latent space (the reference's, used by ``mla_prefill``
    under "seqkv"): q_nope/q_rope (b, sq, h, ·) at positions q_offset +
    [0, sq); caches (b, S, lora) / (b, S, rope), causal, keys below
    kv_len, inside the window.  Plain torch ops, as the reference's plain
    jnp.  Returns (b, sq, h, v_head_dim) f32."""
    sq = q_nope.shape[1]
    q_pos = q_offset + torch.arange(sq, device=q_nope.device)

    def mask(k_pos):
        m = (q_pos[:, None] >= k_pos[None, :]) & (k_pos[None, :] < kv_len)
        if window:
            m = m & (k_pos[None, :] > q_pos[:, None] - window)
        return m[None, None]
    return _latent_attn(p, cfg, q_nope, q_rope, ckv_cache, kr_cache, mask,
                        cast=True)


def mla_scale(cfg: ModelConfig) -> float:
    """Softmax scale of MLA: over the full query/key head width."""
    return (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim) ** -0.5


def mla_prefill(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict,
                *, q_offset: int = 0, window: int = 0):
    """Dense MLA prefill chunk against the compressed-latent cache
    {"ckv": (b, S, lora), "krope": (b, S, rope)}: the chunk's latent is
    written at [q_offset, q_offset + s) in place, the written prefix is
    decompressed through wkv_b into per-head K (nope ++ the shared RoPE
    key, width qk_nope + qk_rope) and V (width v_head_dim), and the
    chunk attends it through ``ops.prefill_attention``'s dense form,
    kernel 5, causal, with kv_len = q_offset + s and the layer's window.

    The kernel's scale, K's width to the -1/2, is MLA's (qk_nope +
    qk_rope) ** -0.5.  The reference decompresses the whole cache of S
    positions; this decompresses only the q_offset + s written ones,
    which is the same function: kernel 5 reads no key at or past
    kv_len.  Returns (attention output (b, s, d), cache)."""
    m = cfg.mla
    b, s, _ = x.shape
    positions = q_offset + torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_kv, k_rope = _mla_kv_latent(p, cfg, x, positions)
    n = q_offset + s
    SH.write_seq(cache["ckv"], c_kv, q_offset)
    SH.write_seq(cache["krope"], k_rope, q_offset)
    if SH.opt_on("seqkv"):
        # absorbed latent attention over the seq-sharded compressed
        # cache: scores / PV reduce over the sharded seq dim; no
        # decompression of the whole cache and no all-gather of it
        out = _mla_absorbed_attn(p, cfg, q_nope, q_rope, cache["ckv"],
                                 cache["krope"], q_offset=q_offset,
                                 kv_len=n, window=window)
        return SH.row(out.reshape(b, s, -1).to(x.dtype), p["wo"]), cache
    ckv = SH.gather_seq(cache["ckv"])[:, :n]
    krope = SH.gather_seq(cache["krope"])[:, :n]
    kvb = SH.col_heads(ckv, p["wkv_b"], None, cfg.n_heads,
                       m.qk_nope_head_dim + m.v_head_dim,
                       SH.heads_local(cfg.n_heads))
    k_nope, v = kvb.split([m.qk_nope_head_dim, m.v_head_dim], -1)
    h = kvb.shape[2]
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, krope[:, :, None, :].expand(
        b, n, h, m.qk_rope_head_dim)], -1)
    kv_len = torch.full((b,), n, dtype=torch.int32, device=x.device)
    out = ops.prefill_attention(q, k, v.contiguous(), kv_len, q_offset,
                                window=window)
    return SH.row(out.reshape(b, s, -1), p["wo"]), cache


def mla_forward(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                window: int = 0) -> torch.Tensor:
    """Full-sequence (train-mode) MLA of x (b, s, d): the latent of every
    position decompressed through wkv_b into per-head K (nope ++ the
    shared RoPE key) and V, attended causally through kernel 5 at MLA's
    widths and scale, as ``mla_prefill`` does for a chunk.  Returns (b,
    s, d)."""
    m = cfg.mla
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_kv, k_rope = _mla_kv_latent(p, cfg, x, positions)
    kvb = SH.col_heads(c_kv, p["wkv_b"], None, cfg.n_heads,
                       m.qk_nope_head_dim + m.v_head_dim,
                       SH.heads_local(cfg.n_heads))
    k_nope, v = kvb.split([m.qk_nope_head_dim, m.v_head_dim], -1)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, kvb.shape[2], m.qk_rope_head_dim)], -1)
    return SH.row(_train_attention(q, k, v, window).reshape(b, s, -1),
                  p["wo"])


def mla_decode_attn(p: dict, cfg: ModelConfig, q_nope, q_rope, ckv, krope,
                    pos, window: int = 0) -> torch.Tensor:
    """Absorbed one-token MLA attention over the dense latent cache, in
    f32: q_nope (b, 1, h, nope) absorbed through W_uk, scores against
    every cache position at or below ``pos`` (b, 1) (and inside the
    window), PV on the latent, W_uv on the way out.  ckv: (b, S, lora);
    krope: (b, S, rope), each may be a DTensor sharding its sequence
    (``_latent_attn``).  Returns (b, 1, h, v_head_dim) f32.  Plain torch
    ops, as the reference's plain jnp (``mla_decode``)."""
    def mask(k_pos):
        valid = k_pos[None, :] <= pos
        if window:
            valid = valid & (k_pos[None, :] > pos - window)
        return valid[:, None, None, :]
    return _latent_attn(p, cfg, q_nope, q_rope, ckv, krope, mask,
                        cast=False)


def mla_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict,
               pos: int, *, window: int = 0):
    """One-token MLA decode at a position ``pos`` (an int) shared by the
    batch, against the dense latent cache: the token's latent is written
    in place at min(pos, S - 1) (where the reference's dynamic update
    clamps it), then ``mla_decode_attn``.  Returns (out (b, 1, d),
    cache)."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_kv, k_rope = _mla_kv_latent(p, cfg, x, positions)
    slot = min(pos, cache["ckv"].shape[1] - 1)
    cache["ckv"][:, slot:slot + 1] = c_kv
    cache["krope"][:, slot:slot + 1] = k_rope
    out = mla_decode_attn(p, cfg, q_nope, q_rope, cache["ckv"],
                          cache["krope"], positions, window)
    return out.reshape(b, 1, -1).to(x.dtype) @ p["wo"], cache


def mla_prefill_paged(p: dict, cfg: ModelConfig, x: torch.Tensor,
                      ckv_layer: torch.Tensor, kr_layer: torch.Tensor, *,
                      positions, q_offset, kv_len, block_tables,
                      pages_idx, offs_idx, window: int = 0) -> torch.Tensor:
    """Fused chunk prefill against one layer's paged LATENT pool.

    x: (segs, sq, d) packed segments; ckv_layer: (n_pages, page, lora)
    compressed-latent pages and kr_layer: (n_pages, page, rope) RoPE-key
    pages, both updated in place.  The chunk's latent is scattered into
    the pool, then the segments attend in absorbed form against the
    block-table gather of the latent, in f32, with the reference's plain
    softmax over ``NEG_INF`` (a pad segment with kv_len 0 averages its
    gathered pages, as there).  ``q_offset`` is implied by
    ``positions``.  Returns the attention output (segs, sq, d)."""
    del q_offset
    b, s, _ = x.shape
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_kv, k_rope = _mla_kv_latent(p, cfg, x, positions)
    idx = (pages_idx.long(), offs_idx.long())
    ckv_layer.index_put_(idx, c_kv.to(ckv_layer.dtype))
    kr_layer.index_put_(idx, k_rope.to(kr_layer.dtype))
    page, lora = ckv_layer.shape[1:]
    n_keys = block_tables.shape[1] * page
    bt = block_tables.long()
    ckv_seq = ckv_layer[bt].reshape(b, n_keys, lora).float()
    kr_seq = kr_layer[bt].reshape(b, n_keys, -1).float()
    w_uk, w_uv = _mla_absorb(p, cfg)
    q_lat = torch.einsum("bqhd,lhd->bqhl", q_nope.float(), w_uk.float())
    # in place: at full width one (segs, h, sq, keys) f32 score tensor
    # is gigabytes
    scores = torch.einsum("bqhl,bsl->bhqs", q_lat, ckv_seq)
    scores += torch.einsum("bqhr,bsr->bhqs", q_rope.float(), kr_seq)
    scores *= mla_scale(cfg)
    k_pos = torch.arange(n_keys, device=x.device)
    mask = ((positions[:, :, None] >= k_pos[None, None, :])
            & (k_pos[None, None, :] < kv_len[:, None, None]))
    if window:
        mask = mask & (k_pos[None, None, :] > positions[:, :, None] - window)
    scores = scores.masked_fill_(~mask[:, None], ref.NEG_INF)
    pattn = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhqs,bsl->bqhl", pattn, ckv_seq)
    out = torch.einsum("bqhl,lhv->bqhv", o_lat, w_uv.float())
    return out.reshape(b, s, -1).to(x.dtype) @ p["wo"]


def mla_decode_paged(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     ckv_layer: torch.Tensor, kr_layer: torch.Tensor, *,
                     pos, pages, offs, block_tables, lens,
                     window: int = 0) -> torch.Tensor:
    """Batched one-token MLA decode against one layer's latent pool.

    Queries are absorbed through W_uk on the way in (f32), the paged MLA
    kernel streams the live latent pages and accumulates o_lat in the
    latent space, and W_uv up-projects once on the way out.  pos, pages,
    offs, block_tables, lens as ``gqa_decode_paged``; the new token's
    latent is written in place into ckv_layer/kr_layer.  Returns the
    attention output (slots, 1, d)."""
    b = x.shape[0]
    positions = pos[:, None]
    q_nope, q_rope = _mla_q(p, cfg, x, positions)           # (b, 1, h, ·)
    c_kv, k_rope = _mla_kv_latent(p, cfg, x, positions)
    idx = (pages.long(), offs.long())
    ckv_layer.index_put_(idx, c_kv[:, 0].to(ckv_layer.dtype))
    kr_layer.index_put_(idx, k_rope[:, 0].to(kr_layer.dtype))
    w_uk, w_uv = _mla_absorb(p, cfg)
    q_lat = torch.einsum("bhd,lhd->bhl", q_nope[:, 0].float(), w_uk.float())
    o_lat = ops.mla_decode_attention(
        q_lat, q_rope[:, 0].float(), ckv_layer, kr_layer, block_tables,
        lens, scale=mla_scale(cfg), window=window)
    out = torch.einsum("bhl,lhv->bhv", o_lat.float(), w_uv.float())
    return out.reshape(b, 1, -1).to(x.dtype) @ p["wo"]


# ---------------------------------------------------------------------------
# Cross-attention (VLM image layers / whisper encoder-decoder)
# ---------------------------------------------------------------------------
# up-cast copies of weights, by (id of the weight, type): (weak reference
# to the weight, its version counter when copied (None for an inference
# tensor, which has none), the copy)
_PROMOTED: dict = {}


def _promote(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w`` in ``dtype``, copied once per weight and type: the copy is
    kept while the weight lives and made anew only if the weight was
    changed in place since.  A weight that takes a gradient is cast
    afresh on every call, so the gradient reaches it."""
    if w.dtype == dtype:
        return w
    if w.requires_grad and torch.is_grad_enabled():
        return w.to(dtype)
    key = (id(w), dtype)
    version = None if w.is_inference() else w._version
    hit = _PROMOTED.get(key)
    if hit is not None and hit[0]() is w and hit[1] == version:
        return hit[2]
    ref_w = weakref.ref(w, lambda _, k=key: _PROMOTED.pop(k, None))
    _PROMOTED[key] = (ref_w, version, w.to(dtype))
    return _PROMOTED[key][2]


def promoted(p: dict, dtype: torch.dtype) -> dict:
    """The weights of ``p`` in the type JAX promotes ``x @ w`` to for an
    ``x`` of ``dtype``: an f32 activation against bf16 weights runs in
    f32, as in the reference, where torch would refuse the mixed
    product.  Weights already of that type are not copied; the others
    are up-cast once per weight, not on every call."""
    return {k: _promote(w, torch.promote_types(dtype, w.dtype))
            for k, w in p.items()}


def cross_kv(p: dict, cfg: ModelConfig, enc: torch.Tensor):
    """Cross K/V (b, s, kvh, hd) from the encoder output ``enc`` (b, s,
    d), in the promoted type of enc and the weights: f32 for the f32
    ``enc`` the engines pass, whatever the model's dtype.  The caller
    casts to the pool's dtype at the scatter."""
    b, s, _ = enc.shape
    kvh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    w = promoted({"wk": p["wk"], "wv": p["wv"]}, enc.dtype)
    k = (enc.to(w["wk"].dtype) @ w["wk"]).reshape(b, s, kvh, hd)
    v = (enc.to(w["wv"].dtype) @ w["wv"]).reshape(b, s, kvh, hd)
    return k, v


def encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                      ) -> torch.Tensor:
    """Bidirectional attention of the encoder stack: q (b, s, h, hd),
    k/v (b, s, kvh, hd).  f32 scores, a softmax over exactly the s
    frames (nothing padded), and PV.  The reference runs this as its
    blocked ``flash_attn(causal=False, kv_len=s)`` in plain ``jnp``, not
    a Pallas kernel.  Returns (b, s, h, hd) in q's dtype."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.float().reshape(b, s, kvh, h // kvh, hd)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float())
    pattn = torch.softmax(scores * hd ** -0.5, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", pattn, v.float())
    return out.reshape(b, s, h, -1).to(q.dtype)


def cross_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Dense cross-attention sublayer: x (b, s, d) normed decoder
    activations attend every one of the encoder K/V (b, enc, kvh, hd),
    non-causally, through kernel 5 (``ops.prefill_attention``'s dense
    form, q_offset 0, kv_len = enc for every request); s may exceed enc.

    The reference's ``flash_attn`` computes in f32 whatever its inputs
    and returns q's dtype; kernel 5 takes one dtype for q and K/V.  So
    the queries run in the promoted type of q and K/V: on a request's
    first chunk the K/V are the unrounded f32 ones ``cross_kv`` gives
    for the f32 encoder output, and a bf16 model's queries are up-cast
    (exactly) to run the f32 body; the output is cast back to q's
    dtype.  Returns the attention output (b, s, d)."""
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.resolved_head_dim)
    dt = torch.promote_types(q.dtype, k.dtype)
    kv_len = torch.full((b,), k.shape[1], dtype=torch.int32,
                        device=x.device)
    out = ops.prefill_attention(q.to(dt), k.to(dt), v.to(dt), kv_len, 0,
                                causal=False)
    return out.to(q.dtype).reshape(b, s, -1) @ p["wo"]


def cross_attend_paged(p: dict, cfg: ModelConfig, x: torch.Tensor,
                       k_layer: torch.Tensor, v_layer: torch.Tensor, *,
                       cross_bt, cross_len) -> torch.Tensor:
    """Read-only cross-attention sublayer of a fused paged prefill
    chunk: every segment's cross pages already hold their encoder K/V,
    so no encoder work and no scatter.  x: (segs, sq, d) normed decoder
    activations; cross_bt: (segs, cross_slots) the read-only cross block
    table; cross_len: (segs,) encoder tokens (0 for a pad segment, whose
    rows then give 0).  Every query attends all ``cross_len`` encoder
    tokens (kernel 1, non-causal, q_offset 0).  Returns the attention
    output (segs, sq, d)."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    out = ops.prefill_attention(q, k_layer, v_layer, cross_len,
                                torch.zeros_like(cross_len),
                                block_table=cross_bt, causal=False)
    return out.reshape(b, s, -1) @ p["wo"]


def cross_prefill_paged(p: dict, cfg: ModelConfig, x: torch.Tensor,
                        k_layer: torch.Tensor, v_layer: torch.Tensor, *,
                        enc_h, cross_bt, cross_len, cross_pg,
                        cross_off) -> torch.Tensor:
    """Cross-attention sublayer of the fused paged prefill chunk that
    carries encoder work: the one-shot in-place scatter of the encoder
    K/V into the cross pages, then the read of ``cross_attend_paged``.

    enc_h: (segs, enc_ctx, d) encoder output per segment (f32);
    cross_pg/cross_off: (segs, enc_ctx) physical (page, in-page) slot of
    each encoder token's write.  Segments past their request's first
    chunk point these at the scratch page, so the encoder K/V lands once
    per request; the scratch page takes many duplicate writes and is
    never read (``cross_len`` masks it).  Returns the attention output
    (segs, sq, d)."""
    ck, cv = cross_kv(p, cfg, enc_h)
    idx = (cross_pg.long(), cross_off.long())
    k_layer.index_put_(idx, ck.to(k_layer.dtype))
    v_layer.index_put_(idx, cv.to(v_layer.dtype))
    return cross_attend_paged(p, cfg, x, k_layer, v_layer,
                              cross_bt=cross_bt, cross_len=cross_len)


def cross_decode_paged(p: dict, cfg: ModelConfig, x: torch.Tensor,
                       k_layer: torch.Tensor, v_layer: torch.Tensor, *,
                       cross_bt, cross_len) -> torch.Tensor:
    """Batched one-token cross attention against the read-only cross
    pages, with no scatter: the encoder K/V was installed at admission
    and never changes.  x: (slots, 1, d); cross_bt: (slots,
    cross_slots); cross_len: (slots,) encoder tokens per slot (0 for an
    empty slot).  Returns the attention output (slots, 1, d)."""
    b = x.shape[0]
    q = (x @ p["wq"]).reshape(b, cfg.n_heads, cfg.resolved_head_dim)
    out = ops.cross_decode_attention(q, k_layer, v_layer, cross_bt,
                                     cross_len)
    return out.reshape(b, 1, -1) @ p["wo"]
