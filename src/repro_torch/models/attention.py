"""Attention on the paged serving path: RoPE, GQA and MLA (DeepSeek-V2
multi-head latent attention) projections, the prefill/decode attention
against one layer's page pool, and the cross-attention of VLM and
encoder-decoder models against read-only cross pages of the same pool.

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
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
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
    c_kv, k_rope = (x @ p["wkv_a"]).split(
        [m.kv_lora_rank, m.qk_rope_head_dim], -1)
    c_kv = _rms(c_kv, p["kv_norm"])
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return c_kv, k_rope[:, :, 0, :]


def _mla_absorb(p: dict, cfg: ModelConfig):
    """Split wkv_b into the absorbed up-projections W_uk (lora, h, nope)
    and W_uv (lora, h, v)."""
    m = cfg.mla
    wkv_b = p["wkv_b"].reshape(m.kv_lora_rank, cfg.n_heads,
                               m.qk_nope_head_dim + m.v_head_dim)
    return wkv_b.split([m.qk_nope_head_dim, m.v_head_dim], -1)


def mla_scale(cfg: ModelConfig) -> float:
    """Softmax scale of MLA: over the full query/key head width."""
    return (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim) ** -0.5


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
    changed in place since."""
    if w.dtype == dtype:
        return w
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
