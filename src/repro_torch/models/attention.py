"""Self-attention on the paged serving path: RoPE, GQA and MLA
(DeepSeek-V2 multi-head latent attention) projections, and the
prefill/decode attention against one layer's page pool.

GQA attends through the CUDA kernels in ``kernels/ops.py`` in both
phases.  MLA attends in its absorbed form over a LATENT pool (the
compressed latent and the decoupled RoPE key per token): prefill is
plain torch ops over a block-table gather of the latent, as in the
reference, which has no kernel there; decode goes through the paged
MLA kernel.

The reference updates its pools functionally and returns them; here the
``*_paged`` functions scatter the new K/V (or latent) into the layer's
pool tensors IN PLACE (``index_put_``) and return only the attention
output.  Cross-attention comes with its slice.
"""
from __future__ import annotations

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
