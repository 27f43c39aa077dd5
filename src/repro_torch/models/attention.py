"""GQA self-attention on the paged serving path: RoPE, the QKV
projections, and the prefill/decode attention against one layer's
page pool through the CUDA kernels in ``kernels/ops.py``.

The reference updates its pools functionally and returns them; here
``gqa_prefill_paged``/``gqa_decode_paged`` scatter the new K/V into the
layer's pool tensors IN PLACE (``index_put_``) and return only the
attention output.  MLA and cross-attention come with their slices.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
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
