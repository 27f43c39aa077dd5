"""Model assembly for the paged serving path.

Entry points (pure functions of (params, cfg, ...), except that the
page pools are updated in place):
  * ``init_params``       — random init on a device, from a generator
  * ``paged_supported``   — whether the port's paged path runs a config
  * ``prefill_paged``     — one WHOLE fixed-size chunk as a single fused
                            call: segments of multiple requests packed on
                            the batch dim with per-segment q_offset/kv_len
  * ``decode_logits_paged`` / ``decode_step_paged`` — full-slot-batch
                            decode against the pool via block tables;
                            greedy argmax stays on the device

Parameters are a plain dict: ``embed`` (V, d), ``final_norm`` (d,),
optional ``lm_head``/``pos_embed``, and ``layers``, one dict per layer
in execution order: {norm1, attn, norm2, mlp | moe}.  ``attn`` is GQA
{wq, wk, wv, wo[, bq, bk, bv]} or MLA {wq | wq_a, q_norm, wq_b; wkv_a,
kv_norm, wkv_b, wo}; ``mlp`` is {wi, wo}; ``moe`` is {router (f32), wi
(E, d, ·), wo (E, ff, d)[, shared_wi, shared_wo]}.  With MoE the prefix
layers are dense and the others routed (DeepSeek-V2's first-k-dense).
The reference's scanned ``body`` stack is unrolled into that list by
``repro_torch.params.from_reference``.

The page pools are (L, n_pages, page, kvh, hd) K/V for GQA and (L,
n_pages, page, lora) / (L, n_pages, page, rope) latent / RoPE-key pages
for MLA.  The dense cache path, training, cross-attention,
sliding-window paging and on-device sampling come with their slices.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models import mlp as MLP
from repro_torch.models.config import ATTN, ModelConfig

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Dict[str, Any]:
    """Random weights with the distributions of the reference's
    ``init_params`` (normal times the same scales, ones for norms, zeros
    for biases), drawn from ``generator`` — the same law, not the same
    numbers.  The generator must live on ``device``."""
    cfg.validate()
    if not paged_supported(cfg):
        raise NotImplementedError(
            f"{cfg.name}: the port runs full-attention ATTN blocks only; "
            "other block kinds come with their slices")
    dtype = torch_dtype(cfg)
    d = cfg.d_model

    def normal(shape, scale, dt=dtype):
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return x.mul_(scale).to(dt)     # in place: expert stacks are GBs

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    def gqa():
        h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        attn = {"wq": normal((d, h * hd), d ** -0.5),
                "wk": normal((d, kvh * hd), d ** -0.5),
                "wv": normal((d, kvh * hd), d ** -0.5),
                "wo": normal((h * hd, d), (h * hd) ** -0.5)}
        if cfg.qkv_bias:
            attn.update(bq=zeros(h * hd), bk=zeros(kvh * hd),
                        bv=zeros(kvh * hd))
        return attn

    def mla():
        m, h = cfg.mla, cfg.n_heads
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        attn = {}
        if m.q_lora_rank:
            attn["wq_a"] = normal((d, m.q_lora_rank), d ** -0.5)
            attn["q_norm"] = ones(m.q_lora_rank)
            attn["wq_b"] = normal((m.q_lora_rank, h * qk),
                                  m.q_lora_rank ** -0.5)
        else:
            attn["wq"] = normal((d, h * qk), d ** -0.5)
        attn["wkv_a"] = normal((d, m.kv_lora_rank + m.qk_rope_head_dim),
                               d ** -0.5)
        attn["kv_norm"] = ones(m.kv_lora_rank)
        attn["wkv_b"] = normal(
            (m.kv_lora_rank, h * (m.qk_nope_head_dim + m.v_head_dim)),
            m.kv_lora_rank ** -0.5)
        attn["wo"] = normal((h * m.v_head_dim, d),
                            (h * m.v_head_dim) ** -0.5)
        return attn

    glu = 2 if cfg.mlp_act == "swiglu" else 1

    def dense():
        return {"wi": normal((d, glu * cfg.d_ff), d ** -0.5),
                "wo": normal((cfg.d_ff, d), cfg.d_ff ** -0.5)}

    def routed():
        moe = cfg.moe
        ff, e = moe.expert_ff or cfg.d_ff, moe.n_experts
        p = {"router": normal((d, e), d ** -0.5, torch.float32),
             "wi": normal((e, d, glu * ff), d ** -0.5),
             "wo": normal((e, ff, d), ff ** -0.5)}
        if moe.n_shared:
            sff = ff * moe.n_shared
            p["shared_wi"] = normal((d, glu * sff), d ** -0.5)
            p["shared_wo"] = normal((sff, d), sff ** -0.5)
        return p

    params: Dict[str, Any] = {"embed": normal((cfg.vocab_size, d), d ** -0.5),
                              "final_norm": ones(d)}
    if cfg.n_positions:
        params["pos_embed"] = normal((cfg.n_positions, d), d ** -0.5)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size), d ** -0.5)
    layers = []
    for i in range(cfg.n_layers):
        layer = {"norm1": ones(d), "attn": mla() if cfg.mla else gqa(),
                 "norm2": ones(d)}
        # DeepSeek-V2's first-k-dense rule: prefix layers stay dense
        if cfg.moe is not None and i >= len(cfg.prefix):
            layer["moe"] = routed()
        else:
            layer["mlp"] = dense()
        layers.append(layer)
    params["layers"] = layers
    return params


# ---------------------------------------------------------------------------
# embeddings / heads
# ---------------------------------------------------------------------------
def _embed(params, cfg: ModelConfig, tokens, positions):
    h = params["embed"][tokens.long()]
    if cfg.n_positions:
        idx = torch.clamp(positions.long(), max=cfg.n_positions - 1)
        h = h + params["pos_embed"][idx]
    return h


def _head(params, cfg: ModelConfig, h):
    h = B.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return (h @ params["embed"].T if cfg.tie_embeddings
            else h @ params["lm_head"])


# ---------------------------------------------------------------------------
# paged execution backend (serving hot path)
# ---------------------------------------------------------------------------
def paged_supported(cfg: ModelConfig) -> bool:
    """True if the port's paged path serves this config: every layer a
    full-attention self-attention block, GQA or MLA, with a dense MLP or
    a routed MoE.  The reference also pages sliding-window and
    cross-attention archs; those come with their slices."""
    return (set(cfg.layer_kinds) == {ATTN} and not cfg.sliding_window
            and cfg.encoder is None)


def _paged_attn_block(p, cfg: ModelConfig, x, k_layer, v_layer, attn):
    """One ATTN block (norm, attention-vs-pool, MLP or MoE) on the paged
    path.  ``attn(p_attn, h, k_layer, v_layer)`` scatters into the
    layer's pool in place and attends for the current mode."""
    h = B.rms_norm(x, p["norm1"], cfg.norm_eps)
    x = x + attn(p["attn"], h, k_layer, v_layer)
    h2 = B.rms_norm(x, p["norm2"], cfg.norm_eps)
    if "moe" in p:
        return x + MLP.moe_forward(p["moe"], cfg, h2)[0]
    return x + MLP.mlp_forward(p["mlp"], cfg, h2)


def _run_layers_paged(params, cfg: ModelConfig, h, k_pool, v_pool, attn):
    """Layer runner over the per-layer page pools (GQA K/V or MLA
    latent / RoPE key, see the module docstring): pool rows are indexed
    by absolute layer id, as the engines' PagePool layout expects."""
    for layer, p in enumerate(params["layers"]):
        h = _paged_attn_block(p, cfg, h, k_pool[layer], v_pool[layer],
                              attn)
    return h


def _no_cross(kind: str, args) -> None:
    if any(a is not None for a in args):
        raise NotImplementedError(
            f"{kind} with cross-attention inputs: comes with the "
            "cross-attention slice")


def prefill_paged(params, cfg: ModelConfig, tokens, q_offset, kv_len,
                  last_idx, block_tables, pages_idx, offs_idx,
                  k_pool, v_pool, enc_embeds=None, cross_bt=None,
                  cross_len=None, cross_pg=None, cross_off=None):
    """One WHOLE fixed-size chunk as a single fused call (paper §3.3.3).

    The chunk's segments — slices of *different* requests — are packed on
    the batch dim; every layer scatters the chunk's K/V straight into the
    shared page pool (in place) and attends with per-segment scalars:
    GQA through ``kernels.ops.prefill_attention``, MLA in absorbed form
    over the gathered latent.

    tokens: (segs, sq) right-padded segment tokens;
    q_offset: (segs,) absolute position of each segment start;
    kv_len: (segs,) valid KV tokens after this segment (q_offset + len);
    last_idx: (segs,) index of each segment's last valid token;
    block_tables: (segs, n_slots) physical page ids (pad slots -> scratch
    page); pages_idx/offs_idx: (segs, sq) physical slot per token;
    k_pool/v_pool: the pools (see the module docstring), updated in
    place.
    All index tensors are int32 on the pools' device.

    Returns (next_tokens (segs,) int32, last_logits (segs, V)) —
    next_tokens[i] is only meaningful for segments that complete their
    request's prompt.
    """
    _no_cross("prefill_paged",
              (enc_embeds, cross_bt, cross_len, cross_pg, cross_off))
    sq = tokens.shape[1]
    positions = q_offset[:, None] + torch.arange(
        sq, device=tokens.device, dtype=q_offset.dtype)[None, :]
    h = _embed(params, cfg, tokens, positions)

    attn_fn = (A.mla_prefill_paged if cfg.mla is not None
               else A.gqa_prefill_paged)

    def attn(p, x, k_layer, v_layer):
        return attn_fn(
            p, cfg, x, k_layer, v_layer, positions=positions,
            q_offset=q_offset, kv_len=kv_len, block_tables=block_tables,
            pages_idx=pages_idx, offs_idx=offs_idx,
            window=cfg.sliding_window)

    h = _run_layers_paged(params, cfg, h, k_pool, v_pool, attn)
    last_h = torch.take_along_dim(h, last_idx.long()[:, None, None], dim=1)
    logits = _head(params, cfg, last_h)[:, 0]           # (segs, V)
    return torch.argmax(logits, dim=-1).to(torch.int32), logits


def decode_logits_paged(params, cfg: ModelConfig, tokens, pos, pages, offs,
                        block_tables, lens, k_pool, v_pool):
    """Full-slot-batch decode iteration against the shared page pool;
    returns the logits (slots, V).

    tokens: (slots, 1) last emitted token per slot; pos: (slots,) append
    position (== tokens already cached); pages/offs: (slots,) physical
    slot of the appended token (dead slots -> scratch page), written in
    place into k_pool/v_pool; block_tables: (slots, n_slots); lens:
    (slots,) valid tokens including the append."""
    h = _embed(params, cfg, tokens, pos[:, None])

    attn_fn = (A.mla_decode_paged if cfg.mla is not None
               else A.gqa_decode_paged)

    def attn(p, x, k_layer, v_layer):
        return attn_fn(
            p, cfg, x, k_layer, v_layer, pos=pos, pages=pages, offs=offs,
            block_tables=block_tables, lens=lens,
            window=cfg.sliding_window)

    h = _run_layers_paged(params, cfg, h, k_pool, v_pool, attn)
    return _head(params, cfg, h)[:, -1]


def decode_step_paged(params, cfg: ModelConfig, tokens, pos, pages, offs,
                      block_tables, lens, k_pool, v_pool,
                      cross_bt=None, cross_len=None,
                      temps=None, top_ks=None, seeds=None):
    """``decode_logits_paged`` with greedy token selection on the device:
    returns next_tokens (slots,) int32; k_pool/v_pool are updated in
    place.  Sampling (``temps``/``top_ks``/``seeds``) comes with the
    on-device sampling slice."""
    _no_cross("decode_step_paged", (cross_bt, cross_len))
    if any(a is not None for a in (temps, top_ks, seeds)):
        raise NotImplementedError(
            "decode_step_paged sampling: comes with the on-device "
            "sampling slice; the port decodes greedily")
    logits = decode_logits_paged(params, cfg, tokens, pos, pages, offs,
                                 block_tables, lens, k_pool, v_pool)
    return torch.argmax(logits, dim=-1).to(torch.int32)
