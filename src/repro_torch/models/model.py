"""Model assembly for the paged serving path.

Entry points (pure functions of (params, cfg, ...), except that the
page pools are updated in place):
  * ``init_params``       — random init on a device, from a generator
  * ``paged_supported``   — whether the port's paged path runs a config
  * ``encoder_forward``   — the encoder-decoder models' bidirectional
                            encoder over stub-frontend embeddings
  * ``prefill_paged``     — one WHOLE fixed-size chunk as a single fused
                            call: segments of multiple requests packed on
                            the batch dim with per-segment q_offset/kv_len
  * ``decode_logits_paged`` / ``decode_step_paged`` — full-slot-batch
                            decode against the pool via block tables;
                            greedy argmax stays on the device

Parameters are a plain dict: ``embed`` (V, d), ``final_norm`` (d,),
optional ``lm_head``/``pos_embed``, and ``layers``, one dict per layer
in execution order: {norm1, attn, norm2, mlp | moe[, norm_c, cross]}.
``attn`` is GQA {wq, wk, wv, wo[, bq, bk, bv]} or MLA {wq | wq_a,
q_norm, wq_b; wkv_a, kv_norm, wkv_b, wo}; ``mlp`` is {wi, wo}; ``moe``
is {router (f32), wi (E, d, ·), wo (E, ff, d)[, shared_wi, shared_wo]};
CROSS_ATTN layers add ``norm_c`` and ``cross`` {wq, wk, wv, wo}.  With
MoE the prefix layers are dense and the others routed (DeepSeek-V2's
first-k-dense).  Encoder-decoder configs add ``encoder`` {blocks: a
list of GQA + dense-MLP layer dicts, norm}.  The reference's scanned
``body`` stack is unrolled into that list by
``repro_torch.params.from_reference``.

The page pools are (L, n_pages, page, kvh, hd) K/V for GQA and (L,
n_pages, page, lora) / (L, n_pages, page, rope) latent / RoPE-key pages
for MLA.  CROSS_ATTN layers read their encoder K/V from read-only
cross pages of the same GQA pool, through a second block table.  The
dense cache path, training, sliding-window paging and on-device
sampling come with their slices.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models import mlp as MLP
from repro_torch.models.config import ATTN, CROSS_ATTN, ModelConfig

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
            f"{cfg.name}: the port runs full-attention ATTN and "
            "CROSS_ATTN blocks only; other block kinds come with their "
            "slices")
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

    def cross():
        h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        return {"wq": normal((d, h * hd), d ** -0.5),
                "wk": normal((d, kvh * hd), d ** -0.5),
                "wv": normal((d, kvh * hd), d ** -0.5),
                "wo": normal((h * hd, d), (h * hd) ** -0.5)}

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
    for i, kind in enumerate(cfg.layer_kinds):
        layer = {"norm1": ones(d), "attn": mla() if cfg.mla else gqa(),
                 "norm2": ones(d)}
        # DeepSeek-V2's first-k-dense rule: prefix layers stay dense
        if cfg.moe is not None and i >= len(cfg.prefix):
            layer["moe"] = routed()
        else:
            layer["mlp"] = dense()
        if kind == CROSS_ATTN:
            layer["norm_c"] = ones(d)
            layer["cross"] = cross()
        layers.append(layer)
    params["layers"] = layers
    if cfg.is_encoder_decoder:
        # whisper's encoder: bidirectional GQA blocks with dense MLPs
        params["encoder"] = {
            "blocks": [{"norm1": ones(d), "attn": gqa(), "norm2": ones(d),
                        "mlp": dense()}
                       for _ in range(cfg.encoder.n_layers)],
            "norm": ones(d)}
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


def encoder_forward(params, cfg: ModelConfig, enc_embeds):
    """Bidirectional encoder stack over stub-frontend embeddings (b, s,
    d).  It runs in the type JAX promotes the embeddings and weights to:
    the engines pass f32 embeddings, so a bf16 model's encoder runs in
    f32 on up-cast weights, as the reference's does."""
    h = enc_embeds
    b, s, _ = h.shape
    positions = torch.arange(s, device=h.device)[None, :]
    for p in params["encoder"]["blocks"]:
        n = B.rms_norm(h, p["norm1"], cfg.norm_eps)
        attn = A.promoted(p["attn"], n.dtype)
        q, k, v = A.gqa_qkv(attn, cfg, n, positions)
        a = A.encoder_attention(q, k, v)
        h = h + a.reshape(b, s, -1) @ attn["wo"]
        n2 = B.rms_norm(h, p["norm2"], cfg.norm_eps)
        h = h + MLP.mlp_forward(A.promoted(p["mlp"], n2.dtype), cfg, n2)
    return B.rms_norm(h, params["encoder"]["norm"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# paged execution backend (serving hot path)
# ---------------------------------------------------------------------------
def paged_supported(cfg: ModelConfig) -> bool:
    """True if the port's paged path serves this config: every layer a
    full-attention ATTN or CROSS_ATTN block, GQA or MLA, with a dense
    MLP or a routed MoE; a CROSS_ATTN layer's encoder K/V lives in
    read-only cross pages of the same pool.  MLA with cross-attention
    has no arch and is refused, as in the reference.  The reference also
    pages sliding-window archs; they come with their slice."""
    kinds = set(cfg.layer_kinds)
    return (kinds <= {ATTN, CROSS_ATTN} and not cfg.sliding_window
            and not (cfg.mla is not None and CROSS_ATTN in kinds))


def _paged_attn_block(p, cfg: ModelConfig, x, k_layer, v_layer, attn,
                      cross=None):
    """One ATTN/CROSS_ATTN block (norm, attention-vs-pool, optional
    cross-attention-vs-cross-pages, MLP or MoE) on the paged path.
    ``attn(p_attn, h, k_layer, v_layer)`` scatters into the layer's pool
    in place and attends for the current mode; ``cross(p_cross, hc,
    k_layer, v_layer)`` does the same against the request's read-only
    cross block table, in CROSS_ATTN layers only."""
    h = B.rms_norm(x, p["norm1"], cfg.norm_eps)
    x = x + attn(p["attn"], h, k_layer, v_layer)
    if cross is not None and "cross" in p:
        hc = B.rms_norm(x, p["norm_c"], cfg.norm_eps)
        x = x + cross(p["cross"], hc, k_layer, v_layer)
    h2 = B.rms_norm(x, p["norm2"], cfg.norm_eps)
    if "moe" in p:
        return x + MLP.moe_forward(p["moe"], cfg, h2)[0]
    return x + MLP.mlp_forward(p["mlp"], cfg, h2)


def _run_layers_paged(params, cfg: ModelConfig, h, k_pool, v_pool, attn,
                      cross=None):
    """Layer runner over the per-layer page pools (GQA K/V or MLA
    latent / RoPE key, see the module docstring): pool rows are indexed
    by absolute layer id, as the engines' PagePool layout expects.
    CROSS_ATTN layers also run ``cross`` against the same layer slice
    (self and cross pages share the pool; the tables differ)."""
    for layer, p in enumerate(params["layers"]):
        h = _paged_attn_block(p, cfg, h, k_pool[layer], v_pool[layer],
                              attn, cross)
    return h


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

    Cross-attention archs (VLM / enc-dec) thread a SECOND block table:
    enc_embeds: (segs, enc_ctx, d) frontend embeddings, run through the
    encoder stack for enc-dec archs; cross_bt: (segs, cross_slots)
    read-only cross pages; cross_len: (segs,) valid encoder tokens;
    cross_pg/cross_off: (segs, enc_ctx) one-shot cross-KV write slots
    (the scratch page for every segment but a request's first).  With
    ``cross_bt`` but no ``enc_embeds`` the chunk only reads the cross
    pages: no encoder work, no scatter.
    All index tensors are int32 on the pools' device.

    Returns (next_tokens (segs,) int32, last_logits (segs, V)) —
    next_tokens[i] is only meaningful for segments that complete their
    request's prompt.
    """
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

    cross = None
    if enc_embeds is not None:
        enc_h = (encoder_forward(params, cfg, enc_embeds)
                 if cfg.is_encoder_decoder else enc_embeds)

        def cross(p, x, k_layer, v_layer):
            return A.cross_prefill_paged(
                p, cfg, x, k_layer, v_layer, enc_h=enc_h,
                cross_bt=cross_bt, cross_len=cross_len,
                cross_pg=cross_pg, cross_off=cross_off)
    elif cross_bt is not None:
        def cross(p, x, k_layer, v_layer):
            return A.cross_attend_paged(p, cfg, x, k_layer, v_layer,
                                        cross_bt=cross_bt,
                                        cross_len=cross_len)

    h = _run_layers_paged(params, cfg, h, k_pool, v_pool, attn, cross)
    last_h = torch.take_along_dim(h, last_idx.long()[:, None, None], dim=1)
    logits = _head(params, cfg, last_h)[:, 0]           # (segs, V)
    return torch.argmax(logits, dim=-1).to(torch.int32), logits


def decode_logits_paged(params, cfg: ModelConfig, tokens, pos, pages, offs,
                        block_tables, lens, k_pool, v_pool, cross_bt=None,
                        cross_len=None):
    """Full-slot-batch decode iteration against the shared page pool;
    returns the logits (slots, V).

    tokens: (slots, 1) last emitted token per slot; pos: (slots,) append
    position (== tokens already cached); pages/offs: (slots,) physical
    slot of the appended token (dead slots -> scratch page), written in
    place into k_pool/v_pool; block_tables: (slots, n_slots); lens:
    (slots,) valid tokens including the append.  Cross-attention archs
    also read each slot's read-only cross pages: cross_bt: (slots,
    cross_slots); cross_len: (slots,) encoder tokens per slot (0 for an
    empty slot); nothing is scattered into them at decode."""
    h = _embed(params, cfg, tokens, pos[:, None])

    attn_fn = (A.mla_decode_paged if cfg.mla is not None
               else A.gqa_decode_paged)

    def attn(p, x, k_layer, v_layer):
        return attn_fn(
            p, cfg, x, k_layer, v_layer, pos=pos, pages=pages, offs=offs,
            block_tables=block_tables, lens=lens,
            window=cfg.sliding_window)

    cross = None
    if cross_bt is not None:
        def cross(p, x, k_layer, v_layer):
            return A.cross_decode_paged(p, cfg, x, k_layer, v_layer,
                                        cross_bt=cross_bt,
                                        cross_len=cross_len)

    h = _run_layers_paged(params, cfg, h, k_pool, v_pool, attn, cross)
    return _head(params, cfg, h)[:, -1]


def decode_step_paged(params, cfg: ModelConfig, tokens, pos, pages, offs,
                      block_tables, lens, k_pool, v_pool,
                      cross_bt=None, cross_len=None,
                      temps=None, top_ks=None, seeds=None):
    """``decode_logits_paged`` with greedy token selection on the device:
    returns next_tokens (slots,) int32; k_pool/v_pool are updated in
    place.  Sampling (``temps``/``top_ks``/``seeds``) comes with the
    on-device sampling slice."""
    if any(a is not None for a in (temps, top_ks, seeds)):
        raise NotImplementedError(
            "decode_step_paged sampling: comes with the on-device "
            "sampling slice; the port decodes greedily")
    logits = decode_logits_paged(params, cfg, tokens, pos, pages, offs,
                                 block_tables, lens, k_pool, v_pool,
                                 cross_bt, cross_len)
    return torch.argmax(logits, dim=-1).to(torch.int32)
