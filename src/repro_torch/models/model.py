"""Model assembly for the paged serving path and the dense backend.

Entry points (pure functions of (params, cfg, ...), except that the
page pools and the dense K/V caches are updated in place):
  * ``init_params``       — random init on a device, from a generator
  * ``param_count``       — the parameters ``init_params`` makes,
                            counted on the meta device (no allocation)
  * ``paged_supported``   — whether the paged path runs a config (the
                            dense backend runs the others)
  * ``encoder_forward``   — the encoder-decoder models' bidirectional
                            encoder over stub-frontend embeddings
  * ``prefill_paged``     — one WHOLE fixed-size chunk as a single fused
                            call: segments of multiple requests packed on
                            the batch dim with per-segment q_offset/kv_len
  * ``decode_logits_paged`` / ``decode_step_paged`` — full-slot-batch
                            decode against the pool via block tables;
                            token selection stays on the device
  * ``sample_tokens``     — greedy argmax or a temperature / top-k draw
                            per slot, stateless and graph-ready
  * ``init_cache`` / ``cache_insert`` / ``cache_select`` — the dense
                            backend's per-layer caches (K/V or state)
  * ``prefill`` / ``prefill_chunked`` — dense chunked prefill, attention
                            through kernel 5
  * ``decode_step`` / ``decode_step_greedy`` — dense decode, one token a
                            request at per-request positions

Parameters are a plain dict: ``embed`` (V, d), ``final_norm`` (d,),
optional ``lm_head``/``pos_embed``, and ``layers``, one dict per layer
in execution order (``blocks.init_block``): {norm1, attn, norm2, mlp |
moe[, norm_c, cross]} for the attention kinds, {norm1, rglru, norm2,
mlp} for RG-LRU and {norm, cell} for sLSTM / mLSTM.  ``attn`` is GQA
{wq, wk, wv, wo[, bq, bk, bv]} or MLA {wq | wq_a, q_norm, wq_b; wkv_a,
kv_norm, wkv_b, wo}; ``mlp`` is {wi, wo}; ``moe`` is {router (f32), wi
(E, d, ·), wo (E, ff, d)[, shared_wi, shared_wo]}; CROSS_ATTN layers
add ``norm_c`` and ``cross`` {wq, wk, wv, wo}.  With MoE the prefix
layers are dense and the others routed (DeepSeek-V2's first-k-dense).
Encoder-decoder configs add ``encoder`` {blocks: a list of GQA +
dense-MLP layer dicts, norm}.  The reference's scanned ``body`` stack is
unrolled into that list by ``repro_torch.params.from_reference``.

The page pools are (L, n_pages, page, kvh, hd) K/V for GQA and (L,
n_pages, page, lora) / (L, n_pages, page, rope) latent / RoPE-key pages
for MLA.  CROSS_ATTN layers read their encoder K/V from read-only
cross pages of the same GQA pool, through a second block table.  A
sliding window (``cfg.sliding_window``) reaches every self-attention
kernel; the engines' allocators free the pages that slid out of it.

The dense cache is a list with one dict a layer, in the order of
``layers``: {k, v} (b, S, kvh, hd) for ATTN / LOCAL_ATTN, or with MLA
{ckv (b, S, lora), krope (b, S, rope)}; a CROSS_ATTN layer adds its
encoder K/V {ck, cv} (b, enc_ctx, kvh, hd); the recurrent state for the
other kinds.  Training comes with its slice (ROADMAP A.13).
"""
from __future__ import annotations

from typing import Any, Dict, List

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
    for biases, a uniform for the RG-LRU's decay), drawn from
    ``generator`` — the same law, not the same numbers.  The generator
    must live on ``device`` (``None`` on the meta device)."""
    cfg.validate()
    dtype = torch_dtype(cfg)
    ini = B.Init(generator, device, dtype)
    d = cfg.d_model
    params: Dict[str, Any] = {"embed": ini.normal((cfg.vocab_size, d),
                                                  d ** -0.5),
                              "final_norm": ini.ones(d)}
    if cfg.n_positions:
        params["pos_embed"] = ini.normal((cfg.n_positions, d), d ** -0.5)
    if not cfg.tie_embeddings:
        params["lm_head"] = ini.normal((d, cfg.vocab_size), d ** -0.5)
    # DeepSeek-V2's first-k-dense rule: with MoE the prefix layers stay
    # dense and the others are routed
    params["layers"] = [
        B.init_block(ini, kind, cfg,
                     use_moe=cfg.moe is not None and i >= len(cfg.prefix))
        for i, kind in enumerate(cfg.layer_kinds)]
    if cfg.is_encoder_decoder:
        # whisper's encoder: bidirectional GQA blocks with dense MLPs
        params["encoder"] = {
            "blocks": [B.init_block(ini, ATTN, cfg, use_moe=False)
                       for _ in range(cfg.encoder.n_layers)],
            "norm": ini.ones(d)}
    return params


def param_count(cfg: ModelConfig) -> int:
    """Parameters of ``cfg``: ``init_params``'s leaves built on the meta
    device, so the shapes are the served ones and nothing is allocated
    (DeepSeek-V2 counts 236 G).  Tied heads count once, the encoder
    counts, and a classifier head (``n_classes``) counts as in the
    reference's ``param_count``."""
    def numel(x) -> int:
        if isinstance(x, torch.Tensor):
            return x.numel()
        values = x.values() if isinstance(x, dict) else x
        return sum(numel(v) for v in values)
    return (numel(init_params(cfg, None, device="meta"))
            + cfg.d_model * cfg.n_classes)


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
# dense backend: per-request caches (recurrent / hybrid archs, baseline)
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               ring: bool = False, device="cuda") -> List[Dict[str, Any]]:
    """The dense cache: one dict a layer, in execution order (prefix +
    body repeat-major + suffix, as ``params["layers"]``), each leaf with
    the batch on dim 0, in the model's dtype; cross layers hold the
    encoder's n_ctx positions."""
    enc_ctx = cfg.encoder.n_ctx if cfg.encoder is not None else 0
    return [B.init_block_cache(kind, cfg, batch, max_seq, torch_dtype(cfg),
                               device, enc_ctx=enc_ctx, ring=ring)
            for kind in cfg.layer_kinds]


def cache_insert(dst_cache, src_cache, slot: int):
    """Copy a batch=1 cache into slot ``slot`` of a slot-batched cache
    with the same structure and seq dims, in place (decode-engine
    admission).  Returns ``dst_cache``."""
    for dst, src in zip(dst_cache, src_cache):
        for k, leaf in dst.items():
            leaf[slot:slot + 1].copy_(src[k])
    return dst_cache


def cache_select(src_cache, slot: int):
    """A copy of slot ``slot`` as a batch=1 cache."""
    return [{k: leaf[slot:slot + 1].clone() for k, leaf in layer.items()}
            for layer in src_cache]


def _run_layers(params, cfg: ModelConfig, h, *, mode: str, caches,
                pos=None, q_offset: int = 0, enc=None):
    new_caches = []
    for kind, p, c in zip(cfg.layer_kinds, params["layers"], caches):
        h, nc = B.apply_block(kind, p, cfg, h, mode=mode, cache=c, pos=pos,
                              q_offset=q_offset, enc=enc)
        new_caches.append(nc)
    return h, new_caches


def _encode(params, cfg: ModelConfig, enc_embeds):
    """What the cross layers attend: the encoder stack's output for an
    encoder-decoder, the frontend embeddings themselves for a VLM."""
    if enc_embeds is None or not cfg.is_encoder_decoder:
        return enc_embeds
    return encoder_forward(params, cfg, enc_embeds)


def prefill(params, cfg: ModelConfig, tokens, cache, *, q_offset: int = 0,
            enc_embeds=None):
    """One dense prefill chunk.  tokens: (b, chunk) at the shared
    absolute start ``q_offset`` (a host int); ``enc_embeds`` (b,
    enc_ctx, d), the frontend embeddings, make the cross layers project
    and store their encoder K/V (a request's first chunk).  Returns
    (logits of the last position (b, 1, V), cache)."""
    b, s = tokens.shape
    positions = q_offset + torch.arange(s, device=tokens.device)[None, :]
    h = _embed(params, cfg, tokens, positions.expand(b, s))
    h, cache = _run_layers(params, cfg, h, mode="prefill", caches=cache,
                           q_offset=q_offset,
                           enc=_encode(params, cfg, enc_embeds))
    return _head(params, cfg, h[:, -1:]), cache


def prefill_chunked(params, cfg: ModelConfig, tokens, cache, *,
                    chunk_size: int, enc_embeds=None):
    """The paper's chunked prefill: fixed-size chunks in order.
    tokens: (b, S) with S % chunk_size == 0 (padded by the caller).
    With ``enc_embeds`` the encoder runs once and every chunk's cross
    layers project its output, as in the reference.
    Returns (logits of the last position (b, 1, V), cache)."""
    b, s = tokens.shape
    if s % chunk_size:
        raise ValueError("pad prompts to a multiple of ChunkSize")
    enc = _encode(params, cfg, enc_embeds)
    for start in range(0, s, chunk_size):
        chunk = tokens[:, start:start + chunk_size]
        positions = start + torch.arange(chunk_size,
                                         device=tokens.device)[None, :]
        h = _embed(params, cfg, chunk, positions.expand(b, chunk_size))
        h, cache = _run_layers(params, cfg, h, mode="prefill",
                               caches=cache, q_offset=start, enc=enc)
    return _head(params, cfg, h[:, -1:]), cache


def decode_step(params, cfg: ModelConfig, tokens, cache, pos):
    """tokens: (b, 1); pos: (b,) current positions.  Returns (logits
    (b, 1, V), cache)."""
    h = _embed(params, cfg, tokens, pos[:, None])
    h, cache = _run_layers(params, cfg, h, mode="decode", caches=cache,
                           pos=pos)
    return _head(params, cfg, h), cache


def decode_step_greedy(params, cfg: ModelConfig, tokens, cache, pos):
    """``decode_step`` with the argmax on the device: returns
    (next_tokens (b,) int32, cache)."""
    logits, cache = decode_step(params, cfg, tokens, cache, pos)
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), cache


# ---------------------------------------------------------------------------
# paged execution backend (serving hot path)
# ---------------------------------------------------------------------------
def paged_supported(cfg: ModelConfig) -> bool:
    """True if the port's paged path serves this config: every layer an
    ATTN or CROSS_ATTN block, full or sliding-window, GQA or MLA, with a
    dense MLP or a routed MoE; a CROSS_ATTN layer's encoder K/V lives in
    read-only cross pages of the same pool.  MLA with cross-attention
    has no arch and is refused, as in the reference."""
    kinds = set(cfg.layer_kinds)
    return (kinds <= {ATTN, CROSS_ATTN}
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


# ---------------------------------------------------------------------------
# on-device token selection
# ---------------------------------------------------------------------------
_MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9       # keeps seed 0 off the hash's fixed point 0


def _mul32(x, c: int):
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32) and a 32-bit
    constant ``c``, split in 16-bit halves so that no product passes
    2**48: exact in int64 on every device."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def hash32(x):
    """A 32-bit integer hash (the ``lowbias32`` finalizer) of int64
    values in [0, 2**32), computed with int64 tensor ops."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def draw_bits(seeds, vocab: int):
    """(slots, vocab) int64 hashes in [0, 2**32) of (seed, vocabulary
    index): a counter-based draw that keeps no generator state."""
    key = hash32((seeds.long() + _GOLDEN) & _MASK32)[:, None]
    idx = torch.arange(vocab, device=seeds.device, dtype=torch.int64)
    return hash32((hash32(idx[None, :] ^ key) + key) & _MASK32)


def sample_tokens(logits, temps, top_ks, seeds):
    """Batched on-device token selection, with the reference's semantics
    (``repro/models/model.py:sample_tokens``): greedy argmax where
    ``temps == 0``, else a temperature / top-k categorical draw.

    logits: (slots, V); temps: (slots,) float; top_ks: (slots,) int (0 =
    no top-k restriction; top-k keeps every logit >= the k-th largest,
    ties included); seeds: (slots,) int in [0, 2**32), derived by the
    caller from (request seed, step), so a request's stream does not
    depend on its slot or its batch.

    The draw is Gumbel-max over ``draw_bits``: each hash becomes a
    uniform (h + 0.5) / 2**32 and a Gumbel -log(-log(u)) in float64,
    added to the masked logits over the temperature; the argmax is the
    sample.  Integer hashing gives the same draw on the CPU and on the
    card, keeps no generator state and never syncs with the host.  It
    cannot match JAX's PRNG bit for bit.  The greedy lanes take plain
    ``argmax``, so temperature-0 slots stay exact in a sampled batch.
    """
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    v = logits.shape[-1]
    top_ks = top_ks.long()
    # the k-th largest in the logits' own type: float64 holds f32 and
    # bf16 exactly, so the mask is the one float64 would give
    kth = torch.sort(logits, dim=-1, descending=True).values.gather(
        -1, (top_ks.clamp(1, v) - 1)[:, None])
    lg = logits.double()
    masked = lg.masked_fill((top_ks[:, None] > 0) & (logits < kth),
                            float("-inf"))
    temps = temps.double()
    safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))
    u = (draw_bits(seeds, v).double() + 0.5) * 2.0 ** -32
    gumbel = -torch.log(-torch.log(u))
    sampled = torch.argmax(masked / safe_t[:, None] + gumbel,
                           dim=-1).to(torch.int32)
    return torch.where(temps > 0, sampled, greedy)


def decode_step_paged(params, cfg: ModelConfig, tokens, pos, pages, offs,
                      block_tables, lens, k_pool, v_pool,
                      cross_bt=None, cross_len=None,
                      temps=None, top_ks=None, seeds=None):
    """``decode_logits_paged`` with the token selection on the device:
    argmax when ``temps`` is None, else per-slot temperature / top-k
    sampling through ``sample_tokens`` (greedy slots keep the argmax
    exactly).  Returns next_tokens (slots,) int32; k_pool/v_pool are
    updated in place."""
    logits = decode_logits_paged(params, cfg, tokens, pos, pages, offs,
                                 block_tables, lens, k_pool, v_pool,
                                 cross_bt, cross_len)
    if temps is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return sample_tokens(logits, temps, top_ks, seeds)
