"""Block composition: norm + temporal mixer + channel mixer per block
kind, with the per-kind init and the dense backend's cache init and
apply (reference ``src/repro/models/blocks.py``).

The paged path composes its ATTN / CROSS_ATTN blocks in
``model._paged_attn_block``; the dense backend and training run
``apply_block`` in three modes:

  * "train":   the whole sequence, no cache (differentiable)
  * "prefill": a chunk of the sequence, reading and writing a cache
  * "decode":  one token a request, per-request positions ``pos: (b,)``

Dense caches are dicts of tensors, updated in place where the reference
updates a cache functionally (the chunk's or the token's K/V or MLA
latent rows, a cross layer's encoder K/V); a recurrent block's new
state replaces its old tensors in the returned dict.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import attention as A
from repro_torch.models import mlp as MLP
from repro_torch.models import recurrent as R
from repro_torch.models import sharding as SH
from repro_torch.models.config import (ATTN, CROSS_ATTN, LOCAL_ATTN, MLSTM,
                                       RGLRU, SLSTM, ModelConfig)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm with the statistics in f32, cast back to x's dtype
    before the weight, as the reference does."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
class Init:
    """The reference's weight distributions (normal times a scale, ones
    for norms, zeros for biases, a uniform for the RG-LRU's decay),
    drawn from ``generator`` on ``device``: the same law, not the same
    numbers."""

    def __init__(self, generator: torch.Generator, device, dtype):
        self.generator, self.device, self.dtype = generator, device, dtype

    def normal(self, shape, scale, dt=None) -> torch.Tensor:
        x = torch.randn(shape, generator=self.generator, device=self.device,
                        dtype=torch.float32)
        return x.mul_(scale).to(dt or self.dtype)   # in place: GBs

    def uniform(self, shape, lo, hi) -> torch.Tensor:
        """f32 whatever the model's dtype, as the reference's draw."""
        x = torch.rand(shape, generator=self.generator, device=self.device,
                       dtype=torch.float32)
        return x.mul_(hi - lo).add_(lo)

    def ones(self, n) -> torch.Tensor:
        return torch.ones(n, dtype=self.dtype, device=self.device)

    def zeros(self, n) -> torch.Tensor:
        return torch.zeros(n, dtype=self.dtype, device=self.device)


def init_gqa(ini: Init, cfg: ModelConfig) -> dict:
    d, h, kvh, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    attn = {"wq": ini.normal((d, h * hd), d ** -0.5),
            "wk": ini.normal((d, kvh * hd), d ** -0.5),
            "wv": ini.normal((d, kvh * hd), d ** -0.5),
            "wo": ini.normal((h * hd, d), (h * hd) ** -0.5)}
    if cfg.qkv_bias:
        attn.update(bq=ini.zeros(h * hd), bk=ini.zeros(kvh * hd),
                    bv=ini.zeros(kvh * hd))
    return attn


def init_cross(ini: Init, cfg: ModelConfig) -> dict:
    """Cross-attention projections: GQA's, never biased."""
    d, h, kvh, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    return {"wq": ini.normal((d, h * hd), d ** -0.5),
            "wk": ini.normal((d, kvh * hd), d ** -0.5),
            "wv": ini.normal((d, kvh * hd), d ** -0.5),
            "wo": ini.normal((h * hd, d), (h * hd) ** -0.5)}


def init_mla(ini: Init, cfg: ModelConfig) -> dict:
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    attn = {}
    if m.q_lora_rank:
        attn["wq_a"] = ini.normal((d, m.q_lora_rank), d ** -0.5)
        attn["q_norm"] = ini.ones(m.q_lora_rank)
        attn["wq_b"] = ini.normal((m.q_lora_rank, h * qk),
                                  m.q_lora_rank ** -0.5)
    else:
        attn["wq"] = ini.normal((d, h * qk), d ** -0.5)
    attn["wkv_a"] = ini.normal((d, m.kv_lora_rank + m.qk_rope_head_dim),
                               d ** -0.5)
    attn["kv_norm"] = ini.ones(m.kv_lora_rank)
    attn["wkv_b"] = ini.normal(
        (m.kv_lora_rank, h * (m.qk_nope_head_dim + m.v_head_dim)),
        m.kv_lora_rank ** -0.5)
    attn["wo"] = ini.normal((h * m.v_head_dim, d),
                            (h * m.v_head_dim) ** -0.5)
    return attn


def init_mlp(ini: Init, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    glu = 2 if cfg.mlp_act == "swiglu" else 1
    return {"wi": ini.normal((d, glu * cfg.d_ff), d ** -0.5),
            "wo": ini.normal((cfg.d_ff, d), cfg.d_ff ** -0.5)}


def init_moe(ini: Init, cfg: ModelConfig) -> dict:
    moe, d = cfg.moe, cfg.d_model
    glu = 2 if cfg.mlp_act == "swiglu" else 1
    ff, e = moe.expert_ff or cfg.d_ff, moe.n_experts
    p = {"router": ini.normal((d, e), d ** -0.5, torch.float32),
         "wi": ini.normal((e, d, glu * ff), d ** -0.5),
         "wo": ini.normal((e, ff, d), ff ** -0.5)}
    if moe.n_shared:
        sff = ff * moe.n_shared
        p["shared_wi"] = ini.normal((d, glu * sff), d ** -0.5)
        p["shared_wo"] = ini.normal((sff, d), sff ** -0.5)
    return p


def init_block(ini: Init, kind: str, cfg: ModelConfig,
               use_moe: bool) -> Dict[str, Any]:
    """One layer's weights: {norm1, attn, norm2, mlp | moe[, norm_c,
    cross]} for the attention kinds, {norm1, rglru, norm2, mlp} for
    RG-LRU, {norm, cell} for sLSTM / mLSTM."""
    d = cfg.d_model
    if kind in (ATTN, LOCAL_ATTN, CROSS_ATTN):
        p = {"norm1": ini.ones(d),
             "attn": init_mla(ini, cfg) if cfg.mla else init_gqa(ini, cfg),
             "norm2": ini.ones(d)}
        if use_moe and cfg.moe is not None:
            p["moe"] = init_moe(ini, cfg)
        else:
            p["mlp"] = init_mlp(ini, cfg)
        if kind == CROSS_ATTN:
            p["norm_c"] = ini.ones(d)
            p["cross"] = init_cross(ini, cfg)
        return p
    if kind == RGLRU:
        return {"norm1": ini.ones(d), "rglru": R.init_rglru(ini, cfg),
                "norm2": ini.ones(d), "mlp": init_mlp(ini, cfg)}
    if kind == SLSTM:
        return {"norm": ini.ones(d), "cell": R.init_slstm(ini, cfg)}
    if kind == MLSTM:
        return {"norm": ini.ones(d), "cell": R.init_mlstm(ini, cfg)}
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# dense cache init (per block kind)
# ---------------------------------------------------------------------------
def init_block_cache(kind: str, cfg: ModelConfig, batch: int, max_seq: int,
                     dtype, device, enc_ctx: int = 0,
                     ring: bool = False) -> Dict[str, Any]:
    """One layer's dense cache: for the attention kinds K/V (batch, s,
    kvh, hd), or with MLA the compressed latent ``ckv`` (batch, s,
    kv_lora_rank) and the RoPE key ``krope`` (batch, s, rope); a
    CROSS_ATTN layer adds its encoder K/V ``ck`` / ``cv`` (batch,
    enc_ctx, kvh, hd).  The recurrent state for the other kinds.
    ``ring=True`` gives windowed layers a ring buffer of ``window``
    positions in place of ``max_seq``: decode-only shapes; prefill needs
    the full length."""
    if kind in (ATTN, LOCAL_ATTN, CROSS_ATTN):
        window = cfg.local_window if kind == LOCAL_ATTN \
            else cfg.sliding_window
        s = min(max_seq, window) if (window and ring) else max_seq

        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)
        kvh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        if cfg.mla is not None:
            c = {"ckv": zeros(batch, s, cfg.mla.kv_lora_rank),
                 "krope": zeros(batch, s, cfg.mla.qk_rope_head_dim)}
        else:
            c = {"k": zeros(batch, s, kvh, hd), "v": zeros(batch, s, kvh, hd)}
        if kind == CROSS_ATTN:
            c["ck"] = zeros(batch, enc_ctx, kvh, hd)
            c["cv"] = zeros(batch, enc_ctx, kvh, hd)
        return c
    if kind == RGLRU:
        return R.rglru_init_state(cfg, batch, dtype, device)
    if kind == SLSTM:
        return R.slstm_init_state(cfg, batch, dtype, device)
    if kind == MLSTM:
        return R.mlstm_init_state(cfg, batch, dtype, device)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------
def apply_block(kind: str, p: Dict[str, Any], cfg: ModelConfig,
                x: torch.Tensor, *, mode: str,
                cache: Optional[Dict[str, Any]] = None, pos=None,
                q_offset: int = 0, enc=None):
    """One block.  ``mode`` "train": x (b, s, d) is the whole sequence
    from position 0, no cache, and a CROSS_ATTN layer projects ``enc``
    (b, enc_ctx, d), the encoder output, to its cross K/V; "prefill": x
    (b, s, d) is the chunk at the shared absolute start ``q_offset`` (a
    host int); "decode": x (b, 1, d) at per-request positions ``pos``
    (b,).  A CROSS_ATTN layer given ``enc`` in a prefill projects it to
    its cross K/V, stores them in the cache's dtype and attends the
    unrounded ones, as the reference does; otherwise it attends the
    stored ``ck`` / ``cv``.
    Returns (x_out, new_cache (None in "train"), aux_loss): the MoE
    load-balance loss of a routed layer (an f32 scalar), None for the
    others, which the reference gives a zero."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}")
    train = mode == "train"
    aux = None
    if kind in (ATTN, LOCAL_ATTN, CROSS_ATTN):
        window = cfg.local_window if kind == LOCAL_ATTN \
            else cfg.sliding_window
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        # the self-attention functions touch only their own leaves of
        # the layer's cache (k / v, or ckv / krope), in place
        if train:
            fn = A.mla_forward if cfg.mla is not None else A.gqa_forward
            a = fn(p["attn"], cfg, h, window=window)
        elif mode == "prefill":
            fn = A.mla_prefill if cfg.mla is not None else A.gqa_prefill
            a, cache = fn(p["attn"], cfg, h, cache, q_offset=q_offset,
                          window=window)
        else:
            fn = (_mla_decode_batched if cfg.mla is not None
                  else _gqa_decode_batched)
            a, cache = fn(p["attn"], cfg, h, cache, pos, window)
        x = x + a
        if kind == CROSS_ATTN:
            # under a mesh the cross sublayer has no tensor-parallel
            # form: its weights and encoder K/V are gathered whole
            pc = SH.full_tree(p["cross"]) if SH.active() else p["cross"]
            hc = rms_norm(x, p["norm_c"], cfg.norm_eps)
            if train or (mode == "prefill" and enc is not None):
                ck, cv = A.cross_kv(pc, cfg, enc)
                if not train:
                    SH.assign(cache["ck"], ck)
                    SH.assign(cache["cv"], cv)
            elif SH.active():
                full = SH.full_cache({"ck": cache["ck"], "cv": cache["cv"]})
                ck, cv = full["ck"], full["cv"]
            else:
                ck, cv = cache["ck"], cache["cv"]
            x = x + A.cross_forward(pc, cfg, hc, ck, cv)
        h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
        if "moe" in p:
            m, aux = MLP.moe_forward(p["moe"], cfg, h2)
        else:
            m = MLP.mlp_forward(p["mlp"], cfg, h2)
        return x + m, cache, aux
    if kind == RGLRU:
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        fn = R.rglru_decode if mode == "decode" else R.rglru_forward
        r, new_cache = _replicated(fn, p["rglru"], cfg, h, cache)
        x = x + r
        h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
        return (x + MLP.mlp_forward(p["mlp"], cfg, h2),
                None if train else new_cache, aux)
    if kind in (SLSTM, MLSTM):
        h = rms_norm(x, p["norm"], cfg.norm_eps)
        if kind == SLSTM:
            fn = R.slstm_decode if mode == "decode" else R.slstm_forward
        else:
            fn = R.mlstm_decode if mode == "decode" else R.mlstm_forward
        r, new_cache = _replicated(fn, p["cell"], cfg, h, cache)
        return x + r, None if train else new_cache, aux
    raise ValueError(kind)


def _replicated(fn, p, cfg, h, cache):
    """``fn(p, cfg, h, cache)`` of a recurrent mixer.  Under a mesh the
    recurrent layers have no tensor-parallel form: the weights and the
    state are gathered whole over the model axis, every rank runs the
    layer on its batch, and the new state keeps this rank's shards."""
    if not SH.active():
        return fn(p, cfg, h, cache)
    r, new = fn(SH.full_tree(p), cfg, h,
                None if cache is None else SH.full_cache(cache))
    return r, None if cache is None else SH.store_cache(cache, new)


# --- batched decode with per-request positions ------------------------------
def _gqa_decode_batched(p, cfg, x, cache, pos, window):
    """One-token GQA decode at per-request positions ``pos`` (b,): the
    token's K/V written in place at its slot (the ring slot of a
    windowed ring cache), then ``A.decode_attn_batched``.  Under a mesh
    the cache leaves are DTensors: heads or sequence sharded."""
    b = x.shape[0]
    q, k, v = A.gqa_qkv(p, cfg, x, pos[:, None])
    s_cache = SH.seq_shard(cache["k"])[2]
    ring = window > 0 and s_cache <= window
    slots = pos % s_cache if ring else torch.clamp(pos, max=s_cache - 1)
    SH.scatter_slots(cache["k"], k, slots)
    SH.scatter_slots(cache["v"], v, slots)
    out = A.decode_attn_batched(q, cache["k"], cache["v"], pos, window,
                                ring)
    return SH.row(out.reshape(b, 1, -1), p["wo"]), cache


def _mla_decode_batched(p, cfg, x, cache, pos, window):
    """One-token MLA decode at per-request positions ``pos`` (b,) against
    the dense latent cache, in absorbed form: the token's latent is
    written in place at min(pos, S - 1), q_nope is absorbed through W_uk,
    scores (q_lat . ckv + q_rope . krope) * scale over every position at
    or below pos (and inside the window), PV on the latent, W_uv on the
    way out; all in f32.

    Plain torch ops, not a kernel's plain version: the reference's dense
    MLA decode is plain jnp too, outside any Pallas kernel
    (``blocks.py:_mla_decode_batched``)."""
    b = x.shape[0]
    positions = pos[:, None]
    q_nope, q_rope = A._mla_q(p, cfg, x, positions)
    c_kv, k_rope = A._mla_kv_latent(p, cfg, x, positions)
    s_cache = SH.seq_shard(cache["ckv"])[2]
    slots = torch.clamp(pos, max=s_cache - 1)
    SH.scatter_slots(cache["ckv"], c_kv, slots)
    SH.scatter_slots(cache["krope"], k_rope, slots)
    out = A.mla_decode_attn(p, cfg, q_nope, q_rope, cache["ckv"],
                            cache["krope"], pos.long()[:, None], window)
    return SH.row(out.reshape(b, 1, -1).to(x.dtype), p["wo"]), cache
