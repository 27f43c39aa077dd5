"""Model configuration for the composable transformer substrate.

A single ``ModelConfig`` dataclass describes every architecture in the
assigned pool (dense GQA, MLA+MoE, RG-LRU hybrid, xLSTM, enc-dec audio,
VLM cross-attention) plus the paper's own OPT pair.  Layer stacking is
expressed as a repeating ``pattern`` of block kinds so the model can be
lowered with ``jax.lax.scan`` over the repeated group (compile-time is
O(pattern), not O(n_layers)).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Block kinds understood by models/blocks.py
ATTN = "attn"              # (self-)attention + MLP/MoE block
LOCAL_ATTN = "local_attn"  # sliding-window attention + MLP
CROSS_ATTN = "cross_attn"  # self-attn + cross-attn (frontend KV) + MLP
RGLRU = "rglru"            # RecurrentGemma RG-LRU recurrent block + MLP
SLSTM = "slstm"            # xLSTM sLSTM block (post-up projection)
MLSTM = "mlstm"            # xLSTM mLSTM block (pre-up projection)

BLOCK_KINDS = (ATTN, LOCAL_ATTN, CROSS_ATTN, RGLRU, SLSTM, MLSTM)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0           # always-on shared experts (DeepSeek-V2)
    expert_ff: int = 0          # per-expert hidden dim (defaults to d_ff)
    router_aux_weight: float = 0.001  # load-balance loss weight (train)
    capacity_factor: float = 1.3  # Switch-style per-group expert capacity


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2)."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0        # 0 = full-rank Q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Stub-frontend encoder (whisper audio / VLM vision tower).

    The modality frontend itself is a stub: ``input_specs`` provides
    precomputed frame/patch embeddings of shape (batch, n_ctx, d_model).
    For whisper we still run the transformer encoder stack over them.
    """
    n_layers: int = 0
    n_ctx: int = 1500           # frames (whisper) / patches (VLM)
    d_model: int = 0            # frontend embedding dim (== model d_model here)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                      # 0 -> d_model // n_heads
    # --- layer stacking ---
    pattern: Tuple[str, ...] = (ATTN,)     # repeating unit of block kinds
    prefix: Tuple[str, ...] = ()           # unrolled blocks before the scan
    suffix: Tuple[str, ...] = ()           # unrolled blocks after the scan
    # --- attention flavour ---
    qkv_bias: bool = False                 # qwen2
    rope_theta: float = 10000.0
    use_rope: bool = True
    sliding_window: int = 0                # 0 = disabled (full attention)
    local_window: int = 2048               # window for LOCAL_ATTN blocks
    cross_attn_every: int = 0              # VLM: every k-th layer is cross-attn
    mla: Optional[MLAConfig] = None
    # --- mlp flavour ---
    mlp_act: str = "swiglu"                # swiglu | gelu
    moe: Optional[MoEConfig] = None
    # --- recurrent flavours ---
    rglru_conv_width: int = 4              # temporal conv in RG-LRU block
    lru_width: int = 0                     # 0 -> d_model
    # --- embeddings/output ---
    tie_embeddings: bool = True
    n_positions: int = 0                   # 0 = rope/stateful (no learned pos)
    # --- encoder-decoder / multimodal stub frontend ---
    encoder: Optional[EncoderConfig] = None
    # --- misc ---
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # classification head (length-predictor models); 0 = LM head
    n_classes: int = 0
    source: str = ""                       # citation for the config

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_rep(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Full per-layer kind list (prefix + repeats + suffix)."""
        body = self.n_layers - len(self.prefix) - len(self.suffix)
        if body < 0 or (self.pattern and body % len(self.pattern) != 0):
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} incompatible with "
                f"pattern={self.pattern} prefix={self.prefix} suffix={self.suffix}")
        reps = body // len(self.pattern) if self.pattern else 0
        return self.prefix + self.pattern * reps + self.suffix

    @property
    def n_repeats(self) -> int:
        body = self.n_layers - len(self.prefix) - len(self.suffix)
        return body // len(self.pattern) if self.pattern else 0

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder is not None and self.encoder.n_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return all(k in (RGLRU, SLSTM, MLSTM) for k in self.layer_kinds)

    @property
    def n_cross_layers(self) -> int:
        """Layers carrying a cross-attention sublayer (VLM / enc-dec)."""
        return sum(1 for k in self.layer_kinds if k == CROSS_ATTN)

    @property
    def cross_ctx(self) -> int:
        """Encoder tokens every cross-attention layer attends (frames for
        whisper, patches for the VLM); 0 when the arch has no frontend."""
        return self.encoder.n_ctx if self.encoder is not None else 0

    def cross_kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """Cross-KV bytes per ENCODER token across all cross layers —
        the one-shot payload disaggregation ships alongside the growing
        self-attention KV (amortized over the whole decode)."""
        per = 2 * self.n_kv_heads * self.resolved_head_dim
        return self.n_cross_layers * per * dtype_bytes

    @property
    def subquadratic(self) -> bool:
        """True if no block needs a full-length self-attention KV
        (long-context capable).  CROSS_ATTN blocks carry full causal
        self-attention alongside the cross attention."""
        return all(k not in (ATTN, CROSS_ATTN) or self.sliding_window > 0
                   for k in self.layer_kinds)

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """KV-cache bytes per token per sequence (all layers) — used by the
        dispatcher's resource estimation and the KV-transfer cost model."""
        total = 0
        for kind in self.layer_kinds:
            if kind in (ATTN, LOCAL_ATTN, CROSS_ATTN):
                if self.mla is not None:
                    per = self.mla.kv_lora_rank + self.mla.qk_rope_head_dim
                else:
                    per = 2 * self.n_kv_heads * self.resolved_head_dim
                total += per * dtype_bytes
            # recurrent blocks: constant state, no per-token growth
        return total

    def validate(self) -> None:
        for k in self.layer_kinds:
            if k not in BLOCK_KINDS:
                raise ValueError(f"unknown block kind {k!r}")
        if self.n_kv_heads and self.n_heads % self.n_kv_heads != 0:
            raise ValueError("n_heads must be a multiple of n_kv_heads")


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 256,
            n_heads: int = 4, n_kv_heads: int = 0, d_ff: int = 512,
            vocab: int = 512, experts: int = 4) -> ModelConfig:
    """Smoke-test variant of the same family: tiny dims, same block kinds."""
    kv = n_kv_heads or max(1, min(cfg.n_kv_heads, n_heads))
    if n_heads % kv:
        kv = 1
    # Keep one of each distinct block kind so the smoke test exercises the
    # family's structure, then cycle to fill `layers`.
    kinds: list = []
    for k in cfg.layer_kinds:
        if k not in kinds:
            kinds.append(k)
    layers = max(layers, len(kinds))
    reps, rem = divmod(layers, len(kinds))
    pat = tuple(kinds)
    suffix: Tuple[str, ...] = tuple(kinds[:rem])
    moe = None
    if cfg.moe is not None:
        moe = MoEConfig(n_experts=min(experts, cfg.moe.n_experts),
                        top_k=min(2, cfg.moe.top_k),
                        n_shared=min(1, cfg.moe.n_shared),
                        expert_ff=d_ff // 2 if cfg.moe.expert_ff else 0,
                        # drop-free at smoke scale so chunked prefill is
                        # bit-equivalent to single-shot prefill
                        capacity_factor=float(cfg.moe.n_experts))
    mla = None
    if cfg.mla is not None:
        mla = MLAConfig(kv_lora_rank=64, q_lora_rank=0,
                        qk_nope_head_dim=d_model // n_heads,
                        qk_rope_head_dim=16, v_head_dim=d_model // n_heads)
    enc = None
    if cfg.encoder is not None:
        enc = EncoderConfig(n_layers=min(2, cfg.encoder.n_layers), n_ctx=16,
                            d_model=d_model)
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke", n_layers=layers, d_model=d_model,
        n_heads=n_heads, n_kv_heads=kv, d_ff=d_ff, vocab_size=vocab,
        head_dim=d_model // n_heads, pattern=pat, prefix=(), suffix=suffix,
        moe=moe, mla=mla, encoder=enc, local_window=8,
        sliding_window=min(cfg.sliding_window, 8) if cfg.sliding_window else 0,
        lru_width=0, n_positions=4096 if cfg.n_positions else 0)
