"""RecurrentGemma-9B [hybrid] — RG-LRU + local attention, 1 attn : 2
recurrent [arXiv:2402.19427 (Griffin)].

Pattern period 3: (RGLRU, RGLRU, LOCAL_ATTN) x 12 + 2 trailing RGLRU = 38.
Natively sub-quadratic: local window 2048 + constant recurrent state, so
``long_500k`` runs without a sliding-window override.
"""
from repro_torch.models.config import LOCAL_ATTN, RGLRU, ModelConfig, reduced


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", n_layers=38, d_model=4096, n_heads=16,
        n_kv_heads=1, d_ff=12288, vocab_size=256000, head_dim=256,
        pattern=(RGLRU, RGLRU, LOCAL_ATTN), suffix=(RGLRU, RGLRU),
        local_window=2048, lru_width=4096, rope_theta=10_000.0,
        mlp_act="swiglu", tie_embeddings=True,
        source="arXiv:2402.19427 (Griffin/RecurrentGemma)")


def smoke() -> ModelConfig:
    return reduced(config(), layers=3, d_model=256, n_heads=4, n_kv_heads=1)
