"""DeepSeek-67B [dense] — llama-arch GQA [arXiv:2401.02954].

``served`` cuts the depth, and only the depth, to what one 80 GB card
holds in bf16 beside its page pools: 24 layers against the published
95, about 18.3 G parameters (36.6 GB; the whole model is about 67.4 G,
135 GB).  Every width stays the published one.
"""
import dataclasses

from repro_torch.models.config import ATTN, ModelConfig, reduced

SERVED_LAYERS = 24


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b", n_layers=95, d_model=8192, n_heads=64,
        n_kv_heads=8, d_ff=22016, vocab_size=102400, head_dim=128,
        pattern=(ATTN,), rope_theta=10_000.0, mlp_act="swiglu",
        tie_embeddings=False,
        source="arXiv:2401.02954 (DeepSeek LLM)")


def served(n_layers: int = SERVED_LAYERS) -> ModelConfig:
    """Full width at reduced depth."""
    return dataclasses.replace(config(), n_layers=n_layers)


def smoke() -> ModelConfig:
    return reduced(config(), layers=2, d_model=256, n_heads=4, n_kv_heads=2)
