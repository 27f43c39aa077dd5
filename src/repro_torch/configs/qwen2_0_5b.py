"""Qwen2-0.5B [dense] — GQA with QKV bias [arXiv:2407.10671]."""
from repro_torch.models.config import ATTN, ModelConfig, reduced


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b", n_layers=24, d_model=896, n_heads=14,
        n_kv_heads=2, d_ff=4864, vocab_size=151936, head_dim=64,
        pattern=(ATTN,), qkv_bias=True, rope_theta=1_000_000.0,
        mlp_act="swiglu", tie_embeddings=True,
        source="arXiv:2407.10671 (Qwen2 technical report)")


def smoke() -> ModelConfig:
    return reduced(config(), layers=2, d_model=256, n_heads=4, n_kv_heads=2)
