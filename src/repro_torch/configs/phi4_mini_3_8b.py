"""Phi-4-mini 3.8B [dense] — RoPE SwiGLU GQA [arXiv:2412.08905]."""
from repro_torch.models.config import ATTN, ModelConfig, reduced


def config() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b", n_layers=32, d_model=3072, n_heads=24,
        n_kv_heads=8, d_ff=8192, vocab_size=200064, head_dim=128,
        pattern=(ATTN,), rope_theta=10_000.0, mlp_act="swiglu",
        tie_embeddings=True,
        source="arXiv:2412.08905 (Phi-4 technical report)")


def smoke() -> ModelConfig:
    return reduced(config(), layers=2, d_model=256, n_heads=4, n_kv_heads=2)
