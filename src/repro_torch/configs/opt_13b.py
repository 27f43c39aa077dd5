"""OPT-13B — the paper's target LLM [arXiv:2205.01068]."""
from repro_torch.models.config import ATTN, ModelConfig, reduced


def config() -> ModelConfig:
    return ModelConfig(
        name="opt-13b", n_layers=40, d_model=5120, n_heads=40,
        n_kv_heads=40, d_ff=20480, vocab_size=50272, head_dim=128,
        pattern=(ATTN,), use_rope=False, n_positions=2048,
        mlp_act="gelu", tie_embeddings=True,
        source="arXiv:2205.01068 (OPT)")


def smoke() -> ModelConfig:
    return reduced(config(), layers=2, d_model=256, n_heads=4, n_kv_heads=4)
