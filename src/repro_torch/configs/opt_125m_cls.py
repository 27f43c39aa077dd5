"""OPT-125M classification head — the paper's length-predictor model
(OPTForSequenceClassification, §3.3.2). n_classes = length buckets."""
from repro_torch.models.config import ATTN, ModelConfig, reduced


def config(n_classes: int = 16) -> ModelConfig:
    return ModelConfig(
        name="opt-125m-cls", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=12, d_ff=3072, vocab_size=50272, head_dim=64,
        pattern=(ATTN,), use_rope=False, n_positions=2048,
        mlp_act="gelu", tie_embeddings=True, n_classes=n_classes,
        source="arXiv:2205.01068 (OPT) + paper §3.3.2")


def smoke() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        reduced(config(), layers=2, d_model=128, n_heads=4, n_kv_heads=4),
        n_classes=16)
