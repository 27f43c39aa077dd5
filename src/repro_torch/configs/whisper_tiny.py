"""Whisper-tiny [audio] — enc-dec transformer backbone; the mel/conv
frontend is a STUB (the requests carry precomputed frame embeddings,
``models/frontends.py``) [arXiv:2212.04356].

Decoder: 4 layers, every layer cross-attends to the 1500-frame encoder
output. Learned positions (n_positions=448 per the model card; positions
clamp beyond it).
"""
from repro_torch.models.config import (CROSS_ATTN, EncoderConfig,
                                       ModelConfig, reduced)


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny", n_layers=4, d_model=384, n_heads=6,
        n_kv_heads=6, d_ff=1536, vocab_size=51865, head_dim=64,
        pattern=(CROSS_ATTN,), use_rope=False, n_positions=448,
        mlp_act="gelu", tie_embeddings=True,
        encoder=EncoderConfig(n_layers=4, n_ctx=1500, d_model=384),
        source="arXiv:2212.04356 (Whisper)")


def smoke() -> ModelConfig:
    return reduced(config(), layers=2, d_model=128, n_heads=4, n_kv_heads=4)
