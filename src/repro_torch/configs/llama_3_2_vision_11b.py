"""Llama-3.2-Vision-11B [vlm] — cross-attn image layers every 5th layer
[hf:meta-llama/Llama-3.2-11B-Vision].

Vision tower + projector are a STUB: the requests carry precomputed
projected patch embeddings (1600 patches x d_model,
``models/frontends.py``).  Pattern period 5 with the cross-attn layer at
index 3 (HF cross_attention_layers [3,8,...,38]).  As in the reference,
a CROSS_ATTN layer runs self-attention, then an ungated cross-attention,
then the MLP.
"""
from repro_torch.models.config import (ATTN, CROSS_ATTN, EncoderConfig,
                                       ModelConfig, reduced)


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b", n_layers=40, d_model=4096, n_heads=32,
        n_kv_heads=8, d_ff=14336, vocab_size=128256, head_dim=128,
        pattern=(ATTN, ATTN, ATTN, CROSS_ATTN, ATTN),
        rope_theta=500_000.0, mlp_act="swiglu", tie_embeddings=False,
        encoder=EncoderConfig(n_layers=0, n_ctx=1600, d_model=4096),
        source="hf:meta-llama/Llama-3.2-11B-Vision")


def smoke() -> ModelConfig:
    return reduced(config(), layers=2, d_model=256, n_heads=4, n_kv_heads=2)
