"""DeepSeek-V2 236B [moe] — MLA (kv_lora=512) + 2 shared + 160 routed
top-6 experts [arXiv:2405.04434].

First layer dense (d_ff=12288), remaining 59 MoE (expert_ff=1536).  The
compressed MLA latent (kv_lora_rank + qk_rope_head_dim = 576 scalars per
token per layer) is what disaggregation ships from the prefill instance
to the decode instance.

``served`` cuts the depth, and only the depth, to what one 80 GB card
holds in bf16: 4 layers (the dense first layer plus 3 routed ones)
against the published 60, about 13.3 G parameters (26.6 GB).  Every
width stays the published one.
"""
import dataclasses

from repro_torch.models.config import (ATTN, MLAConfig, MoEConfig,
                                       ModelConfig, reduced)

SERVED_LAYERS = 4


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", n_layers=60, d_model=5120, n_heads=128,
        n_kv_heads=128, d_ff=12288, vocab_size=102400,
        head_dim=128, prefix=(ATTN,), pattern=(ATTN,),
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(n_experts=160, top_k=6, n_shared=2, expert_ff=1536),
        rope_theta=10_000.0, mlp_act="swiglu", tie_embeddings=False,
        source="arXiv:2405.04434 (DeepSeek-V2)")


def served(n_layers: int = SERVED_LAYERS) -> ModelConfig:
    """Full width at reduced depth: the dense prefix layer plus
    ``n_layers - 1`` routed layers."""
    return dataclasses.replace(config(), n_layers=n_layers)


def smoke() -> ModelConfig:
    return reduced(config(), layers=2, d_model=256, n_heads=4, n_kv_heads=4)
