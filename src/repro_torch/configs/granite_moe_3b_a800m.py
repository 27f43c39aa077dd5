"""Granite-3.0 MoE 3B-A800M [moe] — 40 experts top-8
[hf:ibm-granite/granite-3.0-3b-a800m-base]."""
from repro_torch.models.config import ATTN, MoEConfig, ModelConfig, reduced


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", n_layers=32, d_model=1536, n_heads=24,
        n_kv_heads=8, d_ff=512, vocab_size=49155, head_dim=64,
        pattern=(ATTN,),
        moe=MoEConfig(n_experts=40, top_k=8, n_shared=0, expert_ff=512),
        rope_theta=10_000.0, mlp_act="swiglu", tie_embeddings=True,
        source="hf:ibm-granite/granite-3.0-3b-a800m-base")


def smoke() -> ModelConfig:
    return reduced(config(), layers=2, d_model=256, n_heads=4, n_kv_heads=2)
