"""Mistral-Nemo 12B [dense] — 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407].

head_dim=128 is decoupled from d_model/n_heads (5120/32=160) per the
model card.

``windowed`` is the sliding-window variant the reference lowers for
its long-context decode shape (window 4096, ``SLIDING_WINDOW_500K`` in
the JAX package's ``launch/specs.py``).  The published config has no
window: the variant is the reference's, not the model card's.
"""
import dataclasses

from repro_torch.models.config import ATTN, ModelConfig, reduced

WINDOW = 4096


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b", n_layers=40, d_model=5120, n_heads=32,
        n_kv_heads=8, d_ff=14336, vocab_size=131072, head_dim=128,
        pattern=(ATTN,), rope_theta=1_000_000.0, mlp_act="swiglu",
        tie_embeddings=False,
        source="hf:mistralai/Mistral-Nemo-Base-2407")


def smoke() -> ModelConfig:
    return reduced(config(), layers=2, d_model=256, n_heads=4, n_kv_heads=2)


def windowed(window: int = WINDOW) -> ModelConfig:
    """The full config with a sliding window of ``window`` tokens."""
    return dataclasses.replace(config(), sliding_window=window)
