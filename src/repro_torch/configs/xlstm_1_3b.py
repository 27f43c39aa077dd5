"""xLSTM-1.3B [ssm] — sLSTM + mLSTM blocks, ratio 7:1 [arXiv:2405.04517].

48 blocks as (MLSTM x7, SLSTM) x 6. d_ff=0: blocks carry their own
up/down projections (mLSTM pre-up x2, sLSTM post-up x4/3). Attention-free
=> constant state, ``long_500k`` native.
"""
from repro_torch.models.config import MLSTM, SLSTM, ModelConfig, reduced


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b", n_layers=48, d_model=2048, n_heads=4,
        n_kv_heads=4, d_ff=0, vocab_size=50304,
        pattern=(MLSTM,) * 7 + (SLSTM,), use_rope=False,
        mlp_act="gelu", tie_embeddings=True,
        source="arXiv:2405.04517 (xLSTM)")


def smoke() -> ModelConfig:
    return reduced(config(), layers=2, d_model=256, n_heads=4, n_kv_heads=4)
