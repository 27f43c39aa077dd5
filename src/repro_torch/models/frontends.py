"""Stub modality frontends, as in the reference
(``src/repro/models/frontends.py``).

The ``[audio]``/``[vlm]`` configs specify the transformer backbone
only; the mel-spectrogram + conv feature extractor (whisper) and the
vision tower + projector (VLM) are not implemented.  These helpers make
the precomputed frame/patch embeddings the backbone consumes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import torch_dtype


def frontend_shape(cfg: ModelConfig, batch: int
                   ) -> Optional[Tuple[int, int, int]]:
    """(batch, n_ctx, d_model) of the stub frontend output, or None."""
    if cfg.encoder is None:
        return None
    return (batch, cfg.encoder.n_ctx, cfg.encoder.d_model or cfg.d_model)


def frontend_spec(cfg: ModelConfig, batch: int) -> Optional[torch.Tensor]:
    """The stub frontend output's shape and dtype as a meta tensor (the
    reference's ``ShapeDtypeStruct``), or None."""
    shape = frontend_shape(cfg, batch)
    if shape is None:
        return None
    return torch.empty(shape, dtype=torch_dtype(cfg), device="meta")


def fake_frontend(cfg: ModelConfig, batch: int,
                  generator: torch.Generator, device="cuda"
                  ) -> Optional[torch.Tensor]:
    """Frame/patch embeddings drawn normal x 0.02 from ``generator`` (on
    ``device``), in the config's dtype, as the reference draws them; None
    for a config without a frontend."""
    shape = frontend_shape(cfg, batch)
    if shape is None:
        return None
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return x.to(torch_dtype(cfg)) * 0.02
