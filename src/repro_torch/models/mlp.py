"""Dense MLPs: SwiGLU and GeLU.  The routed MoE comes with the MLA and
MoE slice."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig


def mlp_forward(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["wi"]
    if cfg.mlp_act == "swiglu":
        gate, up = h.chunk(2, dim=-1)
        h = F.silu(gate) * up
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h, approximate="tanh")
    return h @ p["wo"]
