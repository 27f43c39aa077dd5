"""Assigned input shapes and meta-tensor input specs per (arch, shape),
as the reference's ``launch/specs.py`` (meta tensors where it has
``ShapeDtypeStruct``).

Decode shapes run ``decode_step`` (one token against a seq_len KV
cache), never the train step.  ``long_500k`` needs sub-quadratic
attention: native for the hybrid/SSM archs; the dense/MoE/VLM archs get
the sliding-window variant (window 4096, ring cache); whisper is skipped
(its 448-token learned-position decoder context).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.models import frontends as F
from repro_torch.models import model as M
from repro_torch.models.config import ATTN, CROSS_ATTN, ModelConfig

SLIDING_WINDOW_500K = 4096

SHAPES: Dict[str, dict] = {
    "train_4k":    {"kind": "train",   "seq": 4_096,   "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32_768,  "batch": 32},
    "decode_32k":  {"kind": "decode",  "seq": 32_768,  "batch": 128},
    "long_500k":   {"kind": "decode",  "seq": 524_288, "batch": 1,
                    "needs_subquadratic": True},
}


def resolve_config(cfg: ModelConfig, shape_name: str
                   ) -> Optional[ModelConfig]:
    """Shape-specific config adjustments; None => skip (documented)."""
    shape = SHAPES[shape_name]
    if shape.get("needs_subquadratic") and not cfg.subquadratic:
        if cfg.n_positions and shape["seq"] > cfg.n_positions:
            return None  # learned-position context limit (whisper: 448)
        if any(k in (ATTN, CROSS_ATTN) for k in cfg.layer_kinds) \
                and not cfg.sliding_window:
            # dense/MoE/VLM: sliding-window variant for 500k decode
            return dataclasses.replace(cfg,
                                       sliding_window=SLIDING_WINDOW_500K)
    return cfg


def _ids(*shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """Meta-tensor stand-ins for every model input (no allocation)."""
    shape = SHAPES[shape_name]
    b, s = shape["batch"], shape["seq"]
    kind = shape["kind"]
    specs: dict = {}
    if kind == "train":
        specs["tokens"] = _ids(b, s)
        specs["labels"] = _ids(b, s)
        if cfg.encoder is not None:
            specs["enc_embeds"] = F.frontend_spec(cfg, b)
    elif kind == "prefill":
        specs["tokens"] = _ids(b, s)
        specs["cache"] = M.abstract_cache(cfg, b, s)
        if cfg.encoder is not None:
            specs["enc_embeds"] = F.frontend_spec(cfg, b)
    elif kind == "decode":
        specs["tokens"] = _ids(b, 1)
        specs["pos"] = _ids(b)
        specs["cache"] = M.abstract_cache(cfg, b, s, ring=True)
    return specs
