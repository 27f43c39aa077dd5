"""Architecture config registry of the port.

``get_config(arch_id)`` returns the full-size ModelConfig;
``get_smoke_config(arch_id)`` the reduced same-family variant used by the
CPU tests.  Only the architectures whose paths are ported are listed:
qwen2-0.5b (paged GQA), DeepSeek-V2 (MLA latent pages and routed MoE),
and Llama-3.2-Vision-11B and Whisper-tiny (read-only cross-attention
pages).  The others come with their slices.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, reduced

ARCH_IDS = ("qwen2_0_5b", "deepseek_v2_236b", "llama_3_2_vision_11b",
            "whisper_tiny")

_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


def canonical(arch_id: str) -> str:
    key = arch_id.replace("-", "_").replace(".", "_")
    return _ALIASES.get(arch_id, key)


def _module(arch_id: str):
    name = canonical(arch_id)
    if name not in ARCH_IDS:
        raise NotImplementedError(
            f"{arch_id}: not ported yet; its config comes with the slice "
            "that ports its attention path (see ROADMAP.md queue A)")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    mod = _module(arch_id)
    if hasattr(mod, "smoke"):
        return mod.smoke()
    return reduced(get_config(arch_id))
