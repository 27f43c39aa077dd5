"""Architecture config registry of the port.

``get_config(arch_id)`` returns the full-size ModelConfig;
``get_smoke_config(arch_id)`` the reduced same-family variant used by the
CPU tests.  Every architecture of the reference's registry is ported:
the full-attention GQA models (qwen2-0.5b, Phi-4-mini, Mistral-Nemo,
DeepSeek-67B, OPT-13B, and Granite-MoE with its routed experts),
DeepSeek-V2 (MLA latent pages and routed MoE), Llama-3.2-Vision-11B
and Whisper-tiny (read-only cross-attention pages), the two dense
rows, RecurrentGemma-9B (RG-LRU + local attention) and xLSTM-1.3B
(sLSTM / mLSTM), which serve on the dense backend, and opt-125m-cls,
the length predictor's classifier (``model.classify``).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, reduced

ARCH_IDS = ("qwen2_0_5b", "llama_3_2_vision_11b", "phi4_mini_3_8b",
            "whisper_tiny", "deepseek_v2_236b", "mistral_nemo_12b",
            "deepseek_67b", "granite_moe_3b_a800m", "opt_13b",
            "recurrentgemma_9b", "xlstm_1_3b", "opt_125m_cls")

# the ten assigned architectures, in the reference's order (its
# ``ARCH_IDS[:10]``; the port's ARCH_IDS lists them in another order)
ASSIGNED_ARCHS = ("qwen2_0_5b", "llama_3_2_vision_11b", "phi4_mini_3_8b",
                  "recurrentgemma_9b", "whisper_tiny", "xlstm_1_3b",
                  "deepseek_v2_236b", "mistral_nemo_12b", "deepseek_67b",
                  "granite_moe_3b_a800m")

_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


def canonical(arch_id: str) -> str:
    key = arch_id.replace("-", "_").replace(".", "_")
    return _ALIASES.get(arch_id, key)


def _module(arch_id: str):
    name = canonical(arch_id)
    if name not in ARCH_IDS:
        raise ValueError(f"{arch_id}: no such architecture (known: "
                         f"{', '.join(ARCH_IDS)})")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    mod = _module(arch_id)
    if hasattr(mod, "smoke"):
        return mod.smoke()
    return reduced(get_config(arch_id))
