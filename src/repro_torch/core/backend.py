"""Execution-backend selection for the port's engines.

Both engines resolve their backend through ``backend_for``, as in the
reference.  This slice ports the ``paged`` backend with two layouts:
``gqa`` (pool pages hold per-head K/V, 2 * n_kv_heads * head_dim
scalars per token per layer) and ``latent`` for MLA (the compressed
latent plus the decoupled RoPE key, kv_lora_rank + qk_rope_head_dim
scalars per token per layer: 576 for DeepSeek-V2).  VLM and
encoder-decoder archs get ``cross="pages"``: the encoder K/V of every
cross layer lives in read-only pages of the same GQA pool, addressed
by a second per-request block table, prefilled once and freed with the
request.  A config or request that needs another backend — the dense
backend (recurrent/hybrid archs) or sliding-window paging — raises
``NotImplementedError`` naming the slice that brings it; nothing falls
back quietly.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """Resolved execution backend for one model config."""
    backend: str            # "paged"
    layout: str             # "gqa" | "latent"
    window: int             # sliding window in tokens (0 = unlimited)
    token_width: int        # pool scalars per token per layer
    page_token_bytes: int   # wire/pool bytes per token per layer
    cross: str = "none"     # "none" | "pages"
    cross_ctx: int = 0      # encoder tokens each cross layer attends
    n_cross_layers: int = 0

    @property
    def paged(self) -> bool:
        return self.backend == "paged"


def backend_for(cfg: ModelConfig, requested: str = "auto") -> BackendSpec:
    """Resolve the execution backend for ``cfg`` (paged, GQA or MLA
    latent layout, cross pages for cross-attention archs)."""
    if requested not in ("auto", "paged", "dense"):
        raise ValueError(f"unknown backend {requested!r}")
    if requested == "dense":
        raise NotImplementedError(
            "dense backend: comes with the dense and recurrent backends "
            "slice")
    if cfg.sliding_window:
        raise NotImplementedError(
            f"{cfg.name}: sliding-window paging comes with the "
            "sliding-window slice")
    if not M.paged_supported(cfg):
        raise NotImplementedError(
            f"{cfg.name}: block kinds {sorted(set(cfg.layer_kinds))} need "
            "the dense backend, which comes with its slice")
    dtype_bytes = 2 if cfg.dtype == "bfloat16" else 4
    if cfg.mla is not None:
        layout = "latent"
        width = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    else:
        layout = "gqa"
        width = 2 * cfg.n_kv_heads * cfg.resolved_head_dim
    cross = "pages" if cfg.n_cross_layers else "none"
    return BackendSpec(backend="paged", layout=layout, window=0,
                       token_width=width,
                       page_token_bytes=width * dtype_bytes, cross=cross,
                       cross_ctx=cfg.cross_ctx if cross != "none" else 0,
                       n_cross_layers=cfg.n_cross_layers)
