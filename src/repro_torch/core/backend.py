"""Execution-backend selection for the port's engines.

Both engines resolve their backend through ``backend_for``, as in the
reference.  Layouts:

  * ``gqa``    — paged; pool pages hold per-head K/V, 2 * n_kv_heads *
                 head_dim scalars per token per layer.
  * ``latent`` — paged, for MLA: the compressed latent plus the
                 decoupled RoPE key, kv_lora_rank + qk_rope_head_dim
                 scalars per token per layer (576 for DeepSeek-V2).
  * ``dense``  — per-request dense caches (``model.init_cache``): the
                 backend of the recurrent and hybrid archs, and of the
                 coupled vLLM-style baseline's model calls.

VLM and encoder-decoder archs get ``cross="pages"`` on the paged
backend: the encoder K/V of every cross layer lives in read-only pages
of the same GQA pool, addressed by a second per-request block table,
prefilled once and freed with the request.  On the dense backend they
get ``cross="dense"``: the encoder K/V lives in the request's dense
cache (``ck`` / ``cv``) and ships with it.  A sliding-window config
pages too: ``window`` carries its window to the engines' allocators,
which free the pages that slide wholly out of it.  ``auto`` picks paged
wherever the config supports it and dense elsewhere.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """Resolved execution backend for one model config."""
    backend: str            # "paged" | "dense"
    layout: str             # "gqa" | "latent" | "dense"
    window: int             # sliding window in tokens (0 = unlimited)
    token_width: int        # pool scalars per token per layer
    page_token_bytes: int   # wire/pool bytes per token per layer
    cross: str = "none"     # "none" | "pages" | "dense"
    cross_ctx: int = 0      # encoder tokens each cross layer attends
    n_cross_layers: int = 0

    @property
    def paged(self) -> bool:
        return self.backend == "paged"


def backend_for(cfg: ModelConfig, requested: str = "auto") -> BackendSpec:
    """Resolve the execution backend for ``cfg``: ``auto`` picks paged
    whenever the config supports it, dense otherwise; asking for paged
    on an unsupported arch is a loud error."""
    if requested not in ("auto", "paged", "dense"):
        raise ValueError(f"unknown backend {requested!r}")
    supported = M.paged_supported(cfg)
    if requested == "paged" and not supported:
        raise ValueError(f"{cfg.name}: paged backend unsupported")
    backend = ("paged" if requested in ("auto", "paged") and supported
               else "dense")
    dtype_bytes = 2 if cfg.dtype == "bfloat16" else 4
    if backend == "dense":
        layout, width = "dense", 0
    elif cfg.mla is not None:
        layout = "latent"
        width = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    else:
        layout = "gqa"
        width = 2 * cfg.n_kv_heads * cfg.resolved_head_dim
    if not cfg.n_cross_layers:
        cross = "none"
    else:
        cross = "pages" if backend == "paged" else "dense"
    return BackendSpec(backend=backend, layout=layout,
                       window=cfg.sliding_window,
                       token_width=width,
                       page_token_bytes=width * dtype_bytes, cross=cross,
                       cross_ctx=cfg.cross_ctx if cross != "none" else 0,
                       n_cross_layers=cfg.n_cross_layers)
