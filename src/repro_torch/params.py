"""Weight bridge from the JAX package's parameters to the port's.

``from_reference`` takes the pytree of ``repro.models.model.init_params``
with every leaf already converted to a numpy array (for example
``jax.tree.map(np.asarray, params)``), so this module needs neither JAX
nor the JAX package.  The reference stacks its repeated layers: ``body``
is a tuple with one dict per ``pattern`` kind whose leaves carry a
leading ``n_repeats`` dim; ``prefix`` and ``suffix`` are unrolled.  The
port's ``layers`` list is prefix + body (repeat-major, pattern order) +
suffix, the order of the reference's absolute layer ids, each layer's
dict whole (a CROSS_ATTN layer's ``norm_c`` and ``cross`` included).  An
encoder-decoder's ``encoder`` {blocks, norm} comes across with its
blocks as a list.  Leaves keep their dtype: the MoE router stays f32 in
a bf16 model, as in the reference, and so does the RG-LRU's
``a_param``.  ``cache_from_reference`` brings a dense cache pytree
across the same way, so caches and recurrent states compare leaf by
leaf.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


def to_tensor(a, device) -> torch.Tensor:
    """numpy -> torch, keeping the dtype.  numpy carries bfloat16 as
    ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses: its bits
    go through an int16 view and come back as torch.bfloat16."""
    a = np.array(a, order="C")    # a writable copy the tensor may own
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _tree(x, device, index=None):
    if isinstance(x, dict):
        return {k: _tree(v, device, index) for k, v in x.items()}
    return to_tensor(x if index is None else np.asarray(x)[index], device)


def _layers(tree, cfg: ModelConfig, device) -> List[Dict[str, Any]]:
    """The reference's prefix / stacked body / suffix as one list in
    execution order."""
    layers: List[Dict[str, Any]] = [_tree(b, device)
                                    for b in tree["prefix"]]
    for r in range(cfg.n_repeats):
        for j in range(len(cfg.pattern)):
            layers.append(_tree(tree["body"][j], device, index=r))
    layers.extend(_tree(b, device) for b in tree["suffix"])
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: {len(layers)} layers in the tree, "
                         f"config has {cfg.n_layers}")
    return layers


def from_reference(tree: Dict[str, Any], cfg: ModelConfig,
                   device="cuda") -> Dict[str, Any]:
    """Port params (see ``repro_torch.models.model``) from the reference
    pytree of numpy arrays, on ``device``, dtypes kept."""
    out: Dict[str, Any] = {
        k: to_tensor(tree[k], device)
        for k in ("embed", "final_norm", "pos_embed", "lm_head",
                  "cls_head")
        if k in tree}
    out["layers"] = _layers(tree, cfg, device)
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {"blocks": [_tree(b, device) for b in enc["blocks"]],
                          "norm": to_tensor(enc["norm"], device)}
    return out


def cache_from_reference(tree: Dict[str, Any], cfg: ModelConfig,
                         device="cuda") -> List[Dict[str, Any]]:
    """The port's dense cache (``repro_torch.models.model.init_cache``:
    one dict a layer) from the reference's cache pytree of numpy arrays
    (prefix / stacked body / suffix, as ``repro.models.model.init_cache``
    builds it), on ``device``, dtypes kept."""
    return _layers(tree, cfg, device)
