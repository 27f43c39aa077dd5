"""Random weights from the run seed, made on the device in the type
they are served in, in the parameter layout the port's engines take
(``repro_torch.models.model``: ``embed``, ``final_norm``, optional
``pos_embed`` / ``lm_head``, and one {norm1, attn {wq, wk, wv, wo},
norm2, mlp {wi, wo}} dict a layer).

One ``torch.randn`` call draws every matrix into one flat buffer; each
leaf is a view of it, scaled in place by the port's init scale (normal
times fan-in ** -0.5, ones for the norms).  The benchmark hands the
same tensors to the program and to the reference.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def shapes(cfg: dict) -> Tuple[List[Tuple[str, tuple, float]],
                                List[List[Tuple[str, tuple, float]]]]:
    """(top-level leaves, per-layer leaves) as (name, shape, scale)."""
    d, h, kvh, hd = (cfg["hidden_size"], cfg["num_attention_heads"],
                     cfg["num_key_value_heads"], cfg["head_dim"])
    ff, vocab = ffn(cfg), cfg["vocab_size"]
    glu = 2 if cfg["mlp_act"] == "swiglu" else 1
    top = [("embed", (vocab, d), d ** -0.5)]
    if cfg.get("learned_positions"):
        top.append(("pos_embed", (cfg["learned_positions"], d), d ** -0.5))
    if not cfg["tie_word_embeddings"]:
        top.append(("lm_head", (d, vocab), d ** -0.5))
    layer = [("attn.wq", (d, h * hd), d ** -0.5),
             ("attn.wk", (d, kvh * hd), d ** -0.5),
             ("attn.wv", (d, kvh * hd), d ** -0.5),
             ("attn.wo", (h * hd, d), (h * hd) ** -0.5),
             ("mlp.wi", (d, glu * ff), d ** -0.5),
             ("mlp.wo", (ff, d), ff ** -0.5)]
    return top, [layer] * cfg["num_hidden_layers"]


def ffn(cfg: dict) -> int:
    return cfg.get("ffn_dim") or cfg["intermediate_size"]


def make(cfg: dict, seed: int, device, dtype=torch.bfloat16
         ) -> Dict[str, object]:
    top, layers = shapes(cfg)
    sizes = [s for _, s, _ in top] + [s for lay in layers for _, s, _ in lay]
    total = sum(torch.Size(s).numel() for s in sizes)
    gen = torch.Generator(device=device)
    gen.manual_seed(abs(int(seed)) % 2 ** 63)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    at = 0

    def take(shape, scale):
        nonlocal at
        n = torch.Size(shape).numel()
        leaf = flat[at:at + n].view(shape).mul_(scale)
        at += n
        return leaf

    d = cfg["hidden_size"]
    params: Dict[str, object] = {name: take(s, sc) for name, s, sc in top}
    params["final_norm"] = torch.ones(d, device=device, dtype=dtype)
    params["layers"] = []
    for lay in layers:
        p: Dict[str, Dict[str, torch.Tensor]] = {"attn": {}, "mlp": {}}
        for name, s, sc in lay:
            group, leaf = name.split(".")
            p[group][leaf] = take(s, sc)
        p["norm1"] = torch.ones(d, device=device, dtype=dtype)
        p["norm2"] = torch.ones(d, device=device, dtype=dtype)
        params["layers"].append(p)
    return params


def param_count(cfg: dict) -> int:
    """Parameters ``make`` draws (norm weights included)."""
    top, layers = shapes(cfg)
    n = sum(torch.Size(s).numel() for _, s, _ in top)
    n += sum(torch.Size(s).numel() for lay in layers for _, s, _ in lay)
    return n + cfg["hidden_size"] * (1 + 2 * cfg["num_hidden_layers"])
