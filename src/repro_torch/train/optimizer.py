"""AdamW (+ cosine schedule, global-norm clipping) over the port's
parameter trees, as the reference's pure-JAX ``train/optimizer.py``.

A tree is the params layout of ``models/model.py``: dicts and lists
nesting tensors.  The moments ``m`` and ``v`` are f32 trees of the same
layout, as in the reference.  ``update`` changes the parameters and the
moments IN PLACE, under ``torch.no_grad()`` (the reference returns new
trees; here the old ones are not kept, which saves a copy of every
weight and moment), and returns them.  Each parameter is cast back to
its own dtype after the f32 step, as the reference does.  The schedule
and the bias corrections are host floats computed in float32, the
reference's arithmetic; the global norm and the clip scale stay on the
parameters' device, so an update never waits for the device.

Sharded (``models/sharding.py``): inside ``activation_sharding`` the
parameters and moments may be DTensors and the gradients this rank's
local ones.  ``update`` then steps every rank's local shards in place,
and the clip norm is the global one: each leaf's squares are summed
over the mesh axes it shards over (``sharding.shard_sum``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List

import numpy as np
import torch

from repro_torch.models import sharding as SH


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of ``tree`` in a fixed order (dict insertion order,
    list order)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf over trees of one layout."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


@dataclasses.dataclass
class AdamWState:
    step: int
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def init(params) -> AdamWState:
    return AdamWState(
        step=0,
        m=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params),
        v=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params))


def schedule(cfg: AdamWConfig, step: int) -> float:
    """The learning rate at ``step``: linear warmup, then a cosine down
    to ``min_lr_frac`` of ``lr``, in float32 as the reference computes
    it."""
    f32 = np.float32
    s = f32(step)
    warm = min(f32(1.0), (s + f32(1)) / f32(cfg.warmup_steps))
    prog = np.clip((s - f32(cfg.warmup_steps))
                   / f32(max(1, cfg.total_steps - cfg.warmup_steps)),
                   f32(0.0), f32(1.0))
    cos = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * prog, dtype=f32))
    frac = f32(cfg.min_lr_frac) + f32(1 - cfg.min_lr_frac) * cos
    return float(f32(cfg.lr) * warm * frac)


def global_norm(tree, like=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (a 0-d tensor).
    ``like``: the tree whose leaves' placements ``tree``'s local leaves
    share (the parameters), for a norm over the whole mesh."""
    sq = [l.float().square().sum() for l in leaves(tree)]
    return torch.sqrt(SH.shard_sum(sq, leaves(tree if like is None
                                               else like)))


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: AdamWState, params):
    """One AdamW step.  Returns (params, state), both updated in place:
    gradients clipped to a global norm of ``clip_norm``, then per leaf
    m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, and p -= lr (m_hat /
    (sqrt(v_hat) + eps) + weight_decay p), all in f32, p cast back to
    its dtype."""
    gnorm = global_norm(grads, params)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    f32 = np.float32
    b1c = float(f32(1) - f32(cfg.b1) ** f32(step))
    b2c = float(f32(1) - f32(cfg.b2) ** f32(step))
    for g, m, v, p in zip(leaves(grads), leaves(state.m), leaves(state.v),
                          leaves(params)):
        m, v, p = SH.local(m), SH.local(v), SH.local(p)
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    state.step = step
    return params, state
