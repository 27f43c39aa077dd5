"""MLP variants: SwiGLU / GeLU dense MLPs and the top-k routed MoE."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import sharding as SH
from repro_torch.models.config import ModelConfig


def _act(cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_act == "swiglu":
        gate, up = h.chunk(2, dim=-1)
        return F.silu(gate) * up
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(h, approximate="tanh")


def _dense(cfg: ModelConfig, x: torch.Tensor, wi, wo) -> torch.Tensor:
    """act(x @ wi) @ wo.  Under a mesh, wi's columns and wo's rows may
    shard over the model axis: a GeLU layer runs on this rank's ff
    columns (Megatron); a SwiGLU layer's column shard of [gate | up] does
    not pair gates with their ups, so its product is all-gathered first;
    either ends in the row-parallel all-reduce of ``SH.row``."""
    if not SH.active():
        return _act(cfg, x @ wi) @ wo
    y, sharded = SH.col(x, wi)
    if sharded and (cfg.mlp_act == "swiglu" or SH.model_dim(wo) is None):
        y = SH.all_gather(y, -1)
    return SH.row(_act(cfg, y), wo)


def mlp_forward(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return _dense(cfg, x, p["wi"], p["wo"])


def moe_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                group_size: int = 2048, capacity_factor: float = 0.0):
    """Top-k routed MoE with grouped, capacity-based dispatch, as the
    reference's ``moe_forward`` (``src/repro/models/mlp.py``).

    Tokens are flattened and split into groups of ``g = min(group_size,
    n)`` (zero-padded to a whole group).  Within a group each expert
    takes at most ``cap = max(1, int(k * g / E * cf))`` tokens, in
    token-major order of the flattened (token, choice) pairs; the rest
    are dropped.  Pad tokens of a packed chunk and the dead slots of a
    decode batch sit in ``x`` like any token and take capacity as in
    the reference.

    The reference builds one-hot dispatch/combine tensors and contracts
    them; here each kept (token, choice) is scattered to its (expert,
    slot) row and gathered back, which computes the same sums: every
    (expert, slot) holds at most one token.  Dropped pairs land in a
    spare slot ``cap`` that is cut off.  Nothing syncs with the host.
    Under a mesh ``x`` is this rank's share of the batch.  The group
    size follows the reference's rule over the GLOBAL token count: at
    most the tokens of one data shard (``SH.data_axis_size()``), so no
    group straddles two ranks' tokens and the capacity drops are the
    reference's.  When the model axis divides the experts, each rank
    runs its own experts on every token of its groups and the partial
    combines are all-reduced (expert parallelism without an all-to-all:
    the tokens are already on every model rank); otherwise the expert
    weights are gathered whole.  The load-balance loss averages over
    every data shard.
    Returns (out, aux_loss).
    """
    moe = cfg.moe
    cf = capacity_factor or moe.capacity_factor
    b, s, d = x.shape
    e, k = moe.n_experts, moe.top_k
    n = b * s
    dsize = SH.data_axis_size()
    n_all = n * dsize
    g = min(group_size, n_all)
    # group count must divide the data axis (the reference's rule)
    if n_all % dsize == 0 and n_all // dsize > 0:
        g = min(g, n_all // dsize)
    if dsize > 1 and n % g:
        raise ValueError(f"moe: groups of {g} tokens straddle the data "
                         f"shards of {n} tokens")
    pad = (-n) % g
    xf = x.reshape(n, d)
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
    ng = xf.shape[0] // g
    xg = xf.reshape(ng, g, d)                                # (G, g, d)

    logits = xg.float() @ p["router"].float()                # (G, g, e)
    probs = torch.softmax(logits, dim=-1)
    # a stable sort breaks ties towards the lower expert id, as
    # lax.top_k does (the zero pad rows route uniformly)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :k], top_i[..., :k]            # (G, g, k)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)

    cap = max(1, int(k * g / e * cf))
    sel = F.one_hot(top_i, e).to(torch.int32)                # (G, g, k, e)
    # position of each (token, choice) in its expert's queue
    queue = torch.cumsum(sel.reshape(ng, g * k, e), dim=1).reshape(
        ng, g, k, e)
    slot = (queue * sel).sum(-1) - 1                         # (G, g, k)
    keep = slot < cap

    grp = torch.arange(ng, device=x.device)[:, None, None].expand(ng, g, k)
    dst = torch.where(keep, slot, torch.full_like(slot, cap)).long()
    xe = x.new_zeros((e, ng, cap + 1, d))
    xe[top_i, grp, dst] = xg[:, :, None, :].expand(ng, g, k, d)
    wi, wo = p["wi"], p["wo"]
    expert_par = SH.model_dim(wi) == 0 and SH.model_dim(wo) == 0
    if expert_par:
        wi, wo = SH.weight(wi)[0], SH.weight(wo)[0]
    elif SH.active():
        wi, wo = SH.full(wi), SH.full(wo)
    el = wi.shape[0]
    e0 = SH.model_rank() * el if expert_par else 0
    if expert_par:
        xe = SH.enter(xe)
    xe = xe[e0:e0 + el, :, :cap].reshape(el, ng * cap, d)
    h = _act(cfg, torch.bmm(xe, wi))                         # (e, G cap, f)
    ye = torch.bmm(h, wo).reshape(el, ng, cap, d)
    if expert_par:          # the other ranks' experts contribute zeros
        ye = torch.cat([ye.new_zeros((e0, ng, cap, d)), ye,
                        ye.new_zeros((e - e0 - el, ng, cap, d))])
    picked = ye[top_i, grp, slot.clamp(0, cap - 1)]          # (G, g, k, d)
    # combine weights in x's dtype, as the reference's combine einsum
    w = (top_p * keep).to(x.dtype).float()
    out = (w[..., None] * picked.float()).sum(2)
    if expert_par:
        out = SH.all_reduce(out)
    out = out.to(x.dtype)

    out = out.reshape(-1, d)[:n].reshape(b, s, d)
    if moe.n_shared:
        out = out + _dense(cfg, x, p["shared_wi"], p["shared_wo"])
    # load-balance auxiliary loss (Switch-style)
    frac_tokens = sel.sum(2).float().mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    for ax in (SH.batch_axes() if dsize > 1 else ()):
        frac_tokens = SH.all_reduce(frac_tokens, ax) / SH.axis_size(ax)
        frac_probs = SH.all_reduce(frac_probs, ax) / SH.axis_size(ax)
    aux = e * torch.sum(frac_tokens * frac_probs) * moe.router_aux_weight
    return out, aux
