"""Training substrate: losses and the train-step factories (LM and
classifier), as the reference's ``train/trainer.py``.

``make_train_step`` / ``make_cls_train_step`` return callables with the
reference's signatures and results: ``train_step(params, opt_state,
tokens, labels[, enc_embeds]) -> (params, opt_state, loss)`` and
``train_step(params, opt_state, tokens, lengths, labels) -> (params,
opt_state, loss, acc)``.  Inputs may be numpy arrays or tensors; they
are moved to the parameters' device.  Gradients come from
``torch.autograd`` through the model's checkpointed layers, whose
attention is kernel 5 and its hand-written backward on the card; a leaf
the loss does not reach (a classifier's unused LM-side weights, say)
gets a zero gradient, as ``jax.grad`` gives.  The step updates the
parameters and the optimizer state in place (``optimizer.update``);
it differentiates detached aliases of the leaves, so the caller's
leaves keep their ``requires_grad`` and can be served as they are.

The LM step runs sharded too: called inside
``sharding.activation_sharding`` with DTensor parameters and moments
(``sharding.shard``) and tokens sharded over the batch axes, every rank
differentiates its local shards, the loss is the mean over every rank's
tokens (``sharding.vocab_parallel_nll``), the gradients of the leaves
the batch axes do not shard are all-reduced over them
(``sharding.reduce_grads``), and the clip norm is the global one.
Outside a context each of these is the plain operation.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import model as M
from repro_torch.models import sharding as SH
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as opt


def _device(params) -> torch.device:
    return params["embed"].device


def _on(x, device) -> Optional[torch.Tensor]:
    return None if x is None else torch.as_tensor(x, device=device)


def lm_loss(params, cfg: ModelConfig, tokens, labels, enc_embeds=None):
    """Next-token cross entropy; labels are the tokens shifted by the
    caller, -100 entries masked.  Returns (loss + MoE aux, loss).  Under
    a mesh the logits may be this rank's vocab shard and the loss is the
    global mean (``sharding.vocab_parallel_nll``)."""
    logits, aux = M.forward_train(params, cfg, tokens,
                                  enc_embeds=enc_embeds)
    loss = SH.vocab_parallel_nll(SH.local(logits), SH.local(labels),
                                 cfg.vocab_size)
    return loss + aux, loss


def cls_loss(params, cfg: ModelConfig, tokens, lengths, labels):
    """Cross entropy of ``model.classify`` against the bucket labels.
    Returns (loss, accuracy)."""
    logits = M.classify(params, cfg, tokens, lengths).float()
    labels = labels.long()
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    acc = (torch.argmax(logits, -1) == labels).float().mean()
    return nll.mean(), acc


def grads_of(fn, params):
    """(gradient tree of ``fn(params)[0]`` w.r.t. every leaf of
    ``params``, ``fn(params)`` detached).  ``fn`` gets a tree of
    detached aliases of every leaf, each requiring grad
    (``sharding.grad_leaves``): they share the leaves' storage, so an
    in-place update of ``params`` lands in them, while the caller's
    leaves keep the ``requires_grad`` they were passed with and record
    nothing.  A leaf the value does not reach gets zeros.  Inside a
    context the gradients are of this rank's local shards, and a leaf
    the batch axes do not shard holds this rank's share
    (``sharding.reduce_grads`` sums them)."""
    flat, params = SH.grad_leaves(params)
    out = fn(params)
    got = torch.autograd.grad(out[0], flat, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(p)
              for g, p in zip(got, flat))
    return (opt.tree_map(lambda _: next(it), params),
            tuple(o.detach() for o in out))


def lm_grads(params, cfg: ModelConfig, tokens, labels, enc_embeds=None,
             microbatch: int = 1):
    """(gradient tree of ``lm_loss`` (MoE aux included), loss).  With
    ``microbatch`` > 1: the gradients of ``microbatch`` equal slices of
    the batch, one after another, summed in f32 and averaged, as the
    reference's ``lax.scan`` accumulation (activation memory scales
    1 / microbatch).  Inside a context the inputs are this rank's batch
    shard, the gradients its local shards of the global loss's, summed
    over the batch axes once, after the microbatches."""
    if SH.active():
        tokens, labels, enc_embeds = (
            None if x is None else SH.local(x)
            for x in (tokens, labels, enc_embeds))
    if microbatch <= 1:
        g, (_, loss) = grads_of(lambda p: lm_loss(
            p, cfg, tokens, labels, enc_embeds), params)
        return SH.reduce_grads(g, params), loss
    b = tokens.shape[0]
    if b % microbatch:
        raise ValueError(f"batch {b} is not a multiple of microbatch "
                         f"{microbatch}")
    mb = b // microbatch
    g_acc = opt.tree_map(lambda p: torch.zeros_like(SH.local(p),
                                                    dtype=torch.float32),
                         params)
    l_acc = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i in range(microbatch):
        sl = slice(i * mb, (i + 1) * mb)
        e = None if enc_embeds is None else enc_embeds[sl]
        g, (_, loss) = grads_of(lambda p: lm_loss(
            p, cfg, tokens[sl], labels[sl], e), params)
        for a, x in zip(opt.leaves(g_acc), opt.leaves(g)):
            a.add_(x.float())
        l_acc = l_acc + loss
    g_acc = SH.reduce_grads(g_acc, params)
    return opt.tree_map(lambda g: g / microbatch, g_acc), l_acc / microbatch


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[opt.AdamWConfig]
                    = None, has_encoder: bool = False,
                    microbatch: int = 1):
    """The LM train step; ``microbatch`` as in ``lm_grads``; sharded
    inside ``sharding.activation_sharding`` (the module's docstring)."""
    opt_cfg = opt_cfg or opt.AdamWConfig()

    def train_step(params, opt_state, tokens, labels, enc_embeds=None):
        if has_encoder != (enc_embeds is not None):
            raise ValueError("enc_embeds must be given exactly when "
                             "has_encoder")
        dev = _device(params)
        g, loss = lm_grads(params, cfg, *(_on(SH.local(x), dev) for x in
                                          (tokens, labels, enc_embeds)),
                           microbatch)
        params, opt_state = opt.update(opt_cfg, g, opt_state, params)
        return params, opt_state, loss
    return train_step


def make_cls_train_step(cfg: ModelConfig,
                        opt_cfg: Optional[opt.AdamWConfig] = None):
    opt_cfg = opt_cfg or opt.AdamWConfig(lr=1e-4, weight_decay=0.01)

    def train_step(params, opt_state, tokens, lengths, labels):
        dev = _device(params)
        tokens, lengths, labels = (_on(x, dev)
                                   for x in (tokens, lengths, labels))
        g, (loss, acc) = grads_of(lambda p: cls_loss(
            p, cfg, tokens, lengths, labels), params)
        params, opt_state = opt.update(opt_cfg, g, opt_state, params)
        return params, opt_state, loss, acc
    return train_step
