"""Mesh-level prefill/decode disaggregation (the reference's
``core/disagg.py``).

The runtime disaggregates in *space*: separate prefill/decode instances
exchanging KV over the network stack (core/kv_transfer.py).  On a mesh
with a ``pod`` axis the equivalent first-class operation is a KV handoff
across that axis: pod 0 prefills, every pod-0 rank ships its shard of
every cache leaf to the pod-1 rank with the same (data, model)
coordinates — a one-sided put — and pod 1 decodes.

The reference runs the step as one SPMD program in which both pods
compute the prefill (a ``ppermute`` then moves pod 0's cache).  Here the
pods run different code: pod 0 alone prefills, pod 1 alone decodes, so
a broken handoff shows in pod 1's logits.

The transport is a ``broadcast`` from the pod-0 rank within each
(pod-0 rank, pod-1 rank) pair: the mesh's ``pod`` sub-group, made once
when the mesh is.  One code path serves NCCL across cards and gloo,
whose CUDA support covers ``broadcast`` and ``all_reduce`` (two ranks
on one card, the CPU tests).
"""
from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.models import sharding as S
from repro_torch.models.config import ModelConfig


def _pod(mesh) -> int:
    assert "pod" in mesh.mesh_dim_names, "kv_handoff needs a multi-pod mesh"
    return mesh.get_local_rank("pod")


def _send(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` of this rank's pod-0 partner (rank 0 of the pod sub-group),
    on both members of the pair."""
    f = torch.ops._c10d_functional
    name = mesh.get_group("pod").group_name
    return f.wait_tensor(f.broadcast(x.contiguous(), 0, name))


def kv_handoff(cache, mesh, batch_axes=("data",)):
    """Ship every cache leaf pod 0 -> pod 1, leaf by leaf.

    Leaves keep their data/model sharding; only the pod placement moves:
    each pod-0 rank's local shard lands in place in the pod-1 rank with
    the same coordinates.  Pod 0's copy is zero afterwards (ownership
    transferred, as in a one-sided put).  ``cache`` is the dense cache
    list (leaves DTensors or plain local tensors); it is updated in place
    and returned.  ``batch_axes`` is accepted for the reference's
    signature: the shards move whatever their layout."""
    del batch_axes
    pod = _pod(mesh)
    for layer in cache:
        for leaf in layer.values():
            loc = S.local(leaf)
            got = _send(loc, mesh)
            if pod == 0:
                loc.zero_()
            else:
                loc.copy_(got)
    return cache


def make_disagg_step(cfg: ModelConfig, mesh, *, chunk_size: int,
                     batch_axes=("data",)):
    """Build ``disagg_step(params, tokens, cache, enc_embeds=None) ->
    (first_logits, decode_logits, cache)``: chunked prefill on pod 0, the
    pod 0 -> pod 1 KV handoff, one decode step on pod 1.

    Every rank calls it with its own (DTensor) params, tokens and cache
    over ``mesh``.  Pod 0 runs ``prefill_chunked`` and sends its cache
    and its last-position logits; pod 1 receives both, takes the argmax
    as the first token and runs ``decode_step`` at position S.  Both pods
    return the first logits; the decode logits are pod 1's (None on pod
    0, which decodes nothing); the cache is pod 1's filled one, and pod
    0's zeros.  Within each pod the model runs under
    ``sharding.activation_sharding(mesh, batch_axes)``, and under
    ``torch.no_grad()``: it records no autograd graph."""

    @torch.no_grad()
    def disagg_step(params, tokens, cache, enc_embeds=None):
        pod = _pod(mesh)
        b, s = tokens.shape
        with S.activation_sharding(mesh, batch_axes=batch_axes):
            if pod == 0:
                first, cache = M.prefill_chunked(
                    params, cfg, tokens, cache, chunk_size=chunk_size,
                    enc_embeds=enc_embeds)
                loc = first.to_local()
            else:
                # the shape of pod 0's local logits, to receive into
                loc = torch.empty((S.local(tokens).shape[0], 1,
                                   M.local_vocab(params, cfg)),
                                  dtype=M.torch_dtype(cfg),
                                  device=S.local(tokens).device)
            cache = kv_handoff(cache, mesh, batch_axes=batch_axes)
            loc = _send(loc, mesh)
            if pod == 0:
                return first, None, cache
            first = M.wrap_logits(loc, cfg, S.batch_sharded(tokens))
            full = first.redistribute(placements=[
                p if ax in batch_axes else _replicate()
                for ax, p in zip(mesh.mesh_dim_names, first.placements)])
            tok = torch.argmax(full.to_local()[:, -1], dim=-1)[:, None]
            pos = torch.full((tok.shape[0],), s, dtype=torch.int32,
                             device=tok.device)
            if S.batch_sharded(tokens):
                tok = S.wrap(tok.to(torch.int32), True)
                pos = S.wrap(pos, True)
            dec, cache = M.decode_step(params, cfg, tok, cache, pos)
            return first, dec, cache

    return disagg_step


def _replicate():
    from torch.distributed.tensor import Replicate
    return Replicate()
