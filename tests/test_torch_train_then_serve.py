"""Training, then serving the trained weights, records no autograd graph.

A train step (``trainer.make_train_step``, ``make_cls_train_step``)
differentiates detached aliases of the caller's leaves, so every leaf
keeps the ``requires_grad`` the caller gave it.  The serving steps (the
prefill and decode engines, ``CoupledEngine``) run under
``torch.no_grad()``, in whichever thread calls them, so serving leaves
no tensor with a ``grad_fn`` alive, whatever the weights' flags: a
graph that is kept chains every decode step's activations to the last
through the in-place pool and cache writes, and grows with the served
tokens.  The served tokens of the trained weights equal those of a
``detach().clone()`` of them.

CPU, f32, the qwen2 smoke config (OPT-125M-cls smoke for the
classifier step); the kernels' plain versions.  Tokens are compared
exactly.  A graph tensor is a live ``torch.Tensor`` with a ``grad_fn``
that ``gc`` can see; the count is taken with the runtime still alive,
against the count before it was built.
"""
import dataclasses
import gc

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import model as M
from repro_torch.runtime.baseline_vllm import CoupledEngine
from repro_torch.runtime.request import Request
from repro_torch.serving import AsyncCluster, Cluster, SamplingParams
from repro_torch.train import data as D
from repro_torch.train import optimizer as O
from repro_torch.train import trainer as T

BATCH, SEQ = 2, 16
PROMPTS, PROMPT_LEN, NEW = 2, 39, 60
SERVE = dict(chunk_size=16, max_seq=128, max_batch=4, n_pages=64)
DRAIN_S = 60.0


def _cfg(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


def graph_tensors() -> int:
    """Live tensors that hold a ``grad_fn``."""
    gc.collect()
    return sum(1 for o in gc.get_objects()
               if issubclass(type(o), torch.Tensor) and o.grad_fn is not None)


def _lm_step(cfg, params, microbatch=1):
    step = T.make_train_step(cfg, O.AdamWConfig(lr=1e-3, warmup_steps=1),
                             microbatch=microbatch)
    toks, labels = next(D.lm_batches(cfg.vocab_size, BATCH, SEQ, seed=0))
    return step(params, O.init(params), toks, labels)


def _cls_step(cfg, params):
    toks, lens, labels = D.predictor_dataset(
        BATCH, vocab=cfg.vocab_size, max_prompt=SEQ,
        n_classes=cfg.n_classes, seed=0)
    step = T.make_cls_train_step(cfg)
    return step(params, O.init(params), toks, lens, labels)


@pytest.fixture(scope="module")
def trained():
    """(cfg, qwen2 smoke weights after one LM step, their clone)."""
    cfg = _cfg("qwen2_0_5b")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    _lm_step(cfg, params)
    return cfg, params, O.tree_map(lambda p: p.detach().clone(), params)


def _prompts(cfg):
    rng = np.random.default_rng(3)
    return [rng.integers(0, cfg.vocab_size, PROMPT_LEN).astype(np.int32)
            for _ in range(PROMPTS)]


def _sp():
    return SamplingParams(max_new_tokens=NEW)


def _serve_cluster(cfg, params, backend):
    cl = Cluster(cfg, runtime="engine", params=params, n_prefill=1,
                 n_decode=1, device="cpu", backend=backend, **SERVE)
    hs = [cl.submit(p, sampling=_sp()) for p in _prompts(cfg)]
    cl.run()
    return cl, [h.result().tokens for h in hs]


def _serve_async(cfg, params):
    ac = AsyncCluster(cfg, params=params, n_prefill=1, n_decode=1,
                      device="cpu", **SERVE).start()
    try:
        hs = [ac.submit(p, sampling=_sp()) for p in _prompts(cfg)]
        assert ac.drain(timeout=DRAIN_S), "run wedged"
        assert ac.worker_errors == []
    except BaseException:
        ac.close()
        raise
    return ac, [h.result(wait=False).tokens for h in hs]


def _serve_coupled(cfg, params):
    eng = CoupledEngine(cfg, params, max_slots=4, max_seq=SERVE["max_seq"],
                        device="cpu")
    for i, p in enumerate(_prompts(cfg)):
        # oracle mode: the first token, then decode_len more
        eng.submit(Request(rid=f"r{i}", prompt_len=len(p),
                           decode_len=NEW - 1, prompt_tokens=p))
    out, t = {}, 0.0
    for _ in range(1000):
        for fin in eng.step(t):
            out[fin.req.rid] = fin.tokens
        t += 0.01
        if eng.done():
            break
    return eng, [out[f"r{i}"] for i in range(PROMPTS)]


RUNTIMES = {
    "cluster": lambda cfg, p: _serve_cluster(cfg, p, "paged"),
    "cluster_dense": lambda cfg, p: _serve_cluster(cfg, p, "dense"),
    "async": _serve_async,
    "coupled": _serve_coupled,
}


def _close(rt):
    if isinstance(rt, AsyncCluster):
        rt.close()


_CLONE_TOKENS: dict = {}


def _clone_tokens(cfg, clone, runtime):
    """The tokens ``runtime`` streams for the trained weights' clone,
    served once per runtime for every test of this module."""
    if runtime not in _CLONE_TOKENS:
        rt, _CLONE_TOKENS[runtime] = RUNTIMES[runtime](cfg, clone)
        _close(rt)
    return _CLONE_TOKENS[runtime]


@pytest.mark.parametrize("kind,microbatch", [("lm", 1), ("lm", 2),
                                             ("cls", 1)])
def test_train_step_leaves_requires_grad_as_passed(kind, microbatch):
    """After one step no leaf requires grad, as none did before; every
    leaf was updated in its own storage, and bit for bit as the same
    step updates a copy whose leaves were set to require grad first."""
    cfg = _cfg("qwen2_0_5b" if kind == "lm" else "opt_125m_cls")

    def step(params):
        if kind == "lm":
            return _lm_step(cfg, params, microbatch)[::2]
        return _cls_step(cfg, params)[::2]

    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    before = O.tree_map(lambda p: p.clone(), params)
    hot = O.tree_map(lambda p: p.clone().requires_grad_(True), params)
    ptrs = [p.data_ptr() for p in O.leaves(params)]
    new, loss = step(params)
    assert new is params
    assert loss.grad_fn is None and not loss.requires_grad
    flat = O.leaves(params)
    assert [p.requires_grad for p in flat] == [False] * len(flat)
    assert all(p.grad_fn is None and p.grad is None for p in flat)
    assert [p.data_ptr() for p in flat] == ptrs
    moved = [not torch.equal(a, b) for a, b in zip(flat, O.leaves(before))]
    assert sum(moved) > len(flat) // 2
    _, hot_loss = step(hot)
    assert torch.equal(loss, hot_loss)
    assert all(torch.equal(a, b) for a, b in zip(flat, O.leaves(hot)))
    assert all(p.requires_grad for p in O.leaves(hot))


@pytest.mark.parametrize("runtime", list(RUNTIMES))
def test_serving_trained_weights_records_no_graph(trained, runtime):
    """Serving the trained weights leaves no graph tensor while the
    runtime is alive, and streams the clone's tokens."""
    cfg, params, clone = trained
    want = _clone_tokens(cfg, clone, runtime)
    base = graph_tensors()
    rt, got = RUNTIMES[runtime](cfg, params)
    try:
        assert graph_tensors() - base == 0
    finally:
        _close(rt)
    assert got == want
    assert all(len(t) == NEW for t in got)


@pytest.mark.parametrize("runtime", ["cluster", "coupled"])
def test_serving_weights_that_require_grad(trained, runtime):
    """Weights whose leaves were set to require grad by hand serve with
    nothing recorded, to the clone's tokens, and keep their flags."""
    cfg, _, clone = trained
    want = _clone_tokens(cfg, clone, runtime)
    hot = O.tree_map(lambda p: p.detach().clone().requires_grad_(True),
                     clone)
    base = graph_tensors()
    rt, got = RUNTIMES[runtime](cfg, hot)
    assert graph_tensors() - base == 0
    assert got == want
    assert all(p.requires_grad for p in O.leaves(hot))
