"""The training slice of the port against the JAX package: the
train-mode forward, the classifier, gradients of the losses, AdamW,
microbatching, the data pipelines, ``ModelPredictor`` and the training
launcher, on the smoke configs in f32.

Parameters are the reference's ``init_params`` brought across with
``params.from_reference``; tokens, labels and encoder inputs come from
numpy with a seed and go to both.  The reference's attention is its
blocked ``flash_attn`` in ``jnp`` (JAX's autodiff for the gradient);
the port's is kernel 5's plain version and its plain backward.

Tolerances (f32, summation order only): logits and the classifier's
outputs within 1e-4 absolute (they reach about 5); losses within 1e-5
relative; each gradient leaf within 1e-4 of that leaf's largest
reference gradient (leaves span several orders of magnitude, so a
single absolute bound would say nothing about the small ones); AdamW
within 1e-6 relative (the same f32 arithmetic, one rounding apart where
XLA fuses).
"""
import dataclasses
import io
import contextlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import blocks as RB  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.train import data as RD  # noqa: E402
from repro.train import optimizer as RO  # noqa: E402
from repro.train import trainer as RT  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.params import from_reference  # noqa: E402
from repro_torch.train import data as D  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train import trainer as T  # noqa: E402

LOGIT_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
OPT_RTOL = 1e-6
BATCH, SEQ = 2, 16

_SETUPS = {}


def _setup(arch):
    """(reference cfg, reference params, port cfg, port params), f32,
    built once per arch."""
    if arch not in _SETUPS:
        rcfg = dataclasses.replace(ref_smoke(arch), dtype="float32")
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        rp = RM.init_params(jax.random.PRNGKey(0), rcfg)
        p = from_reference(jax.tree.map(np.asarray, rp), cfg, "cpu")
        _SETUPS[arch] = rcfg, rp, cfg, p
    return _SETUPS[arch]


def batch(cfg, seed=0):
    """(tokens, labels, enc_embeds or None) as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
    enc = None
    if cfg.encoder is not None:
        enc = (rng.standard_normal((BATCH, cfg.encoder.n_ctx, cfg.d_model))
               * 0.02).astype(np.float32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -100                       # masked positions
    return toks[:, :-1], labels, enc


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _assert_grads_close(got, exp_ref_tree, cfg):
    exp = O.leaves(from_reference(jax.tree.map(np.asarray, exp_ref_tree),
                                  cfg, "cpu"))
    got = O.leaves(got)
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert g.shape == e.shape and g.dtype == e.dtype
        scale = float(e.abs().max())
        err = float((g - e).abs().max())
        assert err <= GRAD_REL * scale + 1e-12, (tuple(e.shape), err, scale)


# -- forward_train and classify -----------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2_0_5b", "opt_125m_cls",
                                  "deepseek_v2_236b", "whisper_tiny",
                                  "recurrentgemma_9b", "xlstm_1_3b"])
def test_forward_train_matches_reference(arch):
    rcfg, rp, cfg, p = _setup(arch)
    toks, _, enc = batch(cfg)
    exp, exp_aux = jax.jit(lambda p, t, e: RM.forward_train(
        p, rcfg, t, enc_embeds=e))(rp, _j(toks), _j(enc))
    with torch.no_grad():
        got, aux = M.forward_train(p, cfg, _t(toks), enc_embeds=_t(enc))
    assert got.shape == exp.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=0,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(exp_aux), rtol=LOSS_RTOL,
                               atol=1e-9)
    if cfg.moe is not None:
        assert float(aux) > 0          # the routed layers' aux reached us


def test_classify_matches_reference():
    rcfg, rp, cfg, p = _setup("opt_125m_cls")
    toks, _, _ = batch(cfg, seed=1)
    lens = np.array([SEQ, 5], np.int32)
    exp = RM.classify(rp, rcfg, _j(toks), _j(lens))
    with torch.no_grad():
        got = M.classify(p, cfg, _t(toks), _t(lens))
    assert got.shape == (BATCH, cfg.n_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=0,
                               atol=LOGIT_TOL)


# -- gradients -----------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2_0_5b", "opt_125m_cls",
                                  "deepseek_v2_236b", "whisper_tiny"])
def test_lm_loss_gradients_match_reference(arch):
    """jax.grad of the reference's lm_loss (MoE aux included) against the
    port's autograd through checkpointed layers and kernel 5's plain
    backward; every leaf, the unused classifier head's zeros too."""
    rcfg, rp, cfg, p = _setup(arch)
    toks, labels, enc = batch(cfg, seed=2)
    (exp_tot, exp_loss), exp_g = jax.jit(jax.value_and_grad(
        lambda p: RT.lm_loss(p, rcfg, _j(toks), _j(labels), _j(enc)),
        has_aux=True))(rp)
    got_g, got_loss = T.lm_grads(p, cfg, _t(toks), _t(labels), _t(enc))
    np.testing.assert_allclose(float(got_loss), float(exp_loss),
                               rtol=LOSS_RTOL)
    _assert_grads_close(got_g, exp_g, cfg)
    if arch == "deepseek_v2_236b":       # the aux reaches the gradient
        assert float(exp_tot) > float(exp_loss)


def test_cls_loss_gradients_match_reference():
    rcfg, rp, cfg, p = _setup("opt_125m_cls")
    toks, _, _ = batch(cfg, seed=3)
    lens = np.array([SEQ, 9], np.int32)
    labels = np.array([3, 11], np.int32)
    (exp_loss, exp_acc), exp_g = jax.value_and_grad(
        lambda p: RT.cls_loss(p, rcfg, _j(toks), _j(lens), _j(labels)),
        has_aux=True)(rp)
    got_g, (loss, acc) = T.grads_of(lambda q: T.cls_loss(
        q, cfg, _t(toks), _t(lens), _t(labels)), p)
    np.testing.assert_allclose(float(loss), float(exp_loss),
                               rtol=LOSS_RTOL)
    assert float(acc) == float(exp_acc)
    _assert_grads_close(got_g, exp_g, cfg)


def test_microbatch_gives_the_gradients_of_the_whole_batch():
    _, _, cfg, p = _setup("qwen2_0_5b")
    toks, labels, _ = batch(cfg, seed=4)
    g2, l2 = T.lm_grads(p, cfg, _t(toks), _t(labels), microbatch=2)
    # the masked positions sit in the first row, so the slices' means
    # weigh tokens otherwise than the whole batch's: hold the unmasked
    # case to equality and this one to the slices' own mean
    rows = [T.lm_grads(p, cfg, _t(toks[i:i + 1]), _t(labels[i:i + 1]))
            for i in range(2)]
    np.testing.assert_allclose(float(l2), float(sum(r[1] for r in rows))
                               / 2, rtol=LOSS_RTOL)
    for a, b0, b1 in zip(O.leaves(g2), O.leaves(rows[0][0]),
                         O.leaves(rows[1][0])):
        torch.testing.assert_close(a, (b0 + b1) / 2, rtol=1e-5, atol=1e-7)
    full = labels.copy()
    full[0, :3] = toks[0, 1:4]
    g1, l1 = T.lm_grads(p, cfg, _t(toks), _t(full))
    g2, l2 = T.lm_grads(p, cfg, _t(toks), _t(full), microbatch=2)
    np.testing.assert_allclose(float(l2), float(l1), rtol=LOSS_RTOL)
    for a, b in zip(O.leaves(g2), O.leaves(g1)):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= GRAD_REL * scale + 1e-12


# -- AdamW ---------------------------------------------------------------------
def test_adamw_update_matches_reference():
    """Three steps on the same numpy gradients (the second large enough
    to clip): parameters and both moments against the reference's."""
    rng = np.random.default_rng(5)
    shapes = {"a": (3, 4), "layers": [{"w": (5,)}, {"w": (2, 2)}]}
    p0 = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),
                      shapes, is_leaf=lambda x: isinstance(x, tuple))
    cfg = O.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5)
    rcfg = RO.AdamWConfig(**dataclasses.asdict(cfg))
    rp, rs = jax.tree.map(jnp.asarray, p0), None
    rs = RO.init(rp)
    p = O.tree_map(lambda x: torch.from_numpy(x.copy()), p0)
    s = O.init(p)
    for i, mult in enumerate((1.0, 50.0, 0.01)):
        g = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * mult)
                         .astype(np.float32), p0)
        rp, rs = RO.update(rcfg, jax.tree.map(jnp.asarray, g), rs, rp)
        p, s = O.update(cfg, O.tree_map(torch.from_numpy, g), s, p)
        assert s.step == int(rs.step) == i + 1
        for got, exp in ((p, rp), (s.m, rs.m), (s.v, rs.v)):
            for a, b in zip(O.leaves(got), jax.tree.leaves(exp)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=OPT_RTOL, atol=1e-9)
    for step in (0, 1, 2, 3, 5, 9):
        np.testing.assert_allclose(O.schedule(cfg, step), float(
            RO.schedule(rcfg, jnp.asarray(step))), rtol=OPT_RTOL)


def test_train_steps_match_reference_losses():
    """Three LM steps on qwen2's smoke config, the port's step against
    the reference's jitted one from the same weights and batches: the
    losses agree (parameters are not compared: AdamW's first steps move
    by lr x sign(g), which amplifies rounding in tiny gradients)."""
    rcfg, rp, cfg, _ = _setup("qwen2_0_5b")
    p = from_reference(jax.tree.map(np.asarray, rp), cfg, "cpu")
    ocfg = O.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=3)
    rstep = jax.jit(RT.make_train_step(rcfg, RO.AdamWConfig(
        **dataclasses.asdict(ocfg))))
    step = T.make_train_step(cfg, ocfg)
    rs, s = RO.init(rp), O.init(p)
    stream = D.lm_batches(cfg.vocab_size, BATCH, SEQ, seed=0)
    for _, (toks, labels) in zip(range(3), stream):
        rp, rs, exp = rstep(rp, rs, _j(toks), _j(labels))
        p, s, got = step(p, s, toks, labels)
        np.testing.assert_allclose(float(got), float(exp), rtol=LOSS_RTOL)


# -- data and the predictor ------------------------------------------------
def test_data_pipelines_match_reference():
    for got, exp in zip(
            (x for _, x in zip(range(3), D.lm_batches(300, 3, 9, seed=7))),
            (x for _, x in zip(range(3), RD.lm_batches(300, 3, 9, seed=7)))):
        for a, b in zip(got, exp):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    kw = dict(vocab=512, max_prompt=64, granularity=100, n_classes=8,
              seed=3)
    got, exp = D.predictor_dataset(50, **kw), RD.predictor_dataset(50, **kw)
    for a, b in zip(got, exp):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    it, rit = D.batched(got, 8, seed=2), RD.batched(exp, 8, seed=2)
    for _ in range(9):                        # into the second epoch
        for a, b in zip(next(it), next(rit)):
            np.testing.assert_array_equal(a, b)


def test_model_predictor_matches_reference():
    from repro.core.predictor import ModelPredictor as RefPredictor
    from repro_torch.core.predictor import ModelPredictor
    rcfg, rp, cfg, p = _setup("opt_125m_cls")
    toks, lens, labels = D.predictor_dataset(
        12, vocab=cfg.vocab_size, max_prompt=40, n_classes=cfg.n_classes,
        seed=4)
    prompts = [t[:n] for t, n in zip(toks, lens)]
    ref, port = (RefPredictor(rcfg, rp, granularity=100, max_len=24),
                 ModelPredictor(cfg, p, granularity=100, max_len=24))
    for pr in prompts:
        assert port.predict_range(pr) == ref.predict_range(pr)
    decode = [int(x) * 100 + 7 for x in labels]
    assert port.batch_accuracy(prompts, decode) == ref.batch_accuracy(
        prompts, decode)


# -- the two faults repaired in this slice -----------------------------------
def test_classifier_head_in_init_bridge_and_count():
    """``init_params`` makes ``cls_head`` (d, n_classes),
    ``from_reference`` carries the reference's, and ``param_count``
    counts it as a leaf of ``init_params``."""
    rcfg, rp, cfg, p = _setup("opt_125m_cls")
    np.testing.assert_array_equal(p["cls_head"].detach().numpy(),
                                  np.asarray(rp["cls_head"]))
    own = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert own["cls_head"].shape == (cfg.d_model, cfg.n_classes)
    assert M.param_count(cfg) == sum(t.numel() for t in O.leaves(own)) \
        == RM.param_count(rcfg)


def test_apply_block_train_returns_the_moe_aux():
    """A routed DeepSeek-V2 layer in train mode: (x, None, aux), both
    equal to the reference's; prefill and decode return the aux too."""
    rcfg, rp, cfg, p = _setup("deepseek_v2_236b")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((BATCH, SEQ, cfg.d_model)).astype(np.float32)
    layer = len(cfg.prefix)                  # the first routed layer
    rlayer = jax.tree.map(lambda a: a[0], rp["body"][0])
    ro, _, raux = jax.jit(lambda lp, x: RB.apply_block(
        "attn", lp, rcfg, x, mode="train"))(rlayer, jnp.asarray(x))
    with torch.no_grad():
        out, cache, aux = B.apply_block("attn", p["layers"][layer], cfg,
                                        _t(x), mode="train")
    assert cache is None
    np.testing.assert_allclose(out.numpy(), np.asarray(ro), rtol=0,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(raux), rtol=LOSS_RTOL)
    assert float(aux) > 0


def test_run_layers_sums_the_aux_in_train_mode_only():
    """DeepSeek-V2's routed layers: ``_run_layers`` returns the summed
    MoE aux in train mode and None in prefill and decode, where the
    served paths run no operation for it."""
    _, _, cfg, p = _setup("deepseek_v2_236b")
    rng = np.random.default_rng(7)
    h = _t(rng.standard_normal((BATCH, SEQ, cfg.d_model))
           .astype(np.float32))
    cache = M.init_cache(cfg, BATCH, SEQ + 1, device="cpu")
    with torch.no_grad():
        _, _, aux = M._run_layers(p, cfg, h, mode="train")
        _, cache, pre = M._run_layers(p, cfg, h, mode="prefill",
                                      caches=cache)
        _, _, dec = M._run_layers(p, cfg, h[:, -1:], mode="decode",
                                  caches=cache,
                                  pos=torch.full((BATCH,), SEQ))
    assert aux.dtype == torch.float32 and aux.dim() == 0 and float(aux) > 0
    assert pre is None and dec is None


# -- the launcher ------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_launch_train_runs_every_arch_on_cpu(arch):
    """``python -m repro_torch.launch.train --arch <arch> --device cpu``:
    the smoke config trains a few steps with finite losses."""
    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(["--arch", arch, "--device", "cpu", "--steps", "3",
                    "--batch", "2", "--seq", "16"])
    lines = buf.getvalue().splitlines()
    losses = [float(ln.split("loss=")[1]) for ln in lines if "loss=" in ln]
    assert losses and all(np.isfinite(losses)), lines
    assert lines[-1].startswith("done: 3 steps")
    assert np.isfinite(float(lines[-1].rsplit(" ", 1)[1]))
