"""The port's dense cross-attention (Whisper's encoder-decoder and
Llama-3.2-Vision's image layers on the dense backend) against the JAX
package's: ``cross_forward`` through kernel 5's plain version
(non-causal, more queries than encoder keys included) on a first chunk
with the unrounded f32 cross K/V, a later chunk and a decode step,
``apply_block``'s CROSS_ATTN branch in both modes, the model's dense
entry points with ``enc_embeds`` (Whisper's encoder stack, the VLM's
passthrough), the engines with ``backend="dense"`` and the coupled
baseline; and, as the reference's own tests
(tests/test_paged_cross.py:163 and :198), the port's cross pages
against its dense cross caches.

CPU, f32 (one bf16 case for the first chunk's dtypes), on the smoke
configs, weights drawn by the reference and brought across with
``from_reference``; inputs from numpy with a seed.  Outputs and logits
within 1e-5 of the reference's (summation order only), caches within
1e-5 of the largest reference magnitude, greedy tokens identical; the
paged-vs-dense K/V and cross K/V within 1e-4, as the reference holds
its own.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.decode_engine import DecodeEngine as RefDecode  # noqa: E402
from repro.core.prefill_engine import PrefillEngine as RefPrefill  # noqa: E402,E501
from repro.models import attention as RA  # noqa: E402
from repro.models import blocks as RB  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.runtime.baseline_vllm import CoupledEngine as RefCoupled  # noqa: E402,E501
from repro.runtime.workload import generate  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.decode_engine import DecodeEngine  # noqa: E402
from repro_torch.core.prefill_engine import PrefillEngine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.chunked_prefill_attention import (  # noqa: E402
    chunked_prefill_attention)
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.params import cache_from_reference, from_reference  # noqa: E402,E501
from repro_torch.runtime.baseline_vllm import CoupledEngine  # noqa: E402
from repro_torch.runtime.request import Request  # noqa: E402

OUT_TOL = 1e-5        # outputs and logits
STATE_TOL = 1e-5      # caches, of the largest reference magnitude
PARITY_TOL = 1e-4     # paged vs dense K/V (the reference's)
PAGE = 4
KW = dict(max_seq=64, page_size=PAGE, n_pages=128)
ARCHS = ("whisper_tiny", "llama_3_2_vision_11b")


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    cfg = dataclasses.replace(get_smoke_config(request.param),
                              dtype="float32")
    ref_params = RM.init_params(jax.random.PRNGKey(1), cfg)
    params = from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                            "cpu")
    return cfg, ref_params, params


def _cross_layer(cfg, ref_params, params):
    """(reference layer, port layer, absolute id) of the first CROSS_ATTN
    layer; the smoke configs stack their layers in the body."""
    i = cfg.layer_kinds.index("cross_attn")
    j, r = i % len(cfg.pattern), i // len(cfg.pattern)
    return (jax.tree.map(lambda a: a[r], ref_params["body"][j]),
            params["layers"][i], i)


def _close(ref, got, tol=OUT_TOL):
    err = float(np.abs(np.asarray(ref, np.float32)
                       - got.float().numpy()).max())
    assert err < tol, err


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_noncausal_read_with_more_queries_than_keys():
    """Kernel 5's wrapper on the CPU, non-causal: 40 decoder queries
    over 16 encoder keys (sq > skv), rep 2, against the reference's
    ``flash_attn``; a causal call of that shape is refused."""
    rng = np.random.default_rng(0)
    q, k, v = _rand(rng, 2, 40, 4, 32), _rand(rng, 2, 16, 2, 32), \
        _rand(rng, 2, 16, 2, 32)
    exp = RA.flash_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=False, kv_len=16)
    lens = torch.full((2,), 16, dtype=torch.int32)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    _close(exp, ops.prefill_attention(*t, lens, 0, causal=False))
    with pytest.raises(ValueError, match="outside a cache"):
        chunked_prefill_attention(*t, lens, 0)


def test_cross_forward_matches_reference(setup):
    """The cross sublayer on a first chunk (f32 encoder output projected
    to unrounded cross K/V, 24 queries over the 16 encoder tokens), a
    later chunk and a decode step of 3 slots over stored K/V."""
    cfg, ref_params, params = setup
    rp, p, _ = _cross_layer(cfg, ref_params, params)
    rng = np.random.default_rng(1)
    enc = _rand(rng, 2, cfg.cross_ctx, cfg.d_model)
    rk, rv = RA.cross_kv(rp["cross"], cfg, jnp.asarray(enc))
    k, v = A.cross_kv(p["cross"], cfg, torch.from_numpy(enc))
    _close(rk, k)
    _close(rv, v)
    for shape in ((2, 24), (2, 8)):
        x = _rand(rng, *shape, cfg.d_model)
        _close(RA.cross_forward(rp["cross"], cfg, jnp.asarray(x), rk, rv),
               A.cross_forward(p["cross"], cfg, torch.from_numpy(x), k, v))
    x = _rand(rng, 3, 1, cfg.d_model)
    ks, vs = (_rand(rng, 3, cfg.cross_ctx, cfg.n_kv_heads,
                    cfg.resolved_head_dim) for _ in range(2))
    _close(RA.cross_forward(rp["cross"], cfg, jnp.asarray(x),
                            jnp.asarray(ks), jnp.asarray(vs)),
           A.cross_forward(p["cross"], cfg, torch.from_numpy(x),
                           torch.from_numpy(ks), torch.from_numpy(vs)))


def test_cross_forward_bf16_first_chunk_attends_f32_kv(setup):
    """A bf16 model's first chunk: bf16 queries over the f32 cross K/V
    of the f32 encoder output, as the reference's ``flash_attn`` reads
    them (f32 sums, q's dtype out).  The port up-casts the queries and
    runs the f32 body; the output is bf16 and within one bf16 rounding
    (2^-7 of the largest) of the reference's."""
    cfg, ref_params, params = setup
    rp, p, _ = _cross_layer(cfg, ref_params, params)
    rpc = jax.tree.map(lambda a: a.astype(jnp.bfloat16), rp["cross"])
    pc = {k: t.to(torch.bfloat16) for k, t in p["cross"].items()}
    rng = np.random.default_rng(2)
    enc = _rand(rng, 1, cfg.cross_ctx, cfg.d_model)
    x = _rand(rng, 1, 8, cfg.d_model)
    rk, rv = RA.cross_kv(rpc, cfg, jnp.asarray(enc))
    k, v = A.cross_kv(pc, cfg, torch.from_numpy(enc))
    assert k.dtype == torch.float32 and rk.dtype == jnp.float32
    exp = RA.cross_forward(rpc, cfg, jnp.asarray(x, jnp.bfloat16), rk, rv)
    got = A.cross_forward(pc, cfg, torch.from_numpy(x).to(torch.bfloat16),
                          k, v)
    assert got.dtype == torch.bfloat16
    e = np.asarray(exp.astype(jnp.float32))
    _close(e, got, 2.0 ** -7 * float(np.abs(e).max()))


def test_apply_block_cross_matches_reference(setup):
    """The CROSS_ATTN block in both modes: a first prefill chunk with the
    encoder output (cross K/V projected and stored), then a decode step
    over the stored ones; block outputs and every leaf."""
    cfg, ref_params, params = setup
    rp, p, _ = _cross_layer(cfg, ref_params, params)
    rng = np.random.default_rng(3)
    rc = RB.init_block_cache("cross_attn", cfg, 2, 24, jnp.float32,
                             enc_ctx=cfg.cross_ctx)
    c = B.init_block_cache("cross_attn", cfg, 2, 24, torch.float32, "cpu",
                           enc_ctx=cfg.cross_ctx)
    enc = _rand(rng, 2, cfg.cross_ctx, cfg.d_model)
    x = _rand(rng, 2, 8, cfg.d_model)
    ro, rc, _ = RB.apply_block("cross_attn", rp, cfg, jnp.asarray(x),
                               mode="prefill", cache=rc, q_offset=0,
                               enc=jnp.asarray(enc))
    out, c, _ = B.apply_block("cross_attn", p, cfg,
                              torch.from_numpy(x), mode="prefill",
                              cache=c, q_offset=0,
                              enc=torch.from_numpy(enc))
    _close(ro, out)
    x = _rand(rng, 2, 1, cfg.d_model)
    pos = np.array([8, 5], np.int32)
    ro, rc, _ = RB.apply_block("cross_attn", rp, cfg, jnp.asarray(x),
                               mode="decode", cache=rc,
                               pos=jnp.asarray(pos))
    out, c, _ = B.apply_block("cross_attn", p, cfg,
                              torch.from_numpy(x), mode="decode",
                              cache=c, pos=torch.from_numpy(pos))
    _close(ro, out)
    assert set(c) == set(rc) == {"k", "v", "ck", "cv"}
    for key in c:
        _close(rc[key], c[key], STATE_TOL * max(
            1.0, float(np.abs(np.asarray(rc[key])).max())))


def _caches_close(cfg, ref_cache, cache):
    ref = cache_from_reference(jax.tree.map(np.asarray, ref_cache), cfg,
                               "cpu")
    assert len(ref) == len(cache) == cfg.n_layers
    for kind, a, b in zip(cfg.layer_kinds, ref, cache):
        want = {"k", "v"} | ({"ck", "cv"} if kind == "cross_attn" else set())
        assert set(a) == set(b) == want
        for key in a:
            err = float((a[key] - b[key]).abs().max())
            assert err <= STATE_TOL * max(1.0, float(a[key].abs().max())), \
                (kind, key, err)


def test_model_prefill_with_encoder_matches_reference(setup):
    """``prefill`` (a first chunk of 24 with the frontend embeddings,
    then one of 8 without), ``prefill_chunked`` with them, and a slot
    decode step: logits, greedy tokens and every leaf, the cross K/V
    through Whisper's encoder stack or the VLM's passthrough."""
    cfg, ref_params, params = setup
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    enc = _rand(rng, 2, cfg.cross_ctx, cfg.d_model)
    rc, c = RM.init_cache(cfg, 2, 40), M.init_cache(cfg, 2, 40, device="cpu")
    for lo, hi, e in ((0, 24, enc), (24, 32, None)):
        lr, rc = RM.prefill(ref_params, cfg, jnp.asarray(toks[:, lo:hi]),
                            rc, q_offset=lo,
                            enc_embeds=None if e is None else jnp.asarray(e))
        lg, c = M.prefill(params, cfg, torch.from_numpy(toks[:, lo:hi]), c,
                          q_offset=lo,
                          enc_embeds=None if e is None
                          else torch.from_numpy(e))
        _close(lr, lg)
    _caches_close(cfg, rc, c)
    lr, rc2 = RM.prefill_chunked(ref_params, cfg, jnp.asarray(toks),
                                 RM.init_cache(cfg, 2, 40), chunk_size=16,
                                 enc_embeds=jnp.asarray(enc))
    lg, c2 = M.prefill_chunked(params, cfg, torch.from_numpy(toks),
                               M.init_cache(cfg, 2, 40, device="cpu"),
                               chunk_size=16,
                               enc_embeds=torch.from_numpy(enc))
    _close(lr, lg)
    _caches_close(cfg, rc2, c2)
    last = np.argmax(np.asarray(lr[:, -1]), -1).astype(np.int32)[:, None]
    pos = np.array([32, 32], np.int32)
    nr, rc2 = RM.decode_step_greedy(ref_params, cfg, jnp.asarray(last), rc2,
                                    jnp.asarray(pos))
    nxt, c2 = M.decode_step_greedy(params, cfg, torch.from_numpy(last), c2,
                                   torch.from_numpy(pos))
    assert nxt.tolist() == np.asarray(nr).tolist()
    _caches_close(cfg, rc2, c2)


# -- the engines -----------------------------------------------------------
def _port_requests(ref_reqs):
    return [Request(rid=r.rid, prompt_len=r.prompt_len,
                    decode_len=r.decode_len, arrival=r.arrival,
                    prompt_tokens=r.prompt_tokens,
                    enc_embeds=r.enc_embeds) for r in ref_reqs]


def _round_trip(pe, de, reqs):
    """Serve ``reqs`` through a prefill -> decode engine pair; returns
    (tokens by rid, payloads by rid)."""
    for r in reqs:
        pe.submit(r)
    out, payloads, t = {}, {}, 0.0
    for _ in range(2000):
        for pk in pe.step(t):
            payloads[pk.req.rid] = pk
            de.receive(pk)
        de.admit(t)
        for f in de.step(t):
            out[f.req.rid] = f.tokens
        t += 0.01
        if pe.idle() and de.idle():
            break
    return out, payloads


@pytest.fixture(scope="module")
def served(setup):
    """One workload with frontend embeddings served three ways: the
    reference's engines and the port's on the dense backend, and the
    port's on the paged one."""
    cfg, ref_params, params = setup
    reqs = generate("Mixed", 4, seed=42, max_prompt=30, max_decode=6,
                    vocab_size=cfg.vocab_size, enc_ctx=cfg.cross_ctx,
                    enc_dim=cfg.d_model)
    runs = {}
    for name, mk_p, mk_d, rs in (
            ("ref", RefPrefill, RefDecode, copy.deepcopy(reqs)),
            ("dense", PrefillEngine, DecodeEngine, _port_requests(reqs)),
            ("paged", PrefillEngine, DecodeEngine, _port_requests(reqs))):
        kw = dict(KW, backend="paged" if name == "paged" else "dense")
        if name != "ref":
            kw["device"] = "cpu"
        p_args = ref_params if name == "ref" else params
        pe = mk_p("p", cfg, p_args, chunk_size=8, **kw)
        de = mk_d("d", cfg, p_args, max_slots=4, **kw)
        runs[name] = (*_round_trip(pe, de, rs), pe, de)
    return runs


def test_dense_engines_match_reference(setup, served):
    """Port dense = reference dense: tokens, first tokens, wire bytes
    (the cross K/V counted through ``enc_len``), enc_len, chunk steps
    and every payload leaf."""
    cfg = setup[0]
    out_r, pay_r, pe_r, de_r = served["ref"]
    out, pay, pe, de = served["dense"]
    assert pe.spec.cross == "dense" and pe.enc_ctx == cfg.cross_ctx
    assert len(out) == 4 and out == out_r
    assert pe.network.bytes_sent == pe_r.network.bytes_sent > 0
    assert (pe.chunk_steps, de.iterations) == (pe_r.chunk_steps,
                                               de_r.iterations)
    for rid, pk_r in pay_r.items():
        pk = pay[rid]
        assert (pk.first_token, pk.enc_len, pk.kv_len) == (
            pk_r.first_token, pk_r.enc_len, pk_r.kv_len)
        assert pk.enc_len == cfg.cross_ctx
        _caches_close(cfg, pk_r.cache, pk.cache)
    assert de.alloc.used_pages == 0 and not pe._caches


def test_cross_prefill_parity_tokens_and_pool(setup, served):
    """Mirrors tests/test_paged_cross.py:163 on the port: the paged and
    the dense prefill give the same first tokens, and the shipped pages
    hold the self K/V and the cross K/V the dense cache holds."""
    cfg = setup[0]
    kvh, hd, ec = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.cross_ctx
    pay_p, pay_d = served["paged"][1], served["dense"][1]
    assert len(pay_p) == len(pay_d) == 4
    for rid, pkp in pay_p.items():
        pkd = pay_d[rid]
        assert pkp.first_token == pkd.first_token
        assert pkp.enc_len == pkd.enc_len == ec
        n = pkp.req.prompt_len
        kp = pkp.pages_k.reshape(cfg.n_layers, -1, kvh, hd)
        ck = pkp.cross_k.reshape(cfg.n_layers, -1, kvh, hd)
        cv = pkp.cross_v.reshape(cfg.n_layers, -1, kvh, hd)
        for i, (kind, layer) in enumerate(zip(cfg.layer_kinds, pkd.cache)):
            assert float((kp[i, :n] - layer["k"][0, :n]).abs().max()) \
                < PARITY_TOL
            if kind == "cross_attn":
                assert float((ck[i, :ec] - layer["ck"][0]).abs().max()) \
                    < PARITY_TOL
                assert float((cv[i, :ec] - layer["cv"][0]).abs().max()) \
                    < PARITY_TOL


def test_cross_roundtrip_paged_vs_dense(served):
    """Mirrors tests/test_paged_cross.py:198 on the port: the cross
    pages give the dense cross caches' tokens, and every page (self and
    cross) is back on the free list."""
    out_p, _, pe, de = served["paged"]
    assert len(out_p) == 4 and out_p == served["dense"][0]
    assert pe.alloc.used_pages == 0 and de.alloc.used_pages == 0


def test_coupled_matches_reference_on_whisper():
    """``CoupledEngine`` on the Whisper smoke (no frontend embeddings:
    the cross caches stay zeros, as in the reference), prompts up to 24
    tokens over 16 encoder positions: the reference's tokens and
    iterations."""
    cfg = dataclasses.replace(get_smoke_config("whisper_tiny"),
                              dtype="float32")
    ref_params = RM.init_params(jax.random.PRNGKey(2), cfg)
    params = from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                            "cpu")
    reqs = generate("Mixed", 3, seed=34, max_prompt=24, max_decode=5,
                    vocab_size=cfg.vocab_size)
    assert max(r.prompt_len for r in reqs) > cfg.cross_ctx
    kw = dict(max_slots=4, max_seq=48, prefill_batch=2)
    outs = []
    for eng, rs in ((RefCoupled(cfg, ref_params, **kw), copy.deepcopy(reqs)),
                    (CoupledEngine(cfg, params, device="cpu", **kw),
                     _port_requests(reqs))):
        for r in rs:
            eng.submit(r)
        out, t = {}, 0.0
        while not eng.done():
            for f in eng.step(t):
                out[f.req.rid] = f.tokens
            t += 0.01
        outs.append((out, eng.iterations, eng.prefill_iterations))
    assert len(outs[1][0]) == 3 and outs[1] == outs[0]
