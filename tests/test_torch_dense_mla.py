"""The port's dense MLA (DeepSeek-V2's multi-head latent attention on
the dense backend) against the JAX package's: ``mla_prefill`` (the
latent written in place, decompressed and attended through kernel 5's
plain version), ``mla_decode``, the slot-batched decode
(``blocks._mla_decode_batched``), ``apply_block`` in both modes, the
model's dense entry points, the engines with ``backend="dense"`` and
the coupled baseline; and, as the reference's own tests
(tests/test_paged_path.py:345 and :375), the port's paged latent path
against its dense one.

CPU, f32, on the DeepSeek-V2 smoke config, weights drawn by the
reference and brought across with ``from_reference``; inputs from numpy
with a seed.  Outputs and logits within 1e-5 of the reference's
(summation order only), caches within 1e-5 of the largest reference
magnitude, greedy tokens identical; the paged-vs-dense latent pages
within 1e-4, as the reference holds its own.
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
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.decode_engine import DecodeEngine  # noqa: E402
from repro_torch.core.prefill_engine import PrefillEngine  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.params import cache_from_reference, from_reference  # noqa: E402,E501
from repro_torch.runtime.baseline_vllm import CoupledEngine  # noqa: E402
from repro_torch.runtime.request import Request  # noqa: E402

OUT_TOL = 1e-5        # outputs and logits
STATE_TOL = 1e-5      # caches, of the largest reference magnitude
PARITY_TOL = 1e-4     # paged vs dense latent pages (the reference's)
PAGE = 4
KW = dict(max_seq=64, page_size=PAGE, n_pages=128)


@pytest.fixture(scope="module")
def ds():
    cfg = dataclasses.replace(get_smoke_config("deepseek_v2_236b"),
                              dtype="float32")
    ref_params = RM.init_params(jax.random.PRNGKey(0), cfg)
    params = from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                            "cpu")
    return cfg, ref_params, params


def _layers(ref_params, params):
    """(reference layer, port layer) pairs: the smoke config's two
    routed layers, the reference's stacked body's repeats 0 and 1."""
    return [(jax.tree.map(lambda a, r=r: a[r], ref_params["body"][0]),
             params["layers"][r]) for r in (0, 1)]


def _close(ref, got, tol=OUT_TOL):
    err = float(np.abs(np.asarray(ref) - got.numpy()).max())
    assert err < tol, err


def _latent(cfg, rng, b, s):
    m = cfg.mla
    return {"ckv": rng.standard_normal((b, s, m.kv_lora_rank)),
            "krope": rng.standard_normal((b, s, m.qk_rope_head_dim))}


def _pair_cache(c):
    """The same cache dict as jnp arrays and as torch tensors (f32)."""
    return ({k: jnp.asarray(v, jnp.float32) for k, v in c.items()},
            {k: torch.from_numpy(v.astype(np.float32)) for k, v in c.items()})


def _cache_close(ref, got):
    for k, t in got.items():
        r = np.asarray(ref[k])
        err = float(np.abs(r - t.numpy()).max())
        assert err <= STATE_TOL * max(1.0, float(np.abs(r).max())), (k, err)


def test_kernel_scale_is_mla_scale():
    """Kernel 5 scales by its K width to the -1/2; the decompressed K is
    nope ++ RoPE wide, so that is MLA's (qk_nope + qk_rope) ** -0.5:
    192 ** -0.5 at DeepSeek-V2's published widths."""
    for cfg in (get_smoke_config("deepseek_v2_236b"),
                get_config("deepseek_v2_236b")):
        m = cfg.mla
        hd_k = m.qk_nope_head_dim + m.qk_rope_head_dim
        assert A.mla_scale(cfg) == hd_k ** -0.5
    assert get_config("deepseek_v2_236b").mla.qk_nope_head_dim + \
        get_config("deepseek_v2_236b").mla.qk_rope_head_dim == 192


@pytest.mark.parametrize("q_offset,window", [(0, 0), (8, 0), (20, 0),
                                             (20, 6)])
def test_mla_prefill_matches_reference(ds, q_offset, window):
    """A chunk of 8 at q_offset over a latent cache of 32 whose earlier
    positions hold what previous chunks wrote (random here): the output
    and both latent leaves, the chunk's rows written in place."""
    cfg, ref_params, params = ds
    rng = np.random.default_rng(10 + q_offset + window)
    rp, p = _layers(ref_params, params)[0]
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    rc, c = _pair_cache(_latent(cfg, rng, 2, 32))
    ro, rc = RA.mla_prefill(rp["attn"], cfg, jnp.asarray(x), rc,
                            q_offset=q_offset, window=window)
    out, c2 = A.mla_prefill(p["attn"], cfg, torch.from_numpy(x), c,
                            q_offset=q_offset, window=window)
    assert c2 is c and out.shape == (2, 8, cfg.d_model)
    _close(ro, out)
    _cache_close(rc, c)


@pytest.mark.parametrize("window", [0, 5])
def test_mla_decode_matches_reference(ds, window):
    """One-token decode at a shared position, and the slot-batched form
    at ragged positions (one past the cache's end, which both clamp)."""
    cfg, ref_params, params = ds
    rng = np.random.default_rng(20 + window)
    rp, p = _layers(ref_params, params)[1]
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    lat = _latent(cfg, rng, 3, 24)
    rc, c = _pair_cache(lat)
    ro, rc = RA.mla_decode(rp["attn"], cfg, jnp.asarray(x), rc, 17,
                           window=window)
    out, _ = A.mla_decode(p["attn"], cfg, torch.from_numpy(x), c, 17,
                          window=window)
    _close(ro, out)
    _cache_close(rc, c)
    pos = np.array([3, 23, 11], np.int32)
    rc, c = _pair_cache(lat)
    ro, rc = RB._mla_decode_batched(rp["attn"], cfg, jnp.asarray(x), rc,
                                    jnp.asarray(pos), window)
    out, _ = B._mla_decode_batched(p["attn"], cfg, torch.from_numpy(x), c,
                                   torch.from_numpy(pos), window)
    _close(ro, out)
    _cache_close(rc, c)


def test_apply_block_mla_matches_reference(ds):
    """A layer (MLA with a routed MoE) through ``apply_block``: a
    prefill chunk at 8 over an earlier one's latent, then a decode step
    at ragged positions; block outputs and latent caches."""
    cfg, ref_params, params = ds
    rng = np.random.default_rng(30)
    rp, p = _layers(ref_params, params)[0]
    rc, c = _pair_cache(_latent(cfg, rng, 2, 24))
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    ro, rc, raux = RB.apply_block("attn", rp, cfg, jnp.asarray(x),
                                  mode="prefill", cache=rc, q_offset=8)
    out, c, aux = B.apply_block("attn", p, cfg, torch.from_numpy(x),
                                mode="prefill", cache=c, q_offset=8)
    _close(ro, out)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    pos = np.array([16, 9], np.int32)
    ro, rc, raux = RB.apply_block("attn", rp, cfg, jnp.asarray(x),
                                  mode="decode", cache=rc,
                                  pos=jnp.asarray(pos))
    out, c, aux = B.apply_block("attn", p, cfg, torch.from_numpy(x),
                                mode="decode", cache=c,
                                pos=torch.from_numpy(pos))
    _close(ro, out)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)
    _cache_close(rc, c)


def _caches_close(cfg, ref_cache, cache):
    ref = cache_from_reference(jax.tree.map(np.asarray, ref_cache), cfg,
                               "cpu")
    assert len(ref) == len(cache) == cfg.n_layers
    for a, b in zip(ref, cache):
        assert set(a) == set(b) == {"ckv", "krope"}
        _cache_close({k: v.numpy() for k, v in a.items()}, b)


def test_model_prefill_and_decode_match_reference(ds):
    """``prefill`` in two chunks, ``prefill_chunked``, then a slot
    decode step after ``cache_select`` / ``cache_insert`` (empty slots
    beside it): logits, greedy tokens and every latent leaf."""
    cfg, ref_params, params = ds
    toks = np.random.default_rng(40).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    rc, c = RM.init_cache(cfg, 2, 24), M.init_cache(cfg, 2, 24, device="cpu")
    for lo, hi in ((0, 8), (8, 16)):
        lr, rc = RM.prefill(ref_params, cfg, jnp.asarray(toks[:, lo:hi]),
                            rc, q_offset=lo)
        lg, c = M.prefill(params, cfg, torch.from_numpy(toks[:, lo:hi]), c,
                          q_offset=lo)
        _close(lr, lg)
    _caches_close(cfg, rc, c)
    lr, rc2 = RM.prefill_chunked(ref_params, cfg, jnp.asarray(toks),
                                 RM.init_cache(cfg, 2, 24), chunk_size=8)
    lg, c2 = M.prefill_chunked(params, cfg, torch.from_numpy(toks),
                               M.init_cache(cfg, 2, 24, device="cpu"),
                               chunk_size=8)
    _close(lr, lg)
    _caches_close(cfg, rc2, c2)
    slots_r = RM.cache_insert(RM.init_cache(cfg, 3, 24),
                              RM.cache_select(rc, 1), 2)
    slots = M.cache_insert(M.init_cache(cfg, 3, 24, device="cpu"),
                           M.cache_select(c, 1), 2)
    last = np.array([[0], [0], [int(jnp.argmax(lr[1, -1]))]], np.int32)
    pos = np.array([0, 0, 16], np.int32)
    nr, slots_r = RM.decode_step_greedy(ref_params, cfg, jnp.asarray(last),
                                        slots_r, jnp.asarray(pos))
    nxt, slots = M.decode_step_greedy(params, cfg, torch.from_numpy(last),
                                      slots, torch.from_numpy(pos))
    assert nxt.tolist() == np.asarray(nr).tolist()
    _caches_close(cfg, slots_r, slots)


# -- the engines -----------------------------------------------------------
def _port_requests(ref_reqs):
    return [Request(rid=r.rid, prompt_len=r.prompt_len,
                    decode_len=r.decode_len, arrival=r.arrival,
                    prompt_tokens=r.prompt_tokens) for r in ref_reqs]


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
def served(ds):
    """One workload served three ways: the reference's engines and the
    port's on the dense backend, and the port's on the paged one."""
    cfg, ref_params, params = ds
    reqs = generate("Mixed", 4, seed=32, max_prompt=30, max_decode=6,
                    vocab_size=cfg.vocab_size)
    runs = {}
    for name, mk_p, mk_d, rs in (
            ("ref", RefPrefill, RefDecode, copy.deepcopy(reqs)),
            ("dense", PrefillEngine, DecodeEngine, _port_requests(reqs)),
            ("paged", PrefillEngine, DecodeEngine, _port_requests(reqs))):
        backend = "paged" if name == "paged" else "dense"
        kw = dict(KW, backend=backend)
        if name != "ref":
            kw["device"] = "cpu"
        p_args = (ref_params if name == "ref" else params)
        pe = mk_p("p", cfg, p_args, chunk_size=8, **kw)
        de = mk_d("d", cfg, p_args, max_slots=4, **kw)
        runs[name] = (*_round_trip(pe, de, rs), pe, de)
    return runs


def test_dense_engines_match_reference(ds, served):
    """Port dense = reference dense: tokens, first tokens, wire bytes,
    enc_len (0: no cross layer), chunk steps and every payload leaf."""
    cfg = ds[0]
    out_r, pay_r, pe_r, de_r = served["ref"]
    out, pay, pe, de = served["dense"]
    assert len(out) == 4 and out == out_r
    assert pe.network.bytes_sent == pe_r.network.bytes_sent > 0
    assert (pe.chunk_steps, de.iterations) == (pe_r.chunk_steps,
                                               de_r.iterations)
    for rid, pk_r in pay_r.items():
        pk = pay[rid]
        assert (pk.first_token, pk.enc_len, pk.kv_len) == (
            pk_r.first_token, pk_r.enc_len, pk_r.kv_len)
        _caches_close(cfg, pk_r.cache, pk.cache)
    assert de.alloc.used_pages == 0 and not pe._caches


def test_mla_prefill_parity_logits_and_pool(ds, served):
    """Mirrors tests/test_paged_path.py:345 on the port: the paged
    latent prefill and the dense one give the same first tokens, and the
    latent pages hold the (ckv, krope) the dense cache holds."""
    cfg = ds[0]
    m = cfg.mla
    pay_p, pay_d = served["paged"][1], served["dense"][1]
    assert len(pay_p) == len(pay_d) == 4
    for rid, pkp in pay_p.items():
        pkd = pay_d[rid]
        assert pkp.first_token == pkd.first_token
        n = pkp.req.prompt_len
        ckv = pkp.pages_k.reshape(cfg.n_layers, -1, m.kv_lora_rank)[:, :n]
        kr = pkp.pages_v.reshape(cfg.n_layers, -1,
                                 m.qk_rope_head_dim)[:, :n]
        ckv_d = torch.stack([layer["ckv"][0, :n] for layer in pkd.cache])
        kr_d = torch.stack([layer["krope"][0, :n] for layer in pkd.cache])
        assert float((ckv - ckv_d).abs().max()) < PARITY_TOL
        assert float((kr - kr_d).abs().max()) < PARITY_TOL


def test_mla_roundtrip_paged_vs_dense(served):
    """Mirrors tests/test_paged_path.py:375 on the port: the latent
    pages with kernel 3's plain version give the dense absorbed
    decode's tokens; every page back on the free list."""
    out_p, _, pe, de = served["paged"]
    assert len(out_p) == 4 and out_p == served["dense"][0]
    assert pe.alloc.used_pages == 0 and de.alloc.used_pages == 0


def test_coupled_matches_reference(ds):
    """``CoupledEngine`` on the DeepSeek-V2 smoke: the reference's
    tokens and iterations."""
    cfg, ref_params, params = ds
    reqs = generate("Mixed", 3, seed=33, max_prompt=24, max_decode=5,
                    vocab_size=cfg.vocab_size)
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
