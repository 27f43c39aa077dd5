"""The port's dense backend against the JAX package's: the model's dense
entry points (``prefill``, ``prefill_chunked``, ``decode_step``,
``decode_step_greedy``, ``cache_insert`` / ``cache_select``) and the
engines' dense branches, for the qwen2 smoke config (also with a
sliding window), RecurrentGemma (RG-LRU + local attention) and xLSTM
(sLSTM / mLSTM), on the same weights (``from_reference``) with caches
compared leaf by leaf through ``cache_from_reference``.  Also ports of
the reference's model tests (chunked prefill = single, constant
recurrent state, prefill then decode) and of its paged-vs-dense
parities (``tests/test_paged_path.py``).

Everything runs on the CPU in f32 (the smoke configs' own bf16 only in
the prefill-then-decode case): the JAX side with its Pallas kernels in
interpret mode, the port with its kernels' plain versions (kernel 5's
for the dense prefill).  f32 differs by summation order only: logits
within 1e-4, caches and states within 1e-5 of the largest reference
magnitude, greedy tokens identical.
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
from repro.models import model as RM  # noqa: E402
from repro.runtime.workload import generate  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.backend import backend_for  # noqa: E402
from repro_torch.core.decode_engine import DecodeEngine  # noqa: E402
from repro_torch.core.prefill_engine import PrefillEngine  # noqa: E402
from repro_torch.kvcache.paged import PagePool  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.params import cache_from_reference, from_reference  # noqa: E402,E501
from repro_torch.runtime.request import Request  # noqa: E402

LOGIT_TOL = 1e-4
STATE_TOL = 1e-5      # of the largest reference magnitude
PAGE = 4


def _cfg(name):
    arch = "qwen2_0_5b" if name == "window" else name
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    if name == "window":
        cfg = dataclasses.replace(cfg, sliding_window=6)
    return cfg


CONFIGS = ("qwen2_0_5b", "window", "recurrentgemma_9b", "xlstm_1_3b")


@pytest.fixture(scope="module", params=CONFIGS)
def setup(request):
    cfg = _cfg(request.param)
    ref_params = RM.init_params(jax.random.PRNGKey(0), cfg)
    params = from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                            "cpu")
    return cfg, ref_params, params


def _toks(cfg, seed, *shape):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _logits_close(ref, got):
    err = np.abs(np.asarray(ref) - got.numpy()).max()
    assert err < LOGIT_TOL, err


def _caches_close(cfg, ref_cache, cache):
    ref = cache_from_reference(jax.tree.map(np.asarray, ref_cache), cfg,
                               "cpu")
    assert len(ref) == len(cache) == cfg.n_layers
    for i, (a, b) in enumerate(zip(ref, cache)):
        assert set(a) == set(b), i
        for k in a:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
            err = float((a[k] - b[k]).abs().max())
            assert err <= STATE_TOL * max(1.0, float(a[k].abs().max())), \
                (i, k, err)


def test_prefill_chunks_match_reference(setup):
    """Two prefill calls (16 tokens at 0, 8 at 16): logits of each and
    the caches after both."""
    cfg, ref_params, params = setup
    toks = _toks(cfg, 1, 2, 24)
    rc = RM.init_cache(cfg, 2, 40)
    c = M.init_cache(cfg, 2, 40, device="cpu")
    for lo, hi in ((0, 16), (16, 24)):
        lr, rc = RM.prefill(ref_params, cfg, jnp.asarray(toks[:, lo:hi]),
                            rc, q_offset=lo)
        lg, c = M.prefill(params, cfg, torch.from_numpy(toks[:, lo:hi]), c,
                          q_offset=lo)
        assert lg.shape == (2, 1, cfg.vocab_size)
        _logits_close(lr, lg)
    _caches_close(cfg, rc, c)


def test_prefill_chunked_matches_reference(setup):
    cfg, ref_params, params = setup
    toks = _toks(cfg, 2, 2, 24)
    lr, rc = RM.prefill_chunked(ref_params, cfg, jnp.asarray(toks),
                                RM.init_cache(cfg, 2, 32), chunk_size=8)
    lg, c = M.prefill_chunked(params, cfg, torch.from_numpy(toks),
                              M.init_cache(cfg, 2, 32, device="cpu"),
                              chunk_size=8)
    _logits_close(lr, lg)
    _caches_close(cfg, rc, c)
    with pytest.raises(ValueError):
        M.prefill_chunked(params, cfg, torch.from_numpy(toks[:, :20]),
                          M.init_cache(cfg, 2, 32, device="cpu"),
                          chunk_size=8)


def test_slot_decode_matches_reference(setup):
    """Two prompts (10 and 7 tokens) prefilled alone, inserted into
    slots 0 and 2 of a 3-slot cache (slot 1 empty), then three
    slot-batch steps at ragged positions: ``decode_step`` logits,
    ``decode_step_greedy`` tokens, the caches, and ``cache_select``."""
    cfg, ref_params, params = setup
    slots, max_seq = 3, 32
    rc = RM.init_cache(cfg, slots, max_seq)
    c = M.init_cache(cfg, slots, max_seq, device="cpu")
    pos = np.zeros(slots, np.int32)
    last = np.zeros((slots, 1), np.int32)
    for slot, n in ((0, 10), (2, 7)):
        toks = _toks(cfg, 10 + n, 1, n)
        lr, sub_r = RM.prefill(ref_params, cfg, jnp.asarray(toks),
                               RM.init_cache(cfg, 1, max_seq))
        lg, sub = M.prefill(params, cfg, torch.from_numpy(toks),
                            M.init_cache(cfg, 1, max_seq, device="cpu"))
        rc = RM.cache_insert(rc, sub_r, slot)
        assert M.cache_insert(c, sub, slot) is c
        pos[slot] = n
        last[slot, 0] = int(torch.argmax(lg[0, -1]))
        assert last[slot, 0] == int(jnp.argmax(lr[0, -1]))
    _caches_close(cfg, rc, c)
    for _ in range(3):
        lr, rc_next = RM.decode_step(ref_params, cfg, jnp.asarray(last), rc,
                                     jnp.asarray(pos))
        nr, rc = RM.decode_step_greedy(ref_params, cfg, jnp.asarray(last),
                                       rc, jnp.asarray(pos))
        c_copy = [dict((k, v.clone()) for k, v in layer.items())
                  for layer in c]
        lg, _ = M.decode_step(params, cfg, torch.from_numpy(last), c_copy,
                              torch.from_numpy(pos))
        nxt, c = M.decode_step_greedy(params, cfg, torch.from_numpy(last), c,
                                      torch.from_numpy(pos))
        _logits_close(lr, lg)
        assert nxt.dtype == torch.int32
        assert nxt.tolist() == np.asarray(nr).tolist()
        last = nxt.numpy()[:, None].copy()
        pos = pos + 1
    _caches_close(cfg, rc, c)
    _caches_close(cfg, RM.cache_select(rc, 2), M.cache_select(c, 2))


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "recurrentgemma_9b",
                                  "xlstm_1_3b", "mistral_nemo_12b"])
def test_chunked_prefill_equals_single(arch):
    """Mirrors tests/test_models.py:21 on the dense-backend archs."""
    cfg = _cfg(arch)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(_toks(cfg, 1, 2, 16))
    lg, _ = M.prefill(params, cfg, toks, M.init_cache(cfg, 2, 32,
                                                      device="cpu"))
    lg2, _ = M.prefill_chunked(params, cfg, toks,
                               M.init_cache(cfg, 2, 32, device="cpu"),
                               chunk_size=8)
    assert float((lg - lg2).abs().max()) < 1e-3


def test_recurrent_state_constant_size():
    """Mirrors tests/test_models.py:106: xLSTM's cache does not grow
    with max_seq; RecurrentGemma's grows in its attention layers only."""
    def size(cfg, s):
        return sum(t.numel() for layer in M.init_cache(cfg, 1, s,
                                                       device="cpu")
                   for t in layer.values())
    x = _cfg("xlstm_1_3b")
    assert size(x, 16) == size(x, 4096)
    rg = _cfg("recurrentgemma_9b")
    n_attn = sum(k == "local_attn" for k in rg.layer_kinds)
    per_tok = 2 * rg.n_kv_heads * rg.resolved_head_dim * n_attn
    assert size(rg, 64) - size(rg, 16) == 48 * per_tok
    ring = M.init_cache(rg, 1, 4096, ring=True, device="cpu")
    for kind, layer in zip(rg.layer_kinds, ring):
        if kind == "local_attn":
            assert layer["k"].shape[1] == rg.local_window


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "recurrentgemma_9b",
                                  "xlstm_1_3b"])
def test_prefill_then_decode(arch):
    """Mirrors tests/test_arch_smoke.py:72 at the smoke config's own
    dtype: shapes, and no NaN."""
    cfg = get_smoke_config(arch)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b, s = 2, 8
    toks = torch.from_numpy(_toks(cfg, 4, b, s))
    cache = M.init_cache(cfg, b, 2 * s, device="cpu")
    logits, cache = M.prefill(params, cfg, toks, cache)
    assert logits.shape == (b, 1, cfg.vocab_size)
    nxt = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    dl, cache = M.decode_step(params, cfg, nxt, cache,
                              torch.full((b,), s, dtype=torch.int32))
    assert dl.shape == (b, 1, cfg.vocab_size)
    assert not torch.isnan(dl.float()).any()


# -- the engines ----------------------------------------------------------
KW = dict(max_seq=64, page_size=PAGE, n_pages=128)


def _port_requests(ref_reqs):
    return [Request(rid=r.rid, prompt_len=r.prompt_len,
                    decode_len=r.decode_len, arrival=r.arrival,
                    prompt_tokens=r.prompt_tokens) for r in ref_reqs]


def _drive(pe, de, reqs):
    for r in reqs:
        pe.submit(r)
    out, t = {}, 0.0
    for _ in range(2000):
        for pk in pe.step(t):
            de.receive(pk, now=t)
        de.admit(t)
        for f in de.step(t):
            out[f.req.rid] = f.tokens
        t += 0.01
        if pe.idle() and de.idle():
            break
    return out


def test_engine_round_trip_matches_reference(setup):
    """Both engine pairs with backend="dense" on the same requests: the
    same tokens, chunk steps, decode iterations and wire bytes; nothing
    held after."""
    cfg, ref_params, params = setup
    reqs = generate("Mixed", 4, seed=5, max_prompt=40, max_decode=6,
                    vocab_size=cfg.vocab_size)
    rpe = RefPrefill("p", cfg, ref_params, chunk_size=8, backend="dense",
                     **KW)
    rde = RefDecode("d", cfg, ref_params, max_slots=4, backend="dense",
                    **KW)
    pe = PrefillEngine("p", cfg, params, chunk_size=8, backend="dense",
                       device="cpu", **KW)
    de = DecodeEngine("d", cfg, params, max_slots=4, backend="dense",
                      device="cpu", **KW)
    assert pe.backend == de.backend == "dense"
    want = _drive(rpe, rde, copy.deepcopy(reqs))
    got = _drive(pe, de, _port_requests(reqs))
    assert len(got) == 4 and got == want
    assert (pe.chunk_steps, de.iterations) == (rpe.chunk_steps,
                                               rde.iterations)
    assert pe.network.bytes_sent == rpe.network.bytes_sent > 0
    assert de.alloc.used_pages == 0 and not pe._caches


def test_prefill_payload_matches_reference(setup):
    """A finished request's dense payload: first token and every cache
    leaf (the recurrent states and the K/V rows) against the
    reference's."""
    cfg, ref_params, params = setup
    reqs = generate("LPLD", 3, seed=6, max_prompt=30, max_decode=2,
                    vocab_size=cfg.vocab_size)
    rpe = RefPrefill("p", cfg, ref_params, chunk_size=8, backend="dense",
                     **KW)
    pe = PrefillEngine("p", cfg, params, chunk_size=8, backend="dense",
                       device="cpu", **KW)
    outs = []
    for eng, rs in ((rpe, copy.deepcopy(reqs)), (pe, _port_requests(reqs))):
        for r in rs:
            eng.submit(r)
        got, t = {}, 0.0
        while not eng.idle():
            for pk in eng.step(t):
                got[pk.req.rid] = pk
            t += 0.01
        outs.append(got)
    assert outs[0].keys() == outs[1].keys() and len(outs[0]) == 3
    for rid, pk_r in outs[0].items():
        pk = outs[1][rid]
        assert pk.first_token == pk_r.first_token
        assert (pk.n_chunks, pk.kv_len) == (pk_r.n_chunks, pk_r.kv_len)
        assert pk.ready is None and pk.pages_k is None
        _caches_close(cfg, pk_r.cache, pk.cache)


def test_backend_for_dense_matrix():
    """``auto`` resolves the recurrent archs to dense, and ``dense``
    builds for every config: GQA, MLA (layout "dense", no page width)
    and the cross archs (``cross="dense"`` with the encoder's tokens and
    the cross layers counted), as the reference's ``backend_for``."""
    for arch in ("recurrentgemma_9b", "xlstm_1_3b"):
        for requested in ("auto", "dense"):
            spec = backend_for(get_smoke_config(arch), requested)
            assert (spec.backend, spec.layout, spec.cross) \
                == ("dense", "dense", "none")
        with pytest.raises(ValueError):
            backend_for(get_smoke_config(arch), "paged")
    spec = backend_for(get_smoke_config("qwen2_0_5b"), "dense")
    assert (spec.backend, spec.page_token_bytes) == ("dense", 0)
    from repro.core.backend import backend_for as ref_backend_for
    from repro_torch.configs import get_config
    for arch in ("deepseek_v2_236b", "whisper_tiny",
                 "llama_3_2_vision_11b"):
        for cfg in (get_smoke_config(arch), get_config(arch)):
            spec = backend_for(cfg, "dense")
            assert dataclasses.asdict(spec) == dataclasses.asdict(
                ref_backend_for(cfg, "dense"))
            assert (spec.backend, spec.layout, spec.token_width) \
                == ("dense", "dense", 0)
            assert spec.cross == ("dense" if cfg.n_cross_layers else "none")
    vlm = backend_for(get_config("llama_3_2_vision_11b"), "dense")
    assert (vlm.cross, vlm.cross_ctx, vlm.n_cross_layers) \
        == ("dense", 1600, 8)
    ds = get_smoke_config("deepseek_v2_236b")
    layer = M.init_cache(ds, 1, 8, device="cpu")[0]
    assert {k: tuple(v.shape) for k, v in layer.items()} == {
        "ckv": (1, 8, ds.mla.kv_lora_rank),
        "krope": (1, 8, ds.mla.qk_rope_head_dim)}


# -- paged vs dense (tests/test_paged_path.py) ----------------------------
@pytest.fixture(scope="module")
def qwen():
    cfg = _cfg("qwen2_0_5b")
    return cfg, M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _drain_prefill(pe, reqs):
    for r in reqs:
        pe.submit(r)
    out, t = {}, 0.0
    for _ in range(200):
        for pk in pe.step(t):
            out[pk.req.rid] = pk
        t += 0.01
        if pe.idle():
            break
    return out


def test_fused_chunk_prefill_matches_per_segment_dense(qwen):
    """Mirrors tests/test_paged_path.py:48: one fused call per
    multi-segment chunk gives the dense per-segment calls' first tokens
    and K/V."""
    cfg, params = qwen
    reqs = _port_requests(generate("LPLD", 4, seed=11, max_prompt=30,
                                   max_decode=4, vocab_size=cfg.vocab_size))
    kw = dict(chunk_size=8, max_seq=64, device="cpu")
    pe_p = PrefillEngine("pp", cfg, params, backend="paged", page_size=PAGE,
                         n_pages=128, **kw)
    pe_d = PrefillEngine("pd", cfg, params, backend="dense", **kw)
    out_p = _drain_prefill(pe_p, copy.deepcopy(reqs))
    out_d = _drain_prefill(pe_d, copy.deepcopy(reqs))
    assert len(out_p) == len(out_d) == 4
    assert pe_p.fused_calls == pe_p.chunk_steps > 0
    kvh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    for rid, pkp in out_p.items():
        pkd = out_d[rid]
        assert pkp.first_token == pkd.first_token
        n = pkp.req.prompt_len
        for name, pages in (("k", pkp.pages_k), ("v", pkp.pages_v)):
            paged = pages.reshape(cfg.n_layers, -1, kvh, hd)[:, :n]
            dense = torch.stack([layer[name][0, :n]
                                 for layer in pkd.cache])
            assert float((paged - dense).abs().max()) < 1e-4


def test_paged_decode_matches_dense_over_ragged_multipage(qwen):
    """Mirrors tests/test_paged_path.py:80: ``decode_step_paged`` over
    multi-page sequences with ragged lengths emits the dense
    ``decode_step``'s tokens."""
    cfg, params = qwen
    rng = np.random.default_rng(3)
    kvh, hd, L = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    slots, max_seq, trash = 3, 32, 16
    lens = [11, 6, 1]
    tables = {0: [0, 1, 2], 1: [3, 4], 2: [5]}
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    cache = M.init_cache(cfg, slots, max_seq, device="cpu")
    first = []
    for i, toks in enumerate(prompts):
        lg, c = M.prefill(params, cfg, torch.from_numpy(toks[None]),
                          M.init_cache(cfg, 1, max_seq, device="cpu"))
        M.cache_insert(cache, c, i)
        first.append(int(torch.argmax(lg[0, -1])))
    pool = PagePool.create(L, trash + 1, PAGE, kvh, hd, torch.float32,
                           device="cpu")
    for i, toks in enumerate(prompts):
        n = len(toks)
        sq = 1 << max(0, n - 1).bit_length()
        tok = np.zeros((1, sq), np.int32)
        tok[0, :n] = toks
        tab = tables[i]
        bt = np.full((1, 8), trash, np.int32)
        bt[0, :len(tab)] = tab
        pg = np.full((1, sq), trash, np.int32)
        off = (np.arange(sq, dtype=np.int32) % PAGE)[None].copy()
        for j in range(n):
            pg[0, j] = tab[j // PAGE]
            off[0, j] = j % PAGE
        nxt, _ = M.prefill_paged(
            params, cfg, torch.from_numpy(tok),
            torch.zeros(1, dtype=torch.int32),
            torch.tensor([n], dtype=torch.int32),
            torch.tensor([n - 1], dtype=torch.int32), torch.from_numpy(bt),
            torch.from_numpy(pg), torch.from_numpy(off), pool.k, pool.v)
        assert int(nxt[0]) == first[i]
    last = np.array(first, np.int32)
    pos = np.array(lens, np.int32)
    for _ in range(4):
        bt = np.full((slots, 8), trash, np.int32)
        pages = np.zeros(slots, np.int32)
        for i in range(slots):
            need = pos[i] // PAGE + 1
            while len(tables[i]) < need:
                tables[i].append(max(max(t) for t in tables.values()) + 1)
            bt[i, :len(tables[i])] = tables[i]
            pages[i] = tables[i][pos[i] // PAGE]
        t_last = torch.from_numpy(last[:, None].copy())
        t_pos = torch.from_numpy(pos.copy())
        nxt_d, cache = M.decode_step_greedy(params, cfg, t_last, cache,
                                            t_pos)
        nxt_p = M.decode_step_paged(
            params, cfg, t_last, t_pos, torch.from_numpy(pages),
            torch.from_numpy(pos % PAGE), torch.from_numpy(bt),
            torch.from_numpy(pos + 1), pool.k, pool.v)
        assert nxt_d.tolist() == nxt_p.tolist()
        last = nxt_d.numpy().astype(np.int32)
        pos = pos + 1


def test_roundtrip_paged_vs_dense_engines(qwen):
    """Mirrors tests/test_paged_path.py:175: prefill -> transfer ->
    decode through both backends gives identical token streams."""
    cfg, params = qwen
    reqs = _port_requests(generate("Mixed", 5, seed=12, max_prompt=24,
                                   max_decode=6, vocab_size=cfg.vocab_size))
    outs = []
    for backend in ("paged", "dense"):
        pe = PrefillEngine("p0", cfg, params, chunk_size=8, backend=backend,
                           device="cpu", **KW)
        de = DecodeEngine("d0", cfg, params, max_slots=8, backend=backend,
                          device="cpu", **KW)
        outs.append(_drive(pe, de, copy.deepcopy(reqs)))
    assert len(outs[0]) == len(outs[1]) == 5
    assert outs[0] == outs[1]


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "xlstm_1_3b"])
@pytest.mark.parametrize("flag", ["--real", "--wall-clock"])
def test_serve_recurrent_arch(arch, flag, capsys):
    """``launch.serve --arch`` serves the recurrent archs' small f32
    configs on the dense backend, through ``Cluster`` (--real) and
    ``AsyncCluster`` (--wall-clock)."""
    from repro_torch.launch import serve
    serve.main([flag, "--arch", arch, "--device", "cpu", "--requests", "6",
                "--n-prefill", "1", "--n-decode", "1"])
    out = capsys.readouterr().out
    assert f"model: {arch.replace('_', '-').replace('-1-3b', '-1.3b')}" \
        in out
    assert ("n=6" in out) and ("workload=" in out or "open-loop" in out)


@pytest.mark.parametrize("ring", [False, True])
def test_gqa_decode_matches_reference(ring):
    """The single-position dense decode (``attention.gqa_decode``) against
    the reference's, three steps past a window of 6: a full-length cache,
    and a ring buffer of the window (``init_cache(ring=True)``'s
    shape), where the slot is pos mod 6."""
    from repro.models import attention as RA
    from repro_torch.models import attention as A
    cfg = dataclasses.replace(_cfg("qwen2_0_5b"), sliding_window=6)
    ref_params = RM.init_params(jax.random.PRNGKey(3), cfg)
    # layer 0: the first repeat of the reference's stacked body
    attn_ref = jax.tree.map(lambda a: a[0], ref_params["body"][0]["attn"])
    attn = from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                          "cpu")["layers"][0]["attn"]
    s = 6 if ring else 16
    rng = np.random.default_rng(7)
    kv = rng.standard_normal((2, 2, s, cfg.n_kv_heads,
                              cfg.resolved_head_dim)).astype(np.float32)
    rc = {"k": jnp.asarray(kv[0]), "v": jnp.asarray(kv[1])}
    c = {"k": torch.from_numpy(kv[0].copy()), "v": torch.from_numpy(
        kv[1].copy())}
    for pos in (9, 10, 11):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        out_r, rc = RA.gqa_decode(attn_ref, cfg, jnp.asarray(x), rc, pos,
                                  window=6)
        out, c = A.gqa_decode(attn, cfg, torch.from_numpy(x), c, pos,
                              window=6)
        _logits_close(out_r, out)
        for k in ("k", "v"):
            assert np.abs(np.asarray(rc[k]) - c[k].numpy()).max() < STATE_TOL
