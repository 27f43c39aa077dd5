"""Sliding-window paging in the port against the JAX package's paged path,
on the same weights (``from_reference``) and requests, in f32 on the
CPU. Ports the reference's window tests
(tests/test_paged_path.py:219-313 and :402); each holds the port against
the reference's paged engines and model, where the reference held its
paged path against its dense one (the port's dense backend is held in
tests/test_torch_dense.py). Logits agree within 1e-4 (summation order),
pools within 1e-5, tokens, fused calls, iterations and wire bytes
exactly.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.core.decode_engine import DecodeEngine as RefDecode  # noqa: E402
from repro.core.kv_transfer import kv_page_bytes as ref_kv_page_bytes  # noqa: E402,E501
from repro.core.prefill_engine import PrefillEngine as RefPrefill  # noqa: E402,E501
from repro.kvcache.paged import PagePool as RefPool  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.runtime.workload import generate  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.backend import backend_for  # noqa: E402
from repro_torch.core.decode_engine import DecodeEngine  # noqa: E402
from repro_torch.core.kv_transfer import kv_bytes, kv_page_bytes  # noqa: E402
from repro_torch.core.prefill_engine import PrefillEngine  # noqa: E402
from repro_torch.kvcache.paged import PagePool  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.params import from_reference  # noqa: E402
from repro_torch.runtime.request import Request  # noqa: E402

PAGE = 4
WINDOW = 6
LOGIT_TOL = 1e-4
POOL_TOL = 1e-5
KW = dict(max_seq=64, page_size=PAGE, n_pages=128)


def _windowed(smoke, arch, window=WINDOW):
    return dataclasses.replace(smoke(arch), dtype="float32",
                               sliding_window=window)


def _setup(arch, seed=1):
    ref_cfg = _windowed(ref_smoke, arch)
    cfg = _windowed(get_smoke_config, arch)
    ref_params = RM.init_params(jax.random.PRNGKey(seed), ref_cfg)
    params = from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                            "cpu")
    return ref_cfg, cfg, ref_params, params


@pytest.fixture(scope="module")
def windowed_setup():
    return _setup("mistral_nemo_12b")


def _port_requests(ref_reqs):
    return [Request(rid=r.rid, prompt_len=r.prompt_len,
                    decode_len=r.decode_len, arrival=r.arrival,
                    prompt_tokens=r.prompt_tokens) for r in ref_reqs]


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


def _drive(pe, de, reqs, on_step=None):
    for r in reqs:
        pe.submit(r)
    out, t = {}, 0.0
    for _ in range(2000):
        for pk in pe.step(t):
            de.receive(pk, now=t)
        de.admit(t)
        for f in de.step(t):
            out[f.req.rid] = f.tokens
        if on_step is not None:
            on_step(de)
        t += 0.01
        if pe.idle() and de.idle():
            break
    return out


def test_backend_for_window_matrix():
    """Mirrors tests/test_paged_path.py:219-245: a sliding-window config
    resolves to the paged backend with its window; GQA, MLA and the
    cross pages keep their layouts; the engines resolve through the same
    helper and give their allocators the window."""
    gqa = get_smoke_config("qwen2_0_5b")
    spec = backend_for(gqa)
    assert (spec.backend, spec.layout, spec.cross, spec.window) \
        == ("paged", "gqa", "none", 0)
    win = dataclasses.replace(get_smoke_config("mistral_nemo_12b"),
                              sliding_window=WINDOW)
    assert (backend_for(win).backend, backend_for(win).window) \
        == ("paged", WINDOW)
    mla = dataclasses.replace(get_smoke_config("deepseek_v2_236b"),
                              sliding_window=WINDOW)
    assert (backend_for(mla).layout, backend_for(mla).window) \
        == ("latent", WINDOW)
    assert backend_for(mla).token_width \
        == mla.mla.kv_lora_rank + mla.mla.qk_rope_head_dim
    for cross_arch in ("whisper_tiny", "llama_3_2_vision_11b"):
        s = backend_for(get_smoke_config(cross_arch))
        assert (s.backend, s.cross) == ("paged", "pages"), cross_arch
        assert s.cross_ctx > 0 and s.n_cross_layers > 0
    for dense_arch in ("recurrentgemma_9b", "xlstm_1_3b"):
        s = backend_for(get_smoke_config(dense_arch))
        assert (s.backend, s.layout) == ("dense", "dense"), dense_arch
    dense = backend_for(win, "dense")
    assert (dense.backend, dense.window) == ("dense", WINDOW)
    dense_mla = backend_for(mla, "dense")
    assert (dense_mla.backend, dense_mla.layout, dense_mla.window) \
        == ("dense", "dense", WINDOW)
    cfg = dataclasses.replace(win, dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    pe = PrefillEngine("p", cfg, params, device="cpu", **KW)
    de = DecodeEngine("d", cfg, params, device="cpu", **KW)
    assert pe.backend == de.backend == "paged"
    assert pe.spec.window == de.spec.window == WINDOW
    assert pe.alloc.window == de.alloc.window == WINDOW


def _chunk_args(segments, sq, n_slots, trash):
    """segments: (tokens, q_offset, table) with None for slid-out table
    slots -> the packed arrays the prefill engine builds."""
    ns = len(segments)
    toks = np.zeros((ns, sq), np.int32)
    qoff, kvlen, last = (np.zeros(ns, np.int32) for _ in range(3))
    bt = np.full((ns, n_slots), trash, np.int32)
    pg = np.full((ns, sq), trash, np.int32)
    off = np.tile(np.arange(sq, dtype=np.int32) % PAGE, (ns, 1))
    for i, (tk, q0, table) in enumerate(segments):
        n = len(tk)
        tab = np.asarray([trash if p is None else p for p in table])
        toks[i, :n] = tk
        qoff[i], kvlen[i], last[i] = q0, q0 + n, n - 1
        bt[i, :len(tab)] = tab
        pos = q0 + np.arange(n)
        pg[i, :n] = tab[pos // PAGE]
        off[i, :n] = pos % PAGE
    return toks, qoff, kvlen, last, bt, pg, off


def test_windowed_prefill_logits_match_reference(windowed_setup):
    """The windowed fused prefill at the model level: three chunks of one
    request and a second request, where the later chunks' tables point
    slid-out slots at the scratch page (as the engine's trim leaves
    them), give the reference's logits, first tokens and live pages."""
    ref_cfg, cfg, ref_params, params = windowed_setup
    rng = np.random.default_rng(4)
    trash, L = 15, cfg.n_layers
    shape = (L, trash + 1, PAGE, cfg.n_kv_heads, cfg.resolved_head_dim)
    ref_pool = RefPool.create(*shape[:2], PAGE, *shape[3:], jnp.float32)
    pool = PagePool.create(*shape[:2], PAGE, *shape[3:], torch.float32,
                           device="cpu")
    a = rng.integers(0, cfg.vocab_size, 22).astype(np.int32)
    b = rng.integers(0, cfg.vocab_size, 7).astype(np.int32)
    ta, tb = [0, 1, 2, 3, 4, 5], [6, 7]
    chunks = [[(a[:8], 0, ta), (b, 0, tb)],
              # keys < 8 - 6 + 1 are out of every query's window: slot 0
              [(a[8:16], 8, [None] + ta[1:])],
              [(a[16:], 16, [None, None, None] + ta[3:])]]
    for segs in chunks:
        args = _chunk_args(segs, 8, 8, trash)
        nxt_r, lg_r, kp, vp = RM.prefill_paged(
            ref_params, ref_cfg, *(jnp.asarray(x) for x in args),
            ref_pool.k, ref_pool.v)
        ref_pool = RefPool(k=kp, v=vp)
        nxt, lg = M.prefill_paged(params, cfg, *(torch.from_numpy(x)
                                                 for x in args),
                                  pool.k, pool.v)
        n = len(segs)
        assert nxt.tolist()[:n] == np.asarray(nxt_r).tolist()[:n]
        assert np.abs(lg.numpy()[:n] - np.asarray(lg_r)[:n]).max() \
            < LOGIT_TOL
    for p in ta + tb:
        assert np.abs(np.asarray(ref_pool.k[:, p])
                      - pool.k[:, p].numpy()).max() < POOL_TOL
        assert np.abs(np.asarray(ref_pool.v[:, p])
                      - pool.v[:, p].numpy()).max() < POOL_TOL


def test_windowed_prefill_engine_payload_matches_reference(windowed_setup):
    """Mirrors tests/test_paged_path.py:270: the port's prefill engine
    and the reference's give the same first tokens, each payload holds
    only the live (in-window) page suffix, and the payloads agree."""
    ref_cfg, cfg, ref_params, params = windowed_setup
    reqs = generate("LPLD", 4, seed=21, max_prompt=30, max_decode=4,
                    vocab_size=cfg.vocab_size)
    rpe = RefPrefill("pp", ref_cfg, ref_params, backend="paged",
                     chunk_size=8, **KW)
    pe = PrefillEngine("pp", cfg, params, chunk_size=8, device="cpu", **KW)
    out_r = _drain_prefill(rpe, copy.deepcopy(reqs))
    out = _drain_prefill(pe, _port_requests(reqs))
    assert len(out) == len(out_r) == 4
    assert any(pk.req.prompt_len > WINDOW + PAGE for pk in out.values())
    for rid, pk in out.items():
        pkr = out_r[rid]
        assert pk.first_token == pkr.first_token
        plen = pk.req.prompt_len
        n_live = pe.alloc.pages_for(plen) \
            - max(0, plen - WINDOW + 1) // PAGE
        assert pk.pages_k.shape[1] == pkr.pages_k.shape[1] == n_live
        assert np.abs(pk.pages_k.numpy() - np.asarray(pkr.pages_k)).max() \
            < POOL_TOL
        assert np.abs(pk.pages_v.numpy() - np.asarray(pkr.pages_v)).max() \
            < POOL_TOL
    assert pe.alloc.used_pages == rpe.alloc.used_pages == 0


@pytest.mark.parametrize("workload,seed", [("Mixed", 22), ("LPHD", 24)])
@pytest.mark.parametrize("arch", ["mistral_nemo_12b", "qwen2_0_5b",
                                  "deepseek_v2_236b"])
def test_windowed_roundtrip_matches_reference(arch, workload, seed):
    """Mirrors tests/test_paged_path.py:301 at window 6 and page 4: the
    disaggregated round trip through the port's engines gives the
    reference paged engines' tokens, fused calls, decode iterations and
    wire bytes, and both pools end empty (MLA latent pages included)."""
    ref_cfg, cfg, ref_params, params = _setup(arch, seed=2)
    reqs = generate(workload, 4, seed=seed, max_prompt=24, max_decode=10,
                    vocab_size=cfg.vocab_size)
    rpe = RefPrefill("p0", ref_cfg, ref_params, chunk_size=8,
                     backend="paged", **KW)
    rde = RefDecode("d0", ref_cfg, ref_params, max_slots=4,
                    backend="paged", **KW)
    out_ref = _drive(rpe, rde, copy.deepcopy(reqs))
    pe = PrefillEngine("p0", cfg, params, chunk_size=8, device="cpu", **KW)
    de = DecodeEngine("d0", cfg, params, max_slots=4, device="cpu", **KW)
    out = _drive(pe, de, _port_requests(reqs))
    assert len(out) == len(out_ref) == 4
    assert out == out_ref
    assert pe.fused_calls == pe.chunk_steps == rpe.fused_calls
    assert de.iterations == rde.iterations
    assert pe.network.bytes_sent == rpe.network.bytes_sent > 0
    assert pe.alloc.used_pages == de.alloc.used_pages == 0


def test_windowed_decode_holds_o_window_pages(windowed_setup):
    """Mirrors tests/test_paged_path.py:313: once the window fills, a
    decoding slot holds at most pages_for(window) + 1 physical pages,
    and at every iteration as many as the reference's slot holds."""
    ref_cfg, cfg, ref_params, params = windowed_setup
    bound = -(-WINDOW // PAGE) + 1
    reqs = generate("LPHD", 2, seed=23, max_prompt=16, max_decode=24,
                    vocab_size=cfg.vocab_size)
    held = {"port": [], "ref": []}
    checks = []

    def watch(tag):
        def on_step(de):
            for st in sorted(de.slots.values(), key=lambda s: s.req.rid):
                n = de.alloc.length(st.req.rid)
                h = de.alloc.pages_held(st.req.rid)
                held[tag].append((st.req.rid, n, h))
                if n > WINDOW and tag == "port":
                    checks.append(h)
                    assert h <= bound, (n, h, bound)
        return on_step
    kw = dict(KW, max_seq=64)
    _drive(RefPrefill("p0", ref_cfg, ref_params, chunk_size=8,
                      backend="paged", **kw),
           RefDecode("d0", ref_cfg, ref_params, max_slots=2,
                     backend="paged", **kw),
           copy.deepcopy(reqs), watch("ref"))
    _drive(PrefillEngine("p0", cfg, params, chunk_size=8, device="cpu",
                         **kw),
           DecodeEngine("d0", cfg, params, max_slots=2, device="cpu", **kw),
           _port_requests(reqs), watch("port"))
    assert checks                  # the bound was actually exercised
    assert held["port"] == held["ref"]


@pytest.mark.parametrize("n", [1, 5, 6, 7, 8, 9, 24, 33])
def test_windowed_transfer_ships_live_pages_only(n):
    """Mirrors tests/test_paged_path.py:402: wire bytes of a windowed
    config count the in-window page suffix only, as the reference's."""
    cfg = dataclasses.replace(get_smoke_config("mistral_nemo_12b"),
                              sliding_window=WINDOW)
    ref_cfg = dataclasses.replace(ref_smoke("mistral_nemo_12b"),
                                  sliding_window=WINDOW)
    assert kv_page_bytes(cfg, n, PAGE) == ref_kv_page_bytes(ref_cfg, n, PAGE)
    if n == 24:      # slots 0..3 dead -> 2 live pages
        assert kv_page_bytes(cfg, 24, PAGE) == kv_bytes(cfg, 8)
    if n == 5:       # the window not filled yet: everything ships
        assert kv_page_bytes(cfg, 5, PAGE) == kv_bytes(cfg, 8)
