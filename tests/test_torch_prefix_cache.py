"""The port's engines with the prefix cache on, against the JAX
package's on the same weights (``params.from_reference``) and the same
seeded requests: the engine cases of tests/test_prefix_cache.py.

Each case runs the reference's engines and the port's (on the CPU, f32)
and requires the same first tokens and greedy streams, page payloads
within ``POOL_TOL``, the same cache hits, chunk steps, fused and
encoder calls, wire bytes (sent and saved) and cross-page dedupe, and
no page leaked: every page is back on the free list or held by a cache
entry.  Each case also checks, on the port, what the reference's case
checks between cache on and cache off.  Each reference run is computed
once per module.
"""
import copy
import dataclasses
import itertools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.core.decode_engine import DecodeEngine as RefDecode  # noqa: E402
from repro.core.prefill_engine import PrefillEngine as RefPrefill  # noqa: E402,E501
from repro.core.sched.prefill_scheduler import \
    PrefillScheduler as RefScheduler  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.runtime.workload import generate  # noqa: E402
from repro.serving import Cluster as RefCluster  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.decode_engine import DecodeEngine  # noqa: E402
from repro_torch.core.prefill_engine import PrefillEngine  # noqa: E402
from repro_torch.core.sched.prefill_scheduler import PrefillScheduler  # noqa: E402,E501
from repro_torch.params import from_reference  # noqa: E402
from repro_torch.runtime.request import Request  # noqa: E402
from repro_torch.serving import Cluster  # noqa: E402

PAGE = 4
POOL_TOL = 1e-5


def _weights(arch, seed):
    rcfg = dataclasses.replace(ref_smoke(arch), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    ref_params = RM.init_params(jax.random.PRNGKey(seed), rcfg)
    params = from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                            "cpu")
    return cfg, rcfg, ref_params, params


@pytest.fixture(scope="module")
def qwen():
    return _weights("qwen2_0_5b", 0)


@pytest.fixture(scope="module")
def whisper():
    return _weights("whisper_tiny", 3)


@pytest.fixture(scope="module")
def memo():
    """A per-module cache of reference runs: key -> value."""
    return {}


def _once(memo, key, fn):
    if key not in memo:
        memo[key] = fn()
    return memo[key]


def _port_requests(reqs):
    return [Request(rid=r.rid, prompt_len=r.prompt_len,
                    decode_len=r.decode_len, arrival=r.arrival,
                    prompt_tokens=r.prompt_tokens,
                    enc_embeds=r.enc_embeds) for r in reqs]


def _shared_reqs(cfg, n=6, seed=11):
    return generate("Mixed", n, seed=seed, max_prompt=40, max_decode=6,
                    vocab_size=cfg.vocab_size, prefix_pool=2,
                    prefix_len=32, prefix_zipf=1.2)


def _no_leak(a):
    """Every page on the free list or held by a cache entry; no block
    table left."""
    assert a.free_pages + len(a.cache_pages()) == a.n_pages
    assert not a._tables


def _drain_prefill(pe, reqs):
    for r in reqs:
        pe.submit(r)
    out, t = {}, 0.0
    for _ in range(400):
        for pk in pe.step(t):
            out[pk.req.rid] = pk
        t += 0.01
        if pe.idle():
            break
    return out


def _prefill(port, cfg, params, flag, batch=2, chunk_size=8):
    # sched_batch=2: multi-wave traffic; the cache serves only committed
    # entries, so the sharing shows across waves
    if port:
        return PrefillEngine("pp", cfg, params,
                             scheduler=PrefillScheduler("fcfs", batch),
                             chunk_size=chunk_size, max_seq=64,
                             page_size=PAGE, n_pages=128,
                             prefix_cache=flag, device="cpu")
    return RefPrefill("pp", cfg, params, backend="paged",
                      scheduler=RefScheduler("fcfs", batch),
                      chunk_size=chunk_size, max_seq=64, page_size=PAGE,
                      n_pages=128, prefix_cache=flag)


def _counters(pe):
    return dict(hits=pe.alloc.cache_hits, cross_hits=pe.alloc.cross_hits,
                chunk_steps=pe.chunk_steps, fused=pe.fused_calls,
                encoder=pe.encoder_calls, sent=pe.network.bytes_sent,
                saved=pe.network.bytes_saved,
                cache_pages=len(pe.alloc.cache_pages()),
                free=pe.alloc.free_pages)


def _same_payloads(got, want, cross=False):
    """Port payloads against reference payloads (or another port run's)."""
    assert set(got) == set(want)
    for rid, pk in got.items():
        w = want[rid]
        assert pk.first_token == w.first_token, rid
        assert pk.cached_tokens == w.cached_tokens, rid
        assert pk.cross_cached == w.cross_cached, rid
        pairs = [(pk.pages_k, w.pages_k), (pk.pages_v, w.pages_v)]
        if cross:
            pairs += [(pk.cross_k, w.cross_k), (pk.cross_v, w.cross_v)]
        for a, b in pairs:
            a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
            assert a.shape == b.shape, rid
            assert np.abs(a - b).max() <= POOL_TOL, rid


# ---------------------------------------------------------------------------
# prefill: payloads, skipped chunks, wire bytes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("flag", [True, False])
def test_prefill_payloads_match_reference(qwen, memo, flag):
    """tests/test_prefix_cache.py:437: with and without the cache, the
    port's prefill ships the reference's first tokens and payloads, with
    the same hits, chunk steps and wire bytes; every page shipped and
    freed (cache entries only)."""
    cfg, rcfg, ref_params, params = qwen
    reqs = _shared_reqs(cfg)

    def ref():
        pe = _prefill(False, rcfg, ref_params, flag)
        return _drain_prefill(pe, copy.deepcopy(reqs)), _counters(pe)
    want, want_counts = _once(memo, ("prefill", flag), ref)
    pe = _prefill(True, cfg, params, flag)
    got = _drain_prefill(pe, _port_requests(reqs))
    assert len(got) == len(reqs)
    _same_payloads(got, want)
    assert _counters(pe) == want_counts
    _no_leak(pe.alloc)
    if flag:
        assert pe.alloc.cache_hits > 0
        assert sum(pk.cached_tokens for pk in got.values()) > 0
    else:
        assert pe.alloc.used_pages == 0
        assert all(pk.cached_tokens == 0 for pk in got.values())


def test_prefill_cache_on_equals_cache_off_and_is_cheaper(qwen):
    """tests/test_prefix_cache.py:437 on the port alone: the cache-on
    payloads hold what cache-off recomputed, with fewer chunks, fewer
    kernel-1 calls and fewer wire bytes."""
    cfg, _, _, params = qwen
    reqs = _shared_reqs(cfg)
    on = _prefill(True, cfg, params, True)
    off = _prefill(True, cfg, params, False)
    out_on = _drain_prefill(on, _port_requests(reqs))
    out_off = _drain_prefill(off, _port_requests(reqs))
    for rid, pk in out_on.items():
        pk0 = out_off[rid]
        assert pk.first_token == pk0.first_token, rid
        # the prompt's rows: a last page's rows past the prompt hold what
        # the page held before, and the two runs reuse pages differently
        n = pk.req.prompt_len
        for a, b in ((pk.pages_k, pk0.pages_k), (pk.pages_v, pk0.pages_v)):
            d = a.flatten(1, 2)[:, :n] - b.flatten(1, 2)[:, :n]
            assert d.abs().max() <= POOL_TOL, rid
    assert on.chunk_steps < off.chunk_steps
    assert on.fused_calls < off.fused_calls
    assert on.network.bytes_saved > 0
    assert on.network.bytes_sent < off.network.bytes_sent


def test_first_segment_starts_at_the_cached_prefix(qwen):
    """A cache-hit request's first segment starts at its cached prefix (a
    page multiple) and reads the aliased pages another request wrote:
    the q_offset kernel 1 sees."""
    cfg, _, _, params = qwen
    pe = _prefill(True, cfg, params, True, batch=1)
    rng = np.random.default_rng(7)
    shared = rng.integers(1, cfg.vocab_size, 16).astype(np.int32)
    reqs = [Request(rid=f"r{i}", prompt_len=16 + 5 + i, decode_len=2,
                    prompt_tokens=np.concatenate([
                        shared, rng.integers(1, cfg.vocab_size, 5 + i)
                        .astype(np.int32)])) for i in range(2)]
    seen = []
    step = pe._step_paged

    def spy(chunk, now):
        seen.extend((s.rid, s.req_start, s.length) for s in chunk.segments)
        return step(chunk, now)
    pe._step_paged = spy
    out = _drain_prefill(pe, reqs)
    assert len(out) == 2
    assert out["r0"].cached_tokens == 0 and out["r1"].cached_tokens == 16
    assert [s for s in seen if s[0] == "r1"][0][1] == 16
    assert pe.alloc.cache_hits == 16 // PAGE


# ---------------------------------------------------------------------------
# through the Cluster: tokens, hits on both sides, cancel mid-stream
# ---------------------------------------------------------------------------
def _run_cluster(make, reqs, flag, cancel_rid=None):
    cluster = make(n_prefill=1, n_decode=1, chunk_size=8, max_seq=64,
                   max_batch=4, n_pages=128, page_size=PAGE, sched_batch=2,
                   prefix_cache=flag)
    handles = [cluster.submit(request=r) for r in reqs]
    if cancel_rid is not None:
        h = next(h for h in handles if h.rid == cancel_rid)
        list(itertools.islice(iter(h), 2))        # mid-stream
        h.cancel()
    cluster.run()
    toks = {h.rid: h.result().tokens for h in handles
            if h.result().phase.value == "finished"}
    stats = dict(
        pe_hits=[i.pe.alloc.cache_hits for i in cluster.instances],
        de_hits=[i.de.alloc.cache_hits for i in cluster.instances],
        saved=cluster.network.bytes_saved, sent=cluster.network.bytes_sent,
        phases={h.rid: h.result().phase.value for h in handles})
    for i in cluster.instances:
        for a in (i.pe.alloc, i.de.alloc):
            _no_leak(a)
    return toks, stats


def _ref_cluster(ref_params, rcfg):
    return lambda **kw: RefCluster(rcfg, runtime="engine",
                                   params=ref_params, **kw)


def _port_cluster(params, cfg):
    return lambda **kw: Cluster(cfg, runtime="engine", params=params,
                                device="cpu", **kw)


@pytest.mark.parametrize("flag", [True, False])
def test_cluster_with_cache_matches_reference(qwen, memo, flag):
    """tests/test_prefix_cache.py:485: the Cluster with the cache on (and
    off) streams the reference's tokens, with the reference's hits on
    the prefill and the decode side and the same wire bytes."""
    cfg, rcfg, ref_params, params = qwen
    reqs = _shared_reqs(cfg, n=8, seed=3)
    want = _once(memo, ("cluster", flag), lambda: _run_cluster(
        _ref_cluster(ref_params, rcfg), copy.deepcopy(reqs), flag))
    got = _run_cluster(_port_cluster(params, cfg), _port_requests(reqs),
                       flag)
    assert got == want
    toks, stats = got
    assert len(toks) == len(reqs)
    if flag:
        assert sum(stats["pe_hits"]) > 0 and sum(stats["de_hits"]) > 0
        assert stats["saved"] > 0
        off = _once(memo, ("cluster", False), lambda: _run_cluster(
            _ref_cluster(ref_params, rcfg), copy.deepcopy(reqs), False))
        assert toks == off[0]


def test_cluster_cancel_mid_stream_with_cache(qwen, memo):
    """tests/test_prefix_cache.py:504: a prefix-sharing request cancelled
    mid-stream with the cache on; the survivors stream the reference's
    (and cache-off's) tokens and no page leaks."""
    cfg, rcfg, ref_params, params = qwen
    reqs = _shared_reqs(cfg, n=6, seed=9)
    victim = reqs[1].rid
    want = _once(memo, "cancel", lambda: _run_cluster(
        _ref_cluster(ref_params, rcfg), copy.deepcopy(reqs), True,
        cancel_rid=victim))
    got = _run_cluster(_port_cluster(params, cfg), _port_requests(reqs),
                       True, cancel_rid=victim)
    assert got == want
    assert victim not in got[0] and len(got[0]) == len(reqs) - 1
    off = _run_cluster(_port_cluster(params, cfg), _port_requests(reqs),
                       False, cancel_rid=victim)
    assert got[0] == off[0]


# ---------------------------------------------------------------------------
# decode side: only the uncached suffix is installed
# ---------------------------------------------------------------------------
def _pd_loop(pe, de, reqs):
    for r in reqs:
        pe.submit(r)
    out, t = {}, 0.0
    for _ in range(2000):
        for pk in pe.step(t):
            de.receive(pk)
        de.admit(t)
        for f in de.step(t):
            out[f.req.rid] = f.tokens
        t += 0.01
        if pe.idle() and de.idle():
            break
    return out


def test_decode_installs_only_uncached_suffix(qwen, memo):
    """tests/test_prefix_cache.py:581: the decode side aliases cached
    pages at admission and installs only each payload's fresh suffix,
    with the reference's hits and tokens (and cache-off's tokens)."""
    cfg, rcfg, ref_params, params = qwen
    reqs = _shared_reqs(cfg, n=6, seed=13)

    def ref():
        pe = _prefill(False, rcfg, ref_params, True)
        de = RefDecode("de", rcfg, ref_params, max_slots=4, max_seq=64,
                       backend="paged", page_size=PAGE, n_pages=128,
                       prefix_cache=True)
        return _pd_loop(pe, de, copy.deepcopy(reqs)), de.alloc.cache_hits

    def port(flag):
        pe = _prefill(True, cfg, params, flag)
        de = DecodeEngine("de", cfg, params, max_slots=4, max_seq=64,
                          page_size=PAGE, n_pages=128, prefix_cache=flag,
                          device="cpu")
        installed, admit = [], de.admit

        def spy(now):
            got = admit(now)
            installed.extend(len(de.alloc.live_pages(r.rid))
                             - de.alloc.cached_prefix_pages(r.rid)
                             for r in got if de.alloc.has(r.rid))
            return got
        de.admit = spy
        out = _pd_loop(pe, de, _port_requests(reqs))
        for a in (pe.alloc, de.alloc):
            _no_leak(a)
        return out, de, installed

    want, want_hits = _once(memo, "decode", ref)
    out_on, de_on, installed = port(True)
    out_off, _, installed_off = port(False)
    assert out_on == want == out_off
    assert de_on.alloc.cache_hits == want_hits > 0
    assert sum(installed) < sum(installed_off)


# ---------------------------------------------------------------------------
# cross-attention: the encoder once per request, cross pages deduped
# ---------------------------------------------------------------------------
def test_encoder_runs_once_per_request_not_per_chunk(whisper, memo):
    """tests/test_prefix_cache.py:531: a 3-chunk cross prefill runs the
    encoder once, as the reference's, with the same payload."""
    cfg, rcfg, ref_params, params = whisper
    reqs = generate("Mixed", 1, seed=51, max_prompt=30, max_decode=4,
                    vocab_size=cfg.vocab_size, enc_ctx=cfg.cross_ctx,
                    enc_dim=cfg.d_model)
    reqs[0].prompt_len = 20
    reqs[0].prompt_tokens = reqs[0].prompt_tokens[:20]

    def ref():
        pe = RefPrefill("pe", rcfg, ref_params, backend="paged",
                        chunk_size=8, max_seq=64, page_size=PAGE,
                        n_pages=128)
        return _drain_prefill(pe, copy.deepcopy(reqs)), _counters(pe)
    want, want_counts = _once(memo, "encoder", ref)
    pe = PrefillEngine("pe", cfg, params, chunk_size=8, max_seq=64,
                       page_size=PAGE, n_pages=128, device="cpu")
    got = _drain_prefill(pe, _port_requests(reqs))
    _same_payloads(got, want, cross=True)
    assert _counters(pe) == want_counts
    assert pe.fused_calls == pe.chunk_steps == 3
    assert pe.encoder_calls == 1


def _same_clip_reqs(cfg, n, groups, seed=52):
    """``n`` requests whose encoder inputs are byte-equal within each of
    ``groups`` groups (several users sending one clip)."""
    reqs = generate("Mixed", n, seed=seed, max_prompt=20, max_decode=4,
                    vocab_size=cfg.vocab_size, enc_ctx=cfg.cross_ctx,
                    enc_dim=cfg.d_model)
    for i, r in enumerate(reqs):
        r.enc_embeds = reqs[i % groups].enc_embeds.copy()
        r.decode_len = 12        # long enough for slots to overlap
    return reqs


@pytest.mark.parametrize("flag", [True, False])
def test_cross_pages_dedupe_matches_reference(whisper, memo, flag):
    """tests/test_prefix_cache.py:549: two requests with one encoder
    input, the cache on: the encoder runs once, the second request
    aliases the committed cross pages and ships no cross bytes; the
    port's payloads, encoder calls and cross hits are the reference's,
    with the cache on and off."""
    cfg, rcfg, ref_params, params = whisper
    reqs = _same_clip_reqs(cfg, 2, 1)

    def run(port):
        if port:
            pe = PrefillEngine("pe", cfg, params,
                               scheduler=PrefillScheduler("fcfs", 1),
                               chunk_size=8, max_seq=64, page_size=PAGE,
                               n_pages=128, prefix_cache=flag,
                               device="cpu")
            out = _drain_prefill(pe, _port_requests(reqs))
        else:
            pe = RefPrefill("pe", rcfg, ref_params, backend="paged",
                            scheduler=RefScheduler("fcfs", 1),
                            chunk_size=8, max_seq=64, page_size=PAGE,
                            n_pages=128, prefix_cache=flag)
            out = _drain_prefill(pe, copy.deepcopy(reqs))
        return out, _counters(pe)
    want, want_counts = _once(memo, ("dedupe", flag), lambda: run(False))
    got, counts = run(True)
    _same_payloads(got, want, cross=True)
    assert counts == want_counts
    assert counts["encoder"] == (1 if flag else 2)
    assert counts["cross_hits"] == (1 if flag else 0)
    assert got[reqs[1].rid].cross_cached == flag
    if flag:
        assert counts["saved"] > 0


def test_decode_slots_share_deduped_cross_pages(whisper, memo):
    """8 requests in two groups of one encoder input each, through the
    prefill and decode engines with the cache on: 2 encoder calls, the
    decode slots of one group read the same cross pages (kernel 4's
    tables), the reference's tokens, and cache-off's."""
    cfg, rcfg, ref_params, params = whisper
    reqs = _same_clip_reqs(cfg, 8, 2, seed=53)

    def ref():
        pe = RefPrefill("pe", rcfg, ref_params, backend="paged",
                        scheduler=RefScheduler("fcfs", 2), chunk_size=8,
                        max_seq=64, page_size=PAGE, n_pages=256,
                        prefix_cache=True)
        de = RefDecode("de", rcfg, ref_params, max_slots=8, max_seq=64,
                       backend="paged", page_size=PAGE, n_pages=256,
                       prefix_cache=True)
        return (_pd_loop(pe, de, copy.deepcopy(reqs)), pe.encoder_calls,
                de.alloc.cross_hits)

    def port(flag):
        pe = PrefillEngine("pe", cfg, params,
                           scheduler=PrefillScheduler("fcfs", 2),
                           chunk_size=8, max_seq=64, page_size=PAGE,
                           n_pages=256, prefix_cache=flag, device="cpu")
        de = DecodeEngine("de", cfg, params, max_slots=8, max_seq=64,
                          page_size=PAGE, n_pages=256, prefix_cache=flag,
                          device="cpu")
        shared, step = [], de.step

        def spy(now):
            tables = {}
            for st in de.slots.values():
                tables.setdefault(tuple(de.alloc.cross_table(st.req.rid)),
                                  []).append(st.req.rid)
            shared.append(max((len(v) for v in tables.values()),
                              default=0))
            return step(now)
        de.step = spy
        out = _pd_loop(pe, de, _port_requests(reqs))
        for a in (pe.alloc, de.alloc):
            _no_leak(a)
        return out, pe.encoder_calls, de.alloc.cross_hits, max(shared)

    want = _once(memo, "cross-decode", ref)
    on = port(True)
    off = port(False)
    assert on[:3] == want
    assert on[0] == off[0]
    assert on[1] == 2 < off[1] == 8
    assert on[3] >= 2 and off[3] == 1
