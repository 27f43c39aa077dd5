"""The port's serving engines against the JAX package's on the same
weights and requests: prefill -> page handoff -> decode streams the
same tokens, runs the same fused calls and puts the same bytes on the
emulated wire; pages all come back; cancel mid-decode frees pages.
Also the host-side pieces the engines stand on: the allocator (same
tables and free-list order as the reference over one op sequence) and
the page pool's gather/install/copy_pages.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.decode_engine import DecodeEngine as RefDecode  # noqa: E402
from repro.core.kv_transfer import kv_page_bytes as ref_kv_page_bytes  # noqa: E402,E501
from repro.core.prefill_engine import PrefillEngine as RefPrefill  # noqa: E402,E501
from repro.kvcache.paged import PagedAllocator as RefAlloc  # noqa: E402
from repro.kvcache.paged import PagePool as RefPool  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.runtime.workload import generate  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.decode_engine import DecodeEngine  # noqa: E402
from repro_torch.core.kv_transfer import NetworkStack, kv_page_bytes  # noqa: E402,E501
from repro_torch.core.prefill_engine import PrefillEngine  # noqa: E402
from repro_torch.kvcache.paged import (OutOfPages, PagedAllocator,  # noqa: E402
                                       PagePool)
from repro_torch.params import from_reference  # noqa: E402
from repro_torch.runtime.request import Request, SamplingParams  # noqa: E402

PAGE = 4
KW = dict(max_seq=64, page_size=PAGE, n_pages=128)


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_smoke_config("qwen2_0_5b"),
                              dtype="float32")
    ref_params = RM.init_params(jax.random.PRNGKey(0), cfg)
    params = from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                            "cpu")
    return cfg, ref_params, params


def _port_requests(ref_reqs):
    return [Request(rid=r.rid, prompt_len=r.prompt_len,
                    decode_len=r.decode_len, arrival=r.arrival,
                    prompt_tokens=r.prompt_tokens) for r in ref_reqs]


def _drive(pe, de, reqs, cancel_at=None):
    """The engines' submit -> step -> receive -> admit -> step loop.
    ``cancel_at=(rid, iteration)`` cancels one request mid-decode."""
    for r in reqs:
        pe.submit(r)
    out, t = {}, 0.0
    for _ in range(2000):
        for pk in pe.step(t):
            de.receive(pk, now=t)
        de.admit(t)
        for f in de.step(t):
            out[f.req.rid] = f.tokens
        if cancel_at and de.iterations == cancel_at[1]:
            assert de.cancel(cancel_at[0])
            cancel_at = None
        t += 0.01
        if pe.idle() and de.idle():
            break
    return out


def _engines(cfg, params, port, max_slots=4):
    if port:
        return (PrefillEngine("p0", cfg, params, chunk_size=8,
                              device="cpu", **KW),
                DecodeEngine("d0", cfg, params, max_slots=max_slots,
                             device="cpu", **KW))
    return (RefPrefill("p0", cfg, params, chunk_size=8, backend="paged",
                       **KW),
            RefDecode("d0", cfg, params, max_slots=max_slots,
                      backend="paged", **KW))


@pytest.mark.parametrize("workload,seed", [("Mixed", 12), ("LPHD", 14)])
def test_roundtrip_matches_reference_engines(setup, workload, seed):
    """Mirrors tests/test_paged_path.py:175 and :202: prefill -> transfer
    -> decode through both engine pairs gives identical token streams per
    request, the same number of fused prefill calls, the same wire bytes
    and an empty pool on both sides at the end."""
    cfg, ref_params, params = setup
    reqs = generate(workload, 5, seed=seed, max_prompt=24, max_decode=6,
                    vocab_size=cfg.vocab_size)
    rpe, rde = _engines(cfg, ref_params, port=False)
    out_ref = _drive(rpe, rde, copy.deepcopy(reqs))
    pe, de = _engines(cfg, params, port=True)
    out = _drive(pe, de, _port_requests(reqs))
    assert len(out) == len(out_ref) == 5
    assert out == out_ref
    assert pe.fused_calls == pe.chunk_steps == rpe.fused_calls
    assert de.iterations == rde.iterations
    assert pe.network.bytes_sent == rpe.network.bytes_sent > 0
    assert pe.alloc.used_pages == de.alloc.used_pages == 0


def test_stop_criteria_match_reference(setup):
    """Requests with SamplingParams (greedy, max_new_tokens) stop where
    the reference stops them."""
    cfg, ref_params, params = setup
    reqs = generate("Mixed", 3, seed=15, max_prompt=20, max_decode=9,
                    vocab_size=cfg.vocab_size)
    from repro.runtime.request import SamplingParams as RefSP
    for i, r in enumerate(reqs):
        r.sampling = RefSP(max_new_tokens=2 + i)
    out_ref = _drive(*_engines(cfg, ref_params, port=False),
                     copy.deepcopy(reqs))
    port_reqs = _port_requests(reqs)
    for i, r in enumerate(port_reqs):
        r.sampling = SamplingParams(max_new_tokens=2 + i)
    out = _drive(*_engines(cfg, params, port=True), port_reqs)
    assert out == out_ref
    assert [len(out[r.rid]) for r in port_reqs] == [2, 3, 4]


def test_cancel_mid_decode_frees_pages(setup):
    cfg, _, params = setup
    reqs = _port_requests(generate("LPHD", 3, seed=16, max_prompt=20,
                                   max_decode=12,
                                   vocab_size=cfg.vocab_size))
    pe, de = _engines(cfg, params, port=True)
    victim = reqs[0].rid
    out = _drive(pe, de, reqs, cancel_at=(victim, 2))
    assert victim not in out and len(out) == 2
    assert de.alloc.used_pages == pe.alloc.used_pages == 0
    assert not de.alloc.has(victim)


def test_prefill_page_backpressure(setup):
    """Mirrors tests/test_paged_path.py:187: a pool too small for the
    scheduler batch defers requests instead of crashing."""
    cfg, _, params = setup
    reqs = _port_requests(generate("LPLD", 4, seed=13, max_prompt=30,
                                   max_decode=2,
                                   vocab_size=cfg.vocab_size))
    pe = PrefillEngine("p0", cfg, params, chunk_size=8, max_seq=64,
                       page_size=PAGE, n_pages=10, device="cpu")
    for r in reqs:
        pe.submit(r)
    done = []
    for _ in range(200):
        done += pe.step(0.0)
        if pe.idle():
            break
    assert len(done) == 4
    assert pe.alloc.used_pages == 0


def test_sampled_requests_and_unported_paths_raise(setup):
    cfg, _, params = setup
    pe, de = _engines(cfg, params, port=True)
    r = Request("s", 5, 3, prompt_tokens=np.arange(5, dtype=np.int32),
                sampling=SamplingParams(temperature=0.7))
    pe.submit(r)
    (pk,) = pe.step(0.0)
    with pytest.raises(NotImplementedError):
        de.receive(pk)
    with pytest.raises(NotImplementedError):
        PrefillEngine("p", cfg, params, device="cpu", backend="dense")
    with pytest.raises(NotImplementedError):
        DecodeEngine("d", cfg, params, device="cpu", prefix_cache=True)


@pytest.mark.parametrize("n", [1, 4, 16, 17, 33])
def test_kv_page_bytes_match_reference(setup, n):
    """Mirrors tests/test_paged_path.py:202: page-granular wire bytes."""
    cfg = setup[0]
    from repro.configs import get_smoke_config as ref_smoke
    ref_cfg = dataclasses.replace(ref_smoke("qwen2_0_5b"), dtype="float32")
    assert kv_page_bytes(cfg, n, 16) == ref_kv_page_bytes(ref_cfg, n, 16)
    net = NetworkStack()
    net.send_kv(cfg, n, page_size=16)
    assert net.bytes_sent == kv_page_bytes(cfg, n, 16)


def _alloc_ops(seed, n=300):
    rng = np.random.default_rng(seed)
    return [(str(rng.choice(["alloc", "append", "free", "trim"])),
             int(rng.integers(0, 8)), int(rng.integers(1, 60)))
            for _ in range(n)]


@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("seed", [0, 1])
def test_allocator_tracks_reference(window, seed):
    """The copied allocator against the reference one over one op
    sequence (tests/test_paged_alloc.py's walk): same results, tables,
    lengths and free-list order after every op."""
    mine = PagedAllocator(n_pages=24, page_size=4, window=window)
    ref = RefAlloc(n_pages=24, page_size=4, window=window)
    live = set()
    for op, ridx, toks in _alloc_ops(seed):
        rid = f"r{ridx}"
        results = []
        for a in (mine, ref):
            try:
                if op == "alloc" and rid not in live:
                    results.append(a.alloc(rid, toks))
                elif op == "append" and rid in live:
                    results.append(a.append_token(rid))
                elif op == "trim" and rid in live:
                    results.append(a.trim(rid, a.length(rid)))
                elif op == "free" and rid in live:
                    results.append(a.free(rid))
            except OutOfPages:
                results.append("oop")
            except Exception as e:            # the reference's own type
                if type(e).__name__ != "OutOfPages":
                    raise
                results.append("oop")
        assert results[:1] == results[1:], (op, rid)
        if op == "alloc" and results and results[0] != "oop":
            live.add(rid)
        if op == "free" and rid in live:
            live.discard(rid)
        assert mine._free == ref._free
        for r in live:
            assert mine.table(r) == ref.table(r)
            assert mine.length(r) == ref.length(r)


def test_allocator_prefix_cache_and_cow_track_reference():
    """The allocator's prefix-cache paths are copied whole: aliasing,
    commit, copy-on-write pairs and refcounts match the reference."""
    keys = [b"k0", b"k1", b"k2"]
    pair = [PagedAllocator(n_pages=12, page_size=4, prefix_cache=True),
            RefAlloc(n_pages=12, page_size=4, prefix_cache=True)]
    for a in pair:
        a.alloc("a", 12, page_keys=keys)
        a.commit("a", keys)
        a.alloc("b", 12, page_keys=keys)
        a.append_token("b")
        a.fork("c", "b")
        a.append_token("c")
    mine, ref = pair
    assert mine.table("b") == ref.table("b")
    assert mine.table("c") == ref.table("c")
    assert mine.take_cow_copies() == ref.take_cow_copies()
    assert mine._refs == ref._refs and mine._free == ref._free


def _filled_pools(dtype=torch.float32):
    k = np.arange(2 * 3 * PAGE * 2 * 16, dtype=np.float32).reshape(
        2, 3, PAGE, 2, 16)
    ref_a = RefPool.create(2, 8, PAGE, 2, 16, jnp.float32)
    idx = jnp.asarray([1, 4, 6])
    ref_a = RefPool(k=ref_a.k.at[:, idx].set(k),
                    v=ref_a.v.at[:, idx].set(2 * k))
    pool_a = PagePool.create(2, 8, PAGE, 2, 16, dtype, device="cpu")
    pool_a.k[:, [1, 4, 6]] = torch.from_numpy(k).to(dtype)
    pool_a.v[:, [1, 4, 6]] = torch.from_numpy(2 * k).to(dtype)
    return k, ref_a, pool_a


def test_pool_gather_install_roundtrip_matches_reference():
    """Mirrors tests/test_paged_path.py:414: the page-granular handoff is
    lossless, and equals the reference's pools byte for byte."""
    k, ref_a, pool_a = _filled_pools()
    rk, rv = ref_a.gather([1, 4, 6])
    pk, pv = pool_a.gather([1, 4, 6])
    assert np.array_equal(pk.numpy(), np.asarray(rk))
    ref_b = RefPool.create(2, 8, PAGE, 2, 16, jnp.float32).install(
        [0, 2, 5], rk, rv)
    pool_b = PagePool.create(2, 8, PAGE, 2, 16, torch.float32, device="cpu")
    assert pool_b.install([0, 2, 5], pk, pv) is pool_b      # in place
    assert np.array_equal(pool_b.k.numpy(), np.asarray(ref_b.k))
    assert np.array_equal(pool_b.v.numpy(), np.asarray(ref_b.v))


def test_pool_gather_returns_a_copy():
    """The prefill side frees pages right after gathering them: the
    payload must survive the pages' reuse."""
    k, _, pool = _filled_pools()
    pk, pv = pool.gather([1, 4])
    pool.k.zero_()
    pool.v.zero_()
    assert np.array_equal(pk.numpy(), k[:, :2])
    assert np.array_equal(pv.numpy(), 2 * k[:, :2])


def test_pool_copy_pages_matches_reference():
    _, ref_a, pool_a = _filled_pools()
    ref_a = ref_a.copy_pages([1, 6], [0, 3])
    pool_a.copy_pages([1, 6], [0, 3])
    assert np.array_equal(pool_a.k.numpy(), np.asarray(ref_a.k))
    assert np.array_equal(pool_a.v.numpy(), np.asarray(ref_a.v))
