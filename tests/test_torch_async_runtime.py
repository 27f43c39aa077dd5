"""The port's wall-clock ``AsyncCluster`` (on the CPU, f32) against the
reference's runtimes: the cases of tests/test_async_runtime.py.

* token identity: the port's ``AsyncCluster`` (2 prefill + 2 decode
  worker threads, overlapped KV transfer) streams the tokens of the
  reference's synchronous ``Cluster`` on the same weights
  (``params.from_reference``) and requests, three times over (a racy
  runtime fails this now and then, not always), with the cache off and
  on; the serialized-transfer ablation changes no token;
* cancel mid-stream frees every page and emits nothing after it; chaos
  (a decode instance killed, KV drops) ends all terminal with no leak;
* ``ArrivalSchedule`` draws the reference's times; the open-loop client
  drives the cluster and surfaces its submit errors;
* a transfer never clobbers a terminal phase; sampled requests stream
  the same on the sync and async runtimes;
* the allocator and the kernels' shared state survive a thread hammer;
* ``worker_errors`` is empty outside chaos, and records a worker's
  exception that no fault injected.

Every wait has a timeout, every cluster is closed by its ``with``, and
the runtime's threads are daemons, so a wedged run fails at once.  The
reference's streams are computed once per module.
"""
import copy
import dataclasses
import itertools
import sys
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.runtime.workload import generate  # noqa: E402
from repro.serving import ArrivalSchedule as RefSchedule  # noqa: E402
from repro.serving import Cluster as RefCluster  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kvcache.paged import OutOfPages, PagedAllocator  # noqa: E402
from repro_torch.params import from_reference  # noqa: E402
from repro_torch.runtime.request import (TERMINAL_PHASES, Phase,  # noqa: E402
                                         Request)
from repro_torch.serving import (ArrivalSchedule, AsyncCluster,  # noqa: E402
                                 Cluster, FaultEvent, FaultSpec,
                                 OpenLoopClient, RecoveryPolicy,
                                 SamplingParams)
from repro_torch.serving.runtime import PrefillOutcome  # noqa: E402

DRAIN_S = 60.0
CLUSTER = dict(chunk_size=16, max_seq=128, max_batch=8, n_pages=256)


@pytest.fixture(scope="module")
def setup():
    rcfg = dataclasses.replace(ref_smoke("qwen2_0_5b"), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config("qwen2_0_5b"),
                              dtype="float32")
    ref_params = RM.init_params(jax.random.PRNGKey(0), rcfg)
    params = from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                            "cpu")
    return cfg, rcfg, ref_params, params


@pytest.fixture(scope="module")
def memo():
    return {}


def _once(memo, key, fn):
    if key not in memo:
        memo[key] = fn()
    return memo[key]


def _port_requests(reqs):
    out = []
    for r in reqs:
        sp = r.sampling
        out.append(Request(
            rid=r.rid, prompt_len=r.prompt_len, decode_len=r.decode_len,
            arrival=r.arrival, prompt_tokens=r.prompt_tokens,
            sampling=None if sp is None else SamplingParams(
                max_new_tokens=sp.max_new_tokens,
                temperature=sp.temperature, top_k=sp.top_k,
                seed=sp.seed)))
    return out


def _workload(seed=0, n=8, **kw):
    # the smoke config's vocabulary (the reference's test draws from
    # 1000, past its 512 rows, which JAX's gather clamps and torch's
    # indexing refuses)
    return generate("Mixed", n, seed=seed, max_prompt=48, max_decode=12,
                    vocab_size=512, **kw)


def _ref_streams(setup, reqs, n_prefill=2, n_decode=2, **kw):
    """The reference's synchronous Cluster on ``reqs``: rid -> tokens."""
    _, rcfg, ref_params, _ = setup
    sync = RefCluster(rcfg, runtime="engine", params=ref_params,
                      n_prefill=n_prefill, n_decode=n_decode,
                      **CLUSTER, **kw)
    handles = [sync.submit(request=r) for r in copy.deepcopy(reqs)]
    sync.run()
    return {h.rid: h.result().tokens for h in handles}


def _async(setup, **kw):
    cfg, _, _, params = setup
    kw.setdefault("n_prefill", 2)
    kw.setdefault("n_decode", 2)
    return AsyncCluster(cfg, params=params, device="cpu", **CLUSTER, **kw)


def _assert_no_leaks(cluster):
    for i in cluster.instances:
        for a in (i.pe.alloc, i.de.alloc):
            assert a.free_pages + len(a.cache_pages()) == a.n_pages, i.iid


def _assert_clean(cluster):
    assert cluster.worker_errors == []
    _assert_no_leaks(cluster)


def _serve(ac, reqs):
    hs = [ac.submit(request=r) for r in reqs]
    assert ac.drain(timeout=DRAIN_S), "run wedged"
    return hs, {h.rid: h.result(wait=False).tokens for h in hs}


# -- token identity ----------------------------------------------------------
@pytest.mark.parametrize("prefix_cache", [False, True])
def test_async_token_identical_to_reference_sync_3x(setup, memo,
                                                    prefix_cache):
    """tests/test_async_runtime.py:66: three async runs, each a different
    thread interleaving, stream the reference's sync tokens (with the
    prefix cache off and on, on shared-prefix traffic for the latter);
    wall timestamps are real and ordered."""
    kw = dict(prefix_pool=2, prefix_len=32) if prefix_cache else {}
    reqs = _workload(**kw)
    want = _once(memo, ("sync", prefix_cache), lambda: _ref_streams(
        setup, reqs, prefix_cache=prefix_cache))
    assert all(len(t) > 0 for t in want.values())
    for attempt in range(3):
        with _async(setup, prefix_cache=prefix_cache) as ac:
            hs, got = _serve(ac, _port_requests(reqs))
            assert got == want, f"run {attempt} diverged"
            _assert_clean(ac)
    for h in hs:
        r = h.request
        assert 0 <= r.t_prefill_start <= r.t_first_token
        assert r.t_first_token <= r.t_transfer_done <= r.t_decode_start
        assert r.t_decode_start <= r.t_finish


def test_async_serialized_transfer_same_tokens(setup, memo):
    """tests/test_async_runtime.py:96: the overlap ablation (transfer
    inline on the prefill worker) changes timing only."""
    reqs = _workload(seed=1, n=6)
    want = _once(memo, "sync-1", lambda: _ref_streams(setup, reqs))
    for overlap in (True, False):
        with _async(setup, overlap_transfer=overlap) as ac:
            _, got = _serve(ac, _port_requests(reqs))
            assert got == want, overlap
            _assert_clean(ac)


# -- cancel under concurrency ------------------------------------------------
def test_async_cancel_mid_stream(setup):
    """tests/test_async_runtime.py:114."""
    cfg = setup[0]
    rng = np.random.default_rng(2)
    with _async(setup, n_prefill=1, n_decode=1) as ac:
        h_long = ac.submit(
            rng.integers(1, cfg.vocab_size, size=16).astype(np.int32),
            sampling=SamplingParams(max_new_tokens=100))
        h_short = ac.submit(
            rng.integers(1, cfg.vocab_size, size=9).astype(np.int32),
            sampling=SamplingParams(max_new_tokens=4))
        got = list(itertools.islice(iter(h_long), 3))      # mid-decode
        assert len(got) == 3
        assert h_long.cancel()
        assert ac.drain(timeout=DRAIN_S)
        assert h_long.result(wait=False).phase == Phase.CANCELLED
        assert h_short.result(wait=False).phase == Phase.FINISHED
        assert len(h_short.result(wait=False).tokens) == 4
        n_after_cancel = len(h_long.tokens_so_far())
        # at most the iteration in flight at the cancel commits; then
        # the stream stays frozen
        assert ac.drain(timeout=5)
        assert len(h_long.tokens_so_far()) == n_after_cancel
        assert not h_long.cancel()          # idempotent: already terminal
        _assert_clean(ac)


# -- chaos -------------------------------------------------------------------
def test_async_chaos_all_terminal_zero_leaks(setup):
    """tests/test_async_runtime.py:142: a decode instance killed early and
    deterministic KV drops (seed 15 drops attempts 0 and 1 for most
    rids): every request terminal, retransmissions ran, no page leaked."""
    reqs = _port_requests(_workload(seed=2, n=8))
    faults = FaultSpec(seed=15, drop_kv=0.3,
                       events=(FaultEvent(t=0.05, kind="crash", iid="i2"),))
    recovery = RecoveryPolicy(transfer_timeout_s=0.05,
                              retry_backoff_s=0.01, max_retries=5)
    with _async(setup, n_prefill=1, n_decode=2, faults=faults,
                recovery=recovery) as ac:
        hs = [ac.submit(request=r) for r in reqs]
        assert ac.drain(timeout=DRAIN_S), "chaos run wedged"
        assert all(h.result(wait=False).phase in TERMINAL_PHASES
                   for h in hs)
        assert sum(h.request.retries for h in hs) > 0
        assert ac.fault_plane.dropped > 0
        assert "i2" in ac._dead
        _assert_no_leaks(ac)


# -- open-loop arrivals ------------------------------------------------------
@pytest.mark.parametrize("process", ["batch", "poisson", "bursty",
                                     "diurnal"])
def test_arrival_schedule_matches_reference(process):
    """The reference's ArrivalSchedule times for the same seed and
    process, bit for bit; deterministic and non-decreasing."""
    kw = dict(process=process, rate=50.0, seed=3, period_s=1.0)
    got = ArrivalSchedule(**kw).times(64)
    assert np.array_equal(got, RefSchedule(**kw).times(64))
    assert np.array_equal(got, ArrivalSchedule(**kw).times(64))
    assert (np.diff(got) >= 0).all() and len(got) == 64
    if process == "poisson":
        assert 0.4 < got[-1] < 3.5


def test_open_loop_client_drives_async_cluster(setup, memo):
    """tests/test_async_runtime.py:183, and the reference's sync tokens."""
    reqs = _workload(seed=4, n=6)
    want = _once(memo, "sync-4", lambda: _ref_streams(
        setup, reqs, n_prefill=1, n_decode=1))
    sched = ArrivalSchedule(process="poisson", rate=200.0, seed=0)
    with _async(setup, n_prefill=1, n_decode=1) as ac:
        client = OpenLoopClient(ac, _port_requests(reqs), sched).start()
        client.join(timeout=60)
        assert client.submitted == len(reqs)
        assert ac.drain(timeout=DRAIN_S)
        for h in client.handles:
            assert h.result(wait=False).phase == Phase.FINISHED
            assert h.result(wait=False).tokens == want[h.rid]
        _assert_clean(ac)


def test_open_loop_client_surfaces_submit_errors():
    """tests/test_async_runtime.py:198."""

    class BoomCluster:
        def __init__(self):
            self.n = 0

        def submit(self, request=None):
            self.n += 1
            if self.n > 2:
                raise ValueError("backend gone")
            return object()

    reqs = [Request(rid=f"e{i}", prompt_len=4, decode_len=2)
            for i in range(5)]
    sched = ArrivalSchedule(process="poisson", rate=1000.0, seed=0)
    client = OpenLoopClient(BoomCluster(), reqs, sched).start()
    with pytest.raises(RuntimeError, match="open-loop client died"):
        client.join(timeout=30)
    assert client.submitted == 2
    assert isinstance(client.error, ValueError)


def test_transfer_never_clobbers_terminal_phase(setup):
    """tests/test_async_runtime.py:225."""
    ac = _async(setup, n_prefill=1, n_decode=1)
    try:
        cancelled = Request(rid="race0", prompt_len=8, decode_len=4)
        cancelled.phase = Phase.CANCELLED
        cancelled.t_finish = 0.5
        ac._reqs[cancelled.rid] = cancelled
        ac._cancelled.add(cancelled.rid)
        ac._transfer(PrefillOutcome(req=cancelled, first_token=1,
                                    transfer_delay_s=0.0), 0)
        assert cancelled.phase == Phase.CANCELLED
        assert cancelled.t_finish == 0.5

        stale = Request(rid="race1", prompt_len=8, decode_len=4)
        stale.retries = 1          # a recovery superseded attempt 0
        ac._reqs[stale.rid] = stale
        ac._transfer(PrefillOutcome(req=stale, first_token=1,
                                    transfer_delay_s=0.0), 0)
        assert stale.phase == Phase.WAITING
    finally:
        ac.close()


# -- sampling ----------------------------------------------------------------
def _sampled_requests(cfg):
    rng = np.random.default_rng(5)
    reqs = []
    for i in range(4):
        sp = SamplingParams(max_new_tokens=6) if i < 2 else SamplingParams(
            max_new_tokens=6, temperature=0.8, top_k=20, seed=40 + i)
        reqs.append(Request(
            rid=f"s{i}", prompt_len=10 + i, decode_len=6,
            prompt_tokens=rng.integers(
                1, cfg.vocab_size, size=10 + i).astype(np.int32),
            sampling=sp))
    return reqs


def test_sampling_identical_on_async_runtime(setup):
    """tests/test_async_runtime.py:321: slot placement and thread
    interleaving do not perturb sampled streams (the port's sync Cluster
    against its AsyncCluster; greedy lanes also against the
    reference's)."""
    cfg, rcfg, ref_params, params = setup
    sync = Cluster(cfg, runtime="engine", params=params, device="cpu",
                   n_prefill=1, n_decode=1, **CLUSTER)
    hs = [sync.submit(request=r) for r in _sampled_requests(cfg)]
    sync.run()
    want = {h.rid: h.result().tokens for h in hs}
    with _async(setup) as ac:
        _, got = _serve(ac, _sampled_requests(cfg))
        _assert_clean(ac)
    assert got == want
    ref = RefCluster(rcfg, runtime="engine", params=ref_params,
                     n_prefill=1, n_decode=1, **CLUSTER)
    from repro.runtime.request import Request as RefRequest
    from repro.runtime.request import SamplingParams as RefSP
    rh = [ref.submit(request=RefRequest(
        rid=r.rid, prompt_len=r.prompt_len, decode_len=r.decode_len,
        prompt_tokens=r.prompt_tokens, sampling=RefSP(max_new_tokens=6)))
        for r in _sampled_requests(cfg)[:2]]
    ref.run()
    assert {h.rid: h.result().tokens for h in rh} == {
        k: got[k] for k in ("s0", "s1")}


# -- thread safety of shared state -------------------------------------------
def test_paged_allocator_concurrent_hammer():
    """tests/test_async_runtime.py:337, with a short switch interval."""
    alloc = PagedAllocator(n_pages=512, page_size=16)
    errors = []

    def worker(w):
        try:
            rng = np.random.default_rng(w)
            for it in range(60):
                rid = f"w{w}-{it}"
                need = int(rng.integers(1, 5))
                try:
                    if not alloc.can_admit(need * 16):
                        continue
                    alloc.alloc(rid, need * 16)
                except OutOfPages:      # a racing thread won the pages
                    continue
                for _ in range(int(rng.integers(0, 20))):
                    alloc.append_token(rid)
                alloc.take_cow_copies()
                alloc.free(rid)
        except Exception as e:
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert alloc.free_pages == alloc.n_pages


def test_kernel_shared_state_under_threads(monkeypatch):
    """The wrappers' launch counters lose no update, and each stream gets
    a workspace of its own whose counters start at zero, under a
    16-thread hammer with a short switch interval."""

    def wrapper():
        pass
    wrapper.launches = 0
    wrapper.tensor_core_launches = 0
    monkeypatch.setattr(build, "_workspaces", {})
    dev = torch.device("cpu")
    seen = {}

    def worker(w):
        for i in range(500):
            build.count(wrapper, "launches", "tensor_core_launches")
        part, counters = build.workspace(dev, w % 4, 64 * (w + 1), 8 + w)
        seen[w] = (part.data_ptr(), counters)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == wrapper.tensor_core_launches == 16 * 500
    assert sorted(k[1] for k in build._workspaces) == [0, 1, 2, 3]
    for (_, stream), (part, counters) in build._workspaces.items():
        assert part.numel() >= 64 * (13 + stream)
        assert counters.numel() >= 8 + 12 + stream
        assert not counters.any()


# -- worker errors -----------------------------------------------------------
def test_worker_error_is_recorded_and_its_requests_recover(setup,
                                                           monkeypatch):
    """An engine exception no fault injected fences its instance, its
    requests re-prefill on the survivor and finish, and the exception
    lands in ``worker_errors`` (not hidden as a tolerated fault)."""
    reqs = _port_requests(_workload(seed=6, n=4))
    with _async(setup, n_prefill=2, n_decode=1) as ac:
        bad = ac.instances[0]

        def boom(now):
            raise RuntimeError("kernel launch failed (injected by test)")
        monkeypatch.setattr(bad, "prefill_complete", boom)
        monkeypatch.setattr(threading, "excepthook", lambda args: None)
        hs = [ac.submit(request=r) for r in reqs]
        assert ac.drain(timeout=DRAIN_S)
        assert bad.iid in ac._dead
        assert len(ac.worker_errors) == 1
        assert "kernel launch failed" in ac.worker_errors[0]
        assert all(h.result(wait=False).phase == Phase.FINISHED
                   for h in hs)
        _assert_no_leaks(ac)
