"""The port's ``Cluster(runtime="engine")`` against the reference's.

Each scenario below is a function of one serving API (the reference's
``repro.serving`` on JAX, or the port's ``repro_torch.serving`` on the
CPU) and runs the same requests on the same f32 qwen2 smoke weights
(the reference's ``init_params``, converted with
``params.from_reference``).  It checks the properties the reference's
own test of that case checks (tests/test_serving_cluster.py and
tests/test_fault_tolerance.py), on both, and returns a record of the
run.  The engine runtime bills a fixed virtual ``step_dt`` a step, so
the whole event sequence is a function of host logic and greedy tokens:
the two records must be equal — token streams, virtual timestamps,
prefill/decode instance assignment, flips, transfer bytes and
retransmits, fault-plane draws, ``result().metrics`` and, where a
virtual-clock tracer and a metrics registry are on, every trace record
and the registry snapshot.  Only ``busy`` (wall seconds) stays out.

Each reference run is computed once, in a module-scoped fixture.
"""
import copy
import dataclasses
import itertools
import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.params import from_reference  # noqa: E402

CLUSTER = dict(chunk_size=16, max_seq=128, max_batch=8, n_pages=256)


def _api(pkg):
    """The serving API of ``pkg`` ("repro" or "repro_torch") as a
    namespace the scenarios use."""
    import importlib
    mod = {name: importlib.import_module(f"{pkg}.{name}") for name in (
        "serving", "serving.faults", "runtime.request", "runtime.workload",
        "core.sched.flip")}
    return types.SimpleNamespace(
        Cluster=mod["serving"].Cluster,
        SamplingParams=mod["serving"].SamplingParams,
        FaultSpec=mod["serving"].FaultSpec,
        FaultEvent=mod["serving"].FaultEvent,
        Tracer=mod["serving"].Tracer,
        MetricsRegistry=mod["serving"].MetricsRegistry,
        CRASH=mod["serving.faults"].CRASH,
        Phase=mod["runtime.request"].Phase,
        TERMINAL=mod["runtime.request"].TERMINAL_PHASES,
        Role=mod["core.sched.flip"].Role,
        generate=mod["runtime.workload"].generate)


@pytest.fixture(scope="module")
def apis():
    import jax

    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import model as RM
    ref_cfg = dataclasses.replace(ref_smoke("qwen2_0_5b"), dtype="float32")
    ref_params = RM.init_params(jax.random.PRNGKey(0), ref_cfg)
    cfg = dataclasses.replace(get_smoke_config("qwen2_0_5b"),
                              dtype="float32")
    params = from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                            device="cpu")

    def bind(api, cfg, params, extra):
        def cluster(**kw):
            opts = dict(CLUSTER, n_prefill=2, n_decode=2, **extra)
            opts.update(kw)
            return api.Cluster(cfg, runtime="engine", params=params,
                               **opts)
        api.cluster = cluster
        api.vocab = cfg.vocab_size
        return api
    return (bind(_api("repro"), ref_cfg, ref_params, {}),
            bind(_api("repro_torch"), cfg, params, {"device": "cpu"}))


@pytest.fixture(scope="module")
def reference(apis):
    """scenario name -> the reference's record, each run once."""
    runs = {}

    def get(name):
        if name not in runs:
            runs[name] = SCENARIOS[name](apis[0])
        return runs[name]
    return get


# -- records ------------------------------------------------------------------
def _record(S, cluster, handles, tracer=None, metrics=None):
    reqs = {}
    for h in handles:
        r = h.result()
        reqs[r.rid] = dict(
            phase=r.phase.value, tokens=[int(t) for t in r.tokens],
            arrival=r.arrival, t_prefill_start=r.t_prefill_start,
            t_first_token=r.t_first_token, t_transfer_done=r.t_transfer_done,
            t_decode_start=r.t_decode_start, t_finish=r.t_finish,
            retries=r.retries, error=r.error)
    res = cluster.result()
    rec = dict(
        requests=reqs,
        assignment={rid: (e.prefill_iid, e.decode_iid)
                    for rid, e in cluster.gsched.table.items()},
        instances={i.iid: dict(role=i.flip.role.value, flips=i.flip.flips,
                               chunk_steps=i.pe.chunk_steps,
                               fused_calls=i.pe.fused_calls,
                               iterations=i.de.iterations)
                   for i in cluster.instances},
        network=(cluster.network.bytes_sent, cluster.network.bytes_saved,
                 cluster.network.retransmits),
        metrics=res.metrics, flips=res.flips, swaps=res.swap_events,
        dead=sorted(cluster._dead), now=cluster._now,
        events=cluster.events_processed,
        faults=(cluster.fault_plane.stats()
                if cluster.fault_plane is not None else None))
    if tracer is not None:
        rec["trace"] = tracer.to_jsonl_records()
    if metrics is not None:
        rec["registry"] = metrics.snapshot()
    return rec


def _pages_back(cluster):
    """Every page back on the free list on every instance, both facets."""
    for i in cluster.instances:
        assert i.de.alloc.free_pages == i.de.alloc.n_pages, i.iid
        assert i.pe.alloc.free_pages == i.pe.alloc.n_pages, i.iid


def _pump_until(cluster, pred, cap=10_000):
    for _ in range(cap):
        if pred():
            return True
        if not cluster._pump():
            return False
    return False


def _prompts(S, seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, S.vocab, size=n).astype(np.int32)
            for n in sizes]


def _mixed(S, n=8, seed=0, max_prompt=48, max_decode=12):
    return S.generate("Mixed", n, seed=seed, max_prompt=max_prompt,
                      max_decode=max_decode, vocab_size=S.vocab)


# -- scenarios ------------------------------------------------------------------
def mixed_traced(S):
    """2 prefill + 2 decode instances, the Mixed workload, a virtual-
    clock tracer and a metrics registry on."""
    tracer, metrics = S.Tracer(clock="virtual"), S.MetricsRegistry()
    c = S.cluster(tracer=tracer, metrics=metrics)
    handles = [c.submit(request=r) for r in _mixed(S)]
    c.run()
    assert sum(1 for i in c.instances if i.pe.chunk_steps) == 2
    assert sum(1 for i in c.instances if i.de.iterations) == 2
    for h in handles:
        r = h.request
        assert h.result().phase == S.Phase.FINISHED
        assert 0 <= r.t_prefill_start <= r.t_first_token
        assert r.t_first_token <= r.t_transfer_done <= r.t_decode_start
        assert r.t_decode_start <= r.t_finish
    _pages_back(c)
    return _record(S, c, handles, tracer, metrics)


def auto_flips(S):
    """The flip watcher on: 2-slot decode batches leave decode backlog
    while prefill instances idle past ``flip_idle_s``, so they flip."""
    c = S.cluster(max_batch=2, enable_flip=True, flip_idle_s=0.02)
    handles = [c.submit(request=r) for r in _mixed(S)]
    c.run()
    assert c.result().flips > 0
    assert all(h.result().phase == S.Phase.FINISHED for h in handles)
    _pages_back(c)
    return _record(S, c, handles)


def streaming_order(S):
    """tests/test_serving_cluster.py:209."""
    c = S.cluster(n_prefill=1, n_decode=1)
    hs = [c.submit(p, sampling=S.SamplingParams(max_new_tokens=6))
          for p in _prompts(S, 1, (11, 23, 7))]
    streamed = list(hs[0])             # lazily pumps the event loop
    assert streamed == hs[0].result().tokens
    assert len(streamed) == 6
    c.run()
    for h in hs:
        res = h.result()
        assert res.phase == S.Phase.FINISHED
        assert len(res.tokens) == 6
        assert res.tokens == h.tokens_so_far()
    return dict(_record(S, c, hs), streamed=streamed)


def cancel_frees_pages(S):
    """tests/test_serving_cluster.py:229."""
    c = S.cluster(n_prefill=1, n_decode=1)
    long_p, short_p = _prompts(S, 2, (16, 9))
    free0 = [i.de.alloc.free_pages for i in c.instances]
    h_long = c.submit(long_p, sampling=S.SamplingParams(max_new_tokens=100))
    h_short = c.submit(short_p, sampling=S.SamplingParams(max_new_tokens=4))
    got = list(itertools.islice(iter(h_long), 3))   # mid-decode
    assert len(got) == 3
    assert h_long.cancel()
    c.run()
    assert h_long.result().phase == S.Phase.CANCELLED
    assert h_short.result().phase == S.Phase.FINISHED
    assert [i.de.alloc.free_pages for i in c.instances] == free0
    _pages_back(c)
    assert not h_long.cancel()          # idempotent: already terminal
    return dict(_record(S, c, [h_long, h_short]), streamed=got)


def no_tokens_after_cancel(S):
    """tests/test_serving_cluster.py:254: cancelling the only running
    request leaves a decode_done event in flight that must not replay
    stale stream events."""
    c = S.cluster(n_prefill=1, n_decode=1)
    h = c.submit(_prompts(S, 6, (12,))[0],
                 sampling=S.SamplingParams(max_new_tokens=50))
    got = list(itertools.islice(iter(h), 3))
    assert h.cancel()
    c.run()
    assert h.result().tokens == got
    _pages_back(c)
    return _record(S, c, [h])


def cancel_while_prefilling(S):
    """tests/test_serving_cluster.py:272."""
    c = S.cluster(n_prefill=1, n_decode=1)
    h = c.submit(_prompts(S, 3, (40,))[0],
                 sampling=S.SamplingParams(max_new_tokens=8))
    assert h.cancel()                   # still queued — nothing ran yet
    c.run()
    assert h.result().phase == S.Phase.CANCELLED
    assert h.result().tokens == []
    _pages_back(c)
    return _record(S, c, [h])


def stop_criteria(S):
    """tests/test_serving_cluster.py:288: the cap, stop ids (kept in the
    output), ignore_eos, and a stop on the prefill-emitted token."""
    c = S.cluster(n_prefill=1, n_decode=1)
    prompt = _prompts(S, 4, (13,))[0]
    sp = S.SamplingParams
    hs = [c.submit(prompt, sampling=sp(max_new_tokens=12))]
    ref = hs[0].result().tokens
    assert len(ref) == 12
    stop_tok = ref[5]
    hs.append(c.submit(prompt, sampling=sp(
        max_new_tokens=12, stop_token_ids=(stop_tok,))))
    assert hs[-1].result().tokens == ref[:ref.index(stop_tok) + 1]
    hs.append(c.submit(prompt, sampling=sp(
        max_new_tokens=12, stop_token_ids=(stop_tok,), ignore_eos=True)))
    assert hs[-1].result().tokens == ref
    hs.append(c.submit(prompt, sampling=sp(stop_token_ids=(ref[0],))))
    assert hs[-1].result().tokens == ref[:1]
    hs.append(c.submit(prompt, sampling=sp(max_new_tokens=1)))
    assert hs[-1].result().tokens == ref[:1]
    _pages_back(c)
    return _record(S, c, hs)


def cancel_during_transfer(S):
    """tests/test_serving_cluster.py:382: the in-flight KV payload of a
    cancelled request is dropped on arrival."""
    c = S.cluster(n_prefill=1, n_decode=1)
    p1, p2 = _prompts(S, 7, (18, 9))
    h = c.submit(p1, sampling=S.SamplingParams(max_new_tokens=10))
    h2 = c.submit(p2, sampling=S.SamplingParams(max_new_tokens=3))
    assert _pump_until(c, lambda: h.request.phase is S.Phase.TRANSFER)
    assert h.cancel()
    c.run()
    assert h.result().phase == S.Phase.CANCELLED
    assert h2.result().phase == S.Phase.FINISHED
    assert len(h2.result().tokens) == 3
    _pages_back(c)
    return _record(S, c, [h, h2])


def flip_during_drain(S):
    """tests/test_serving_cluster.py:430: a prefill instance told to flip
    while it holds queued work keeps prefilling while DRAINING and flips
    once empty; every request finishes."""
    c = S.cluster(n_prefill=2, n_decode=1)
    hs = [c.submit(p, sampling=S.SamplingParams(max_new_tokens=4))
          for p in _prompts(S, 8, (33, 21, 40, 17, 26, 12))]
    i0 = c._inst("i0")
    assert _pump_until(c, lambda: not i0.prefill_idle())
    i0.flip.begin_flip()
    c.run()
    assert i0.flip.role == S.Role.DECODE
    assert i0.flip.flips == 1
    for h in hs:
        assert h.result().phase == S.Phase.FINISHED
        assert len(h.result().tokens) == 4
    _pages_back(c)
    return _record(S, c, hs)


def chaos_recovery(S):
    """tests/test_fault_tolerance.py:282: a decode instance crashes
    mid-run and 10% of transfers drop; every finished request gives the
    fault-free run's tokens and every page comes back."""
    reqs = _mixed(S)
    base = S.cluster()
    want = {h.rid: h.result().tokens
            for h in [base.submit(request=r) for r in copy.deepcopy(reqs)]}
    faults = S.FaultSpec(seed=1, drop_kv=0.1, events=(
        S.FaultEvent(t=0.06, kind=S.CRASH, iid="i3"),))
    c = S.cluster(faults=faults)
    handles = [c.submit(request=r) for r in copy.deepcopy(reqs)]
    c.run()
    assert c._dead == {"i3"}
    n_recovered = 0
    for h in handles:
        res = h.result()
        assert res.phase in S.TERMINAL
        if res.phase == S.Phase.FINISHED:
            assert res.tokens == want[h.rid], h.rid
            n_recovered += res.retries > 0
        else:
            assert res.phase == S.Phase.FAILED and res.error
    assert n_recovered > 0
    _pages_back(c)
    return _record(S, c, handles)


def transfer_drop_retries(S):
    """tests/test_fault_tolerance.py:316: dropped first attempts retry
    within budget; every request finishes, retransmits on the wire."""
    c = S.cluster(n_prefill=1, n_decode=1,
                  faults=S.FaultSpec(seed=5, drop_kv=0.4))
    handles = [c.submit(request=r) for r in _mixed(
        S, n=6, seed=3, max_prompt=32, max_decode=8)]
    c.run()
    for h in handles:
        assert h.result().phase == S.Phase.FINISHED
    assert c.fault_plane.dropped > 0
    assert c.network.retransmits == c.fault_plane.dropped
    _pages_back(c)
    return _record(S, c, handles)


SCENARIOS = {f.__name__: f for f in (
    mixed_traced, auto_flips, streaming_order, cancel_frees_pages,
    no_tokens_after_cancel, cancel_while_prefilling, stop_criteria,
    cancel_during_transfer, flip_during_drain, chaos_recovery,
    transfer_drop_retries)}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_cluster_matches_reference(apis, reference, name):
    """The port's run of the scenario equals the reference's, key by
    key (each key named in the failure)."""
    got = SCENARIOS[name](apis[1])
    want = reference(name)
    assert set(got) == set(want)
    for key in want:
        assert got[key] == want[key], key


def prefix_cache_shared(S):
    """tests/test_prefix_cache.py:485 at the Cluster's level: the prefix
    cache on over shared-prefix traffic in waves of 2; hits on both
    facets, bytes saved, no page leaked (cache entries only)."""
    c = S.cluster(n_prefill=1, n_decode=1, chunk_size=8, max_seq=64,
                  max_batch=4, n_pages=128, page_size=4, sched_batch=2,
                  prefix_cache=True)
    handles = [c.submit(request=r) for r in S.generate(
        "Mixed", 8, seed=3, max_prompt=40, max_decode=6,
        vocab_size=S.vocab, prefix_pool=2, prefix_len=32,
        prefix_zipf=1.2)]
    c.run()
    assert all(h.result().phase == S.Phase.FINISHED for h in handles)
    assert c.network.bytes_saved > 0
    rec = _record(S, c, handles)
    rec["hits"] = [(i.pe.alloc.cache_hits, i.de.alloc.cache_hits)
                   for i in c.instances]
    assert min(map(sum, zip(*rec["hits"]))) > 0
    for i in c.instances:
        for a in (i.pe.alloc, i.de.alloc):
            assert a.free_pages + len(a.cache_pages()) == a.n_pages
    return rec


def test_cluster_refuses_what_is_not_ported(apis):
    """A sim Cluster without a cost model refuses to build with the
    reference's assertion (the sim runtime itself is held against the
    reference in tests/test_torch_sim.py); ``prefix_cache=True`` gives
    the reference's record."""
    port = apis[1]
    for api in apis:
        with pytest.raises(AssertionError,
                           match="sim runtime needs a CostModel"):
            api.Cluster(None, runtime="sim")
    got, want = prefix_cache_shared(port), prefix_cache_shared(apis[0])
    assert set(got) == set(want)
    for key in want:
        assert got[key] == want[key], key


def test_cluster_runs_on_the_device_it_is_given(apis):
    """Both facets of every instance hold their pools on the Cluster's
    device."""
    c = apis[1].cluster(n_prefill=1, n_decode=1)
    for i in c.instances:
        assert i.pe.pool.k.device == torch.device("cpu")
        assert i.de.pool.k.device == torch.device("cpu")
        assert i.pe.device == i.de.device == torch.device("cpu")
