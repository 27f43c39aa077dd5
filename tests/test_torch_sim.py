"""The port's cost-model runtime against the reference's, bit for bit.

``param_count`` against the reference's for every registry config;
``CostModel``'s three iteration times on a grid of shapes; the four
scenarios of tests/golden_sim_metrics.json through
``Cluster(runtime="sim")`` and ``DisaggSimulator``; and every sim
scenario of the reference's own tests (tests/test_serving_cluster.py,
tests/test_prefix_cache.py, tests/test_fault_tolerance.py,
tests/test_obs.py) run on both packages from the same requests.  Each
scenario is a function of one API (``repro`` or ``repro_torch``), checks
what the reference's test checks, and returns a record of the run:
every request's phase, counters and timestamps, token streams, instance
assignment, per-instance busy seconds, flips, swaps and pages, network
bytes and retransmits, fault-plane draws, ``events_processed`` and the
result's metrics.  Floats are compared with ``==``: the port must do
the same arithmetic in the same order.
"""
import copy
import importlib
import json
import os
import types

import pytest
import torch

pytest.importorskip("jax")

from repro_torch.configs import ARCH_IDS  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__),
                      "golden_sim_metrics.json")


def _api(pkg):
    """The sim-facing API of ``pkg`` ("repro" or "repro_torch"), with
    OPT-13B priced on the paper's testbed as the reference's tests do."""
    mod = {name: importlib.import_module(f"{pkg}.{name}") for name in (
        "configs", "serving", "serving.faults", "runtime.request",
        "runtime.workload", "runtime.costmodel", "runtime.simulator",
        "core.predictor", "core.sched.flip", "obs")}
    cm = mod["runtime.costmodel"]
    cfg = mod["configs"].get_config("opt_13b")
    cost = cm.CostModel(cfg, cm.HardwareSpec.v100_tp2(),
                        n_params=13_000_000_000)
    serving = mod["serving"]
    S = types.SimpleNamespace(
        pkg=pkg, cfg=cfg, cost=cost, cm=cm,
        Cluster=serving.Cluster, SamplingParams=serving.SamplingParams,
        FaultSpec=serving.FaultSpec, FaultEvent=serving.FaultEvent,
        RecoveryPolicy=serving.RecoveryPolicy,
        ClusterStallError=serving.ClusterStallError,
        Tracer=mod["obs"].Tracer, MetricsRegistry=mod["obs"].MetricsRegistry,
        validate_chains=mod["obs"].validate_chains,
        CRASH=mod["serving.faults"].CRASH, HANG=mod["serving.faults"].HANG,
        Phase=mod["runtime.request"].Phase,
        TERMINAL=mod["runtime.request"].TERMINAL_PHASES,
        Role=mod["core.sched.flip"].Role,
        OraclePredictor=mod["core.predictor"].OraclePredictor,
        DisaggSimulator=mod["runtime.simulator"].DisaggSimulator,
        CoupledSimulator=mod["runtime.simulator"].CoupledSimulator,
        generate=mod["runtime.workload"].generate)
    S.cluster = lambda **kw: S.Cluster(cfg, runtime="sim", cost=cost, **kw)
    return S


@pytest.fixture(scope="module")
def apis():
    return _api("repro"), _api("repro_torch")


@pytest.fixture(scope="module")
def reference(apis):
    """(scenario, argument) -> the reference's record, each run once."""
    runs = {}

    def get(fn, *args):
        key = (fn.__name__,) + args
        if key not in runs:
            runs[key] = fn(apis[0], *args)
        return runs[key]
    return get


def _same(fn, apis, reference, *args):
    got, want = fn(apis[1], *args), reference(fn, *args)
    assert set(got) == set(want)
    for key in want:
        assert got[key] == want[key], key
    return got


# -- records ------------------------------------------------------------------
_REQ_FIELDS = (
    "prompt_len", "decode_len", "arrival", "prefix_id", "prefix_len",
    "cached_prefix_tokens", "cached_prefix_pages", "predicted_bucket",
    "predicted_hi", "predicted_lo", "prefilled", "generated", "swapped",
    "retries", "error", "t_prefill_start", "t_first_token",
    "t_transfer_done", "t_decode_start", "t_finish")


def _record(cluster, result=None, handles=(), tracer=None, metrics=None):
    res = result if result is not None else cluster.result()
    rec = dict(
        requests={rid: dict({f: getattr(r, f) for f in _REQ_FIELDS},
                            phase=r.phase.value)
                  for rid, r in cluster._reqs.items()},
        tokens={h.rid: h.result(wait=False).tokens for h in handles},
        assignment={rid: (e.prefill_iid, e.decode_iid)
                    for rid, e in cluster.gsched.table.items()},
        instances={i.iid: dict(role=i.flip.role.value, flips=i.flip.flips,
                               busy=i.busy, swaps=i.swaps,
                               free=i.alloc.free_pages,
                               swap_events=i.alloc.swap_events,
                               cache_hits=i.alloc.cache_hits)
                   for i in cluster.instances},
        network=(cluster.network.bytes_sent, cluster.network.bytes_saved,
                 cluster.network.retransmits),
        metrics=res.metrics, resource_time=res.resource_time,
        prefill_busy=res.prefill_busy, decode_busy=res.decode_busy,
        swaps=res.swap_events, flips=res.flips,
        dead=sorted(cluster._dead), now=cluster._now,
        events=cluster.events_processed, shed=cluster.gsched.shed,
        faults=(cluster.fault_plane.stats()
                if cluster.fault_plane is not None else None))
    if tracer is not None:
        rec["trace"] = tracer.to_jsonl_records()
    if metrics is not None:
        rec["registry"] = metrics.snapshot()
    return rec


def _no_leaks(cluster):
    for i in cluster.instances:
        assert i.alloc.free_pages == i.alloc.n_pages, i.iid


def _pump_until(cluster, pred, cap=10_000):
    for _ in range(cap):
        if pred():
            return True
        if not cluster._pump():
            return False
    return False


def _snap(r):
    return {"metrics": r.metrics, "resource_time": r.resource_time,
            "prefill_busy": r.prefill_busy, "decode_busy": r.decode_busy,
            "swap_events": r.swap_events, "flips": r.flips}


def _matches_golden(r, name):
    want = json.load(open(GOLDEN))[name]
    got = _snap(r)
    for k, v in want["metrics"].items():
        assert got["metrics"][k] == v, k
    for k in ("resource_time", "prefill_busy", "decode_busy",
              "swap_events", "flips"):
        assert got[k] == want[k], k


# -- param_count and the cost model -------------------------------------------
@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_matches_reference(arch, size):
    """Counted on the meta device: DeepSeek-V2's 236 G allocate
    nothing; tied heads, encoders and frontends as the reference."""
    from repro.configs import get_config as rget
    from repro.configs import get_smoke_config as rsmoke
    from repro.models.model import param_count as ref_count
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.model import param_count
    get, rg = ((get_config, rget) if size == "full"
               else (get_smoke_config, rsmoke))
    assert param_count(get(arch)) == ref_count(rg(arch))


_GRID_TOKENS = (1, 7, 64, 511, 512, 513, 2048, 8192)
_GRID_CTX = (0, 1, 100, 4096, 65_536)
_GRID_BATCH = (0, 1, 3, 16, 64, 256)


@pytest.mark.parametrize("hw", ["v100_tp2", "tpu_v5e"])
@pytest.mark.parametrize("arch", ["opt_13b", "deepseek_v2_236b",
                                  "recurrentgemma_9b", "whisper_tiny",
                                  "llama_3_2_vision_11b"])
def test_cost_model_times_match_reference(apis, arch, hw):
    """prefill_time, decode_time and mixed_time on a grid of shapes,
    twice each (the second read comes from the memo), with the exact
    parameter count (no ``n_params``) and with OPT-13B's 13 G."""
    ref, port = apis
    from repro.configs import get_config as rget
    from repro_torch.configs import get_config
    for n_params in (0, 13_000_000_000):
        a = ref.cm.CostModel(rget(arch), getattr(ref.cm.HardwareSpec, hw)(),
                             n_params=n_params)
        b = port.cm.CostModel(get_config(arch),
                              getattr(port.cm.HardwareSpec, hw)(),
                              n_params=n_params)
        assert (a.n_params, a.weight_bytes, a._kv_per_tok, a._attn_coeff) \
            == (b.n_params, b.weight_bytes, b._kv_per_tok, b._attn_coeff)
        for _ in range(2):
            for t in _GRID_TOKENS:
                for c in _GRID_CTX:
                    assert a.prefill_time(t, c) == b.prefill_time(t, c)
            for n in _GRID_BATCH:
                for c in _GRID_CTX:
                    assert a.decode_time(n, c * max(1, n)) \
                        == b.decode_time(n, c * max(1, n))
                    for t in (0, 64, 512, 2048):
                        assert a.mixed_time(t, n, c * n) \
                            == b.mixed_time(t, n, c * n)
        for co in (True, False):
            assert a.predictor_overhead(co) == b.predictor_overhead(co)


def test_h100_spec():
    """The port's target: the H100 SXM data sheet, scaled by chips."""
    from repro_torch.runtime.costmodel import HardwareSpec
    one, four = HardwareSpec.h100(), HardwareSpec.h100(chips=4)
    assert (one.peak_flops, one.hbm_bw, one.saturate_tokens,
            one.dtype_bytes) == (989e12, 3.35e12, 512, 2)
    assert (four.peak_flops, four.hbm_bw) == (4 * 989e12, 4 * 3.35e12)
    assert one.name == "h100-x1" and four.name == "h100-x4"


# -- the golden scenarios: (Cluster keywords, requests) -----------------------
def mixed64(S):
    reqs = S.generate("Mixed", 64, seed=1)
    return dict(n_prefill=1, n_decode=1), reqs


def lphd_greedy(S):
    reqs = S.generate("LPHD", 96, seed=3, max_decode=1500)
    return dict(n_prefill=1, n_decode=1, n_pages=512, page_size=16,
                max_batch=64, decode_policy="greedy"), reqs


def flip_multi(S):
    reqs = S.generate("Mixed", 48, seed=2)
    return dict(n_prefill=2, n_decode=2, max_batch=64, enable_flip=True,
                flip_idle_s=1.0,
                predictor=S.OraclePredictor(0.749, seed=5)), reqs


def hpld_rs(S):
    reqs = S.generate("HPLD", 40, seed=7)
    return dict(n_prefill=1, n_decode=2, prefill_policy="ljf",
                sched_batch=8, decode_policy="reserve-static",
                dispatch_policy="random"), reqs


GOLDEN_SCENARIOS = {f.__name__: f for f in (mixed64, lphd_greedy,
                                            flip_multi, hpld_rs)}


def golden_run(S, name, via):
    """The golden scenario ``name`` through ``Cluster`` or the
    ``DisaggSimulator`` shim, held to the golden file."""
    kw, reqs = GOLDEN_SCENARIOS[name](S)
    if via == "cluster":
        cluster = S.cluster(**kw)
        r = cluster.serve(copy.deepcopy(reqs))
    else:
        sim = S.DisaggSimulator(S.cfg, S.cost, **kw)
        r = sim.run(copy.deepcopy(reqs))
        cluster = sim.cluster
    _matches_golden(r, name)
    if name == "lphd_greedy":
        assert r.swap_events > 0
    return _record(cluster, r)


@pytest.mark.parametrize("via", ["cluster", "shim"])
@pytest.mark.parametrize("name", list(GOLDEN_SCENARIOS))
def test_golden_scenarios(apis, reference, name, via):
    _same(golden_run, apis, reference, name, via)


# -- the reference's sim scenarios --------------------------------------------
def policy_matrix(S, policies):
    """Every prefill x decode x dispatch policy on a small pool, so the
    greedy decode policy swaps."""
    prefill, decode, dispatch = policies.split("/")
    reqs = S.generate("Mixed", 32, seed=11, max_decode=600)
    cluster = S.cluster(n_prefill=2, n_decode=2, n_pages=384,
                        sched_batch=4, prefill_policy=prefill,
                        decode_policy=decode, dispatch_policy=dispatch,
                        enable_flip=True, flip_idle_s=0.5)
    r = cluster.serve(copy.deepcopy(reqs))
    assert r.metrics["n"] == 32
    _no_leaks(cluster)
    return _record(cluster, r)


POLICIES = [f"{p}/{d}/{x}" for p in ("fcfs", "sjf", "ljf")
            for d in ("greedy", "reserve-static", "reserve-dynamic")
            for x in ("power2", "random", "imbalance")]


@pytest.mark.parametrize("policies", POLICIES)
def test_policy_matrix(apis, reference, policies):
    _same(policy_matrix, apis, reference, policies)


def stashed_to_decode(S):
    """tests/test_serving_cluster.py:101: no decode instance at
    prefill-done time; the stashed requests wait for a flip."""
    reqs = S.generate("LPLD", 8, seed=0)
    cluster = S.cluster(n_prefill=2, n_decode=0, enable_flip=True,
                        flip_idle_s=0.3)
    r = cluster.serve(copy.deepcopy(reqs))
    assert r.metrics["n"] == 8 and r.flips >= 1
    for req in r.requests:
        assert req.prefilled == req.prompt_len
        assert req.t_first_token <= req.t_transfer_done
    return _record(cluster, r)


def cancel_chunk_in_flight(S):
    """tests/test_serving_cluster.py:120."""
    cluster = S.cluster()
    h1 = cluster.submit(prompt_tokens=list(range(40)),
                        sampling=S.SamplingParams(max_new_tokens=4))
    h2 = cluster.submit(prompt_tokens=list(range(24)),
                        sampling=S.SamplingParams(max_new_tokens=4))
    assert cluster._pump()          # arrival -> chunk in flight
    assert h1.cancel()
    cluster.run()
    assert h1.result().phase == S.Phase.CANCELLED
    assert h2.result().phase == S.Phase.FINISHED
    assert len(h2.result().tokens) == 4
    _no_leaks(cluster)
    return _record(cluster, handles=(h1, h2))


def transfer_timestamps(S):
    """tests/test_serving_cluster.py:139."""
    reqs = S.generate("Mixed", 32, seed=5)
    cluster = S.cluster()
    r = cluster.serve(copy.deepcopy(reqs))
    assert r.metrics["avg_transfer"] > 0
    for req in r.requests:
        assert req.t_transfer_done >= req.t_first_token >= 0
        assert req.t_decode_start >= req.t_transfer_done
    return _record(cluster, r)


def stop_ids_only(S):
    """tests/test_serving_cluster.py:325: no token ids on the sim, so a
    stop-ids-only request ends at its decode_len bound."""
    cluster = S.cluster(max_seq=256)
    h = cluster.submit(prompt_tokens=list(range(32)),
                       sampling=S.SamplingParams(stop_token_ids=(2,)))
    res = h.result()
    assert res.phase == S.Phase.FINISHED
    assert len(res.tokens) == h.request.decode_len + 1
    return _record(cluster, handles=(h,))


def sampling_params(S):
    """tests/test_serving_cluster.py:339, plus ignore_eos and a cap of
    one.  The reference's sim runs one decode step before it checks the
    cap, so a cap of one streams two placeholders there; the port keeps
    that."""
    cluster = S.cluster()
    hs = [cluster.submit(prompt_tokens=list(range(64)),
                         sampling=S.SamplingParams(max_new_tokens=9)),
          cluster.submit(prompt_tokens=list(range(300)),
                         sampling=S.SamplingParams(
                             max_new_tokens=5, stop_token_ids=(1, 2),
                             ignore_eos=True)),
          cluster.submit(prompt_tokens=list(range(17)),
                         sampling=S.SamplingParams(max_new_tokens=1))]
    cluster.run()
    assert [len(h.result().tokens) for h in hs] == [9, 5, 2]
    for h in hs:
        res = h.result()
        assert res.phase == S.Phase.FINISHED
        assert res.t_finish >= res.t_first_token >= 0
    return _record(cluster, handles=hs)


def cancel_during_transfer(S):
    """tests/test_serving_cluster.py:360."""
    cluster = S.cluster()
    h = cluster.submit(prompt_tokens=list(range(48)),
                       sampling=S.SamplingParams(max_new_tokens=6))
    assert _pump_until(cluster,
                       lambda: h.request.phase is S.Phase.TRANSFER)
    assert h.cancel()
    cluster.run()
    assert h.result().phase == S.Phase.CANCELLED
    assert h.result().tokens == [-1]
    _no_leaks(cluster)
    for i in cluster.instances:
        assert i.decode_queue_len() == 0 and i.decode_idle()
    return _record(cluster, handles=(h,))


def flip_during_drain(S):
    """tests/test_serving_cluster.py:405."""
    cluster = S.cluster(n_prefill=2, n_decode=1)
    hs = [cluster.submit(prompt_tokens=list(range(64 + 8 * k)),
                         sampling=S.SamplingParams(max_new_tokens=5))
          for k in range(6)]
    i0 = cluster._inst("i0")
    assert _pump_until(cluster, lambda: not i0.prefill_idle())
    i0.flip.begin_flip()
    cluster.run()
    assert i0.flip.role == S.Role.DECODE and i0.flip.flips == 1
    for h in hs:
        assert h.result().phase == S.Phase.FINISHED
        assert len(h.result().tokens) == 5
        assert h.request.prefilled == h.request.prompt_len
    return _record(cluster, handles=hs)


def arrival_clamped(S):
    """tests/test_serving_cluster.py:450."""
    cluster = S.cluster()
    h0 = cluster.submit(prompt_tokens=list(range(32)),
                        sampling=S.SamplingParams(max_new_tokens=40))
    h0.result()
    now = cluster._now
    h = cluster.submit(prompt_tokens=list(range(16)), arrival=0.0,
                       sampling=S.SamplingParams(max_new_tokens=3))
    assert h.request.arrival == now > 0
    assert h.result().phase == S.Phase.FINISHED
    return _record(cluster, handles=(h0, h))


def cache_on_no_shared_prefixes(S):
    """tests/test_prefix_cache.py:319: the cache on and nothing to hit
    leaves the golden metrics as they are."""
    reqs = S.generate("Mixed", 64, seed=1)
    cluster = S.cluster(n_prefill=1, n_decode=1, prefix_cache=True)
    r = cluster.serve(copy.deepcopy(reqs))
    _matches_golden(r, "mixed64")
    return _record(cluster, r)


def shared_prefixes(S):
    """tests/test_prefix_cache.py:337: zipf-shared system prompts, the
    cache off then on."""
    reqs = S.generate("Mixed", 48, seed=5, prefix_pool=2, prefix_len=256)
    off = S.cluster(n_prefill=1, n_decode=1)
    r_off = off.serve(copy.deepcopy(reqs))
    on = S.cluster(n_prefill=1, n_decode=1, prefix_cache=True)
    r_on = on.serve(copy.deepcopy(reqs))
    assert r_on.metrics["pages_saved"] > 0
    assert 0.0 < r_on.metrics["cache_hit_rate"] < 1.0
    assert r_on.metrics["avg_ttft"] < r_off.metrics["avg_ttft"]
    return {"off": _record(off, r_off), "on": _record(on, r_on),
            "lru": [list(i._prefix_lru) for i in on.instances]}


def chaos_with_cache(S):
    """tests/test_prefix_cache.py:354: a decode instance killed with the
    cache on and prefixes shared."""
    reqs = S.generate("Mixed", 64, seed=1, prefix_pool=4, prefix_len=256)
    faults = S.FaultSpec(seed=0, drop_kv=0.1, events=(
        S.FaultEvent(t=2.0, kind=S.CRASH, iid="i3"),))
    cluster = S.cluster(n_prefill=2, n_decode=2, prefix_cache=True,
                        faults=faults)
    r = cluster.serve(copy.deepcopy(reqs))
    assert cluster._dead == {"i3"}
    assert r.metrics["n"] + r.metrics.get("failed", 0) == 64
    for i in cluster.instances:
        a = i.alloc
        assert a.free_pages + len(a.cache_pages()) == a.n_pages, i.iid
    return _record(cluster, r)


# tests/test_fault_tolerance.py:97-259, the seven sim scenarios
def chaos_decode_death(S):
    reqs = S.generate("Mixed", 64, seed=1)
    faults = S.FaultSpec(seed=0, drop_kv=0.1, events=(
        S.FaultEvent(t=2.0, kind=S.CRASH, iid="i3"),))
    cluster = S.cluster(n_prefill=2, n_decode=2, faults=faults)
    r = cluster.serve(copy.deepcopy(reqs))
    assert cluster._dead == {"i3"}
    for req in r.requests:
        assert req.phase in S.TERMINAL, (req.rid, req.phase)
    assert cluster.fault_plane.dropped > 0
    assert cluster.network.retransmits > 0
    assert r.metrics.get("recovered", 0) > 0
    assert r.metrics["n"] + r.metrics.get("failed", 0) == 64
    _no_leaks(cluster)
    return _record(cluster, r)


def hang_below_timeout(S):
    reqs = S.generate("Mixed", 16, seed=4)
    faults = S.FaultSpec(events=(
        S.FaultEvent(t=0.5, kind=S.HANG, iid="i0", duration=0.3),))
    cluster = S.cluster(n_prefill=1, n_decode=1, faults=faults)
    r = cluster.serve(copy.deepcopy(reqs))
    assert not cluster._dead and r.metrics["n"] == 16
    assert "failed" not in r.metrics and "recovered" not in r.metrics
    _no_leaks(cluster)
    return _record(cluster, r)


def hang_past_timeout(S):
    reqs = S.generate("Mixed", 16, seed=4)
    faults = S.FaultSpec(events=(
        S.FaultEvent(t=0.5, kind=S.HANG, iid="i0", duration=30.0),))
    cluster = S.cluster(n_prefill=2, n_decode=1, faults=faults)
    r = cluster.serve(copy.deepcopy(reqs))
    assert cluster._dead == {"i0"}
    assert r.metrics["n"] + r.metrics.get("failed", 0) == 16
    _no_leaks(cluster)
    return _record(cluster, r)


def permanent_drop(S):
    policy = S.RecoveryPolicy(max_retries=3)
    cluster = S.cluster(faults=S.FaultSpec(drop_kv=1.0), recovery=policy)
    r = cluster.serve(copy.deepcopy(S.generate("LPLD", 4, seed=2)))
    assert r.metrics["n"] == 0 and r.metrics["failed"] == 4
    assert r.metrics["failed_retries"] == 4 * (policy.max_retries + 1)
    for req in r.requests:
        assert req.phase == S.Phase.FAILED and "retry budget" in req.error
    assert cluster.network.retransmits == 4 * policy.max_retries
    _no_leaks(cluster)
    return _record(cluster, r)


def corrupt_and_delay(S):
    faults = S.FaultSpec(seed=3, corrupt_kv=0.3, delay_kv=0.3,
                         delay_s=0.05)
    cluster = S.cluster(faults=faults)
    r = cluster.serve(copy.deepcopy(S.generate("Mixed", 24, seed=6)))
    assert r.metrics["n"] == 24 and "failed" not in r.metrics
    assert cluster.fault_plane.corrupted > 0
    assert cluster.fault_plane.delayed > 0
    assert r.metrics.get("recovered", 0) > 0
    _no_leaks(cluster)
    return _record(cluster, r)


def overload_shedding(S):
    cluster = S.cluster(recovery=S.RecoveryPolicy(shed_queued_tokens=600))
    hs = [cluster.submit(prompt_tokens=list(range(512)),
                         sampling=S.SamplingParams(max_new_tokens=4))
          for _ in range(4)]
    cluster.run()
    shed = [h for h in hs if h.result().phase == S.Phase.FAILED]
    assert cluster.gsched.shed == len(shed) > 0
    assert S.Phase.FINISHED in [h.result().phase for h in hs]
    _no_leaks(cluster)
    return _record(cluster, handles=hs)


def total_decode_loss(S):
    faults = S.FaultSpec(events=(
        S.FaultEvent(t=0.2, kind=S.CRASH, iid="i1"),))
    cluster = S.cluster(n_prefill=1, n_decode=1, faults=faults)
    r = cluster.serve(copy.deepcopy(S.generate("Mixed", 8, seed=9)))
    for req in r.requests:
        assert req.phase in S.TERMINAL
    assert r.metrics.get("failed", 0) > 0
    _no_leaks(cluster)
    return _record(cluster, r)


def stall_snapshot(S):
    """tests/test_fault_tolerance.py:242 and tests/test_obs.py:287: the
    stall error's snapshot, message and registry probe."""
    cluster = S.cluster(n_pages=2, page_size=16, max_seq=4096)
    h = cluster.submit(prompt_tokens=list(range(200)),
                       sampling=S.SamplingParams(max_new_tokens=8))
    with pytest.raises(S.ClusterStallError) as ei:
        cluster.run()
    snap = ei.value.snapshot
    assert set(snap) == {"i0", "i1"}
    assert snap["i1"]["decode_queued"] == 1
    assert "i1: role=decode" in str(ei.value)
    assert snap == cluster.metrics.probe("instances")
    return dict(_record(cluster, cluster.result(), handles=(h,)),
                snapshot=snap, message=str(ei.value))


def chaos_traced(S):
    """tests/test_obs.py:162: crash + drops under a virtual-clock tracer
    and a metrics registry; every trace record and the snapshot."""
    reqs = S.generate("Mixed", 32, seed=1)
    faults = S.FaultSpec(seed=0, drop_kv=0.1, events=(
        S.FaultEvent(t=2.0, kind=S.CRASH, iid="i3"),))
    tracer, metrics = S.Tracer(), S.MetricsRegistry()
    cluster = S.cluster(n_prefill=2, n_decode=2, faults=faults,
                        tracer=tracer, metrics=metrics)
    r = cluster.serve(copy.deepcopy(reqs))
    assert S.validate_chains(tracer.events) == []
    assert metrics.snapshot()["counters"]["kv_retransmits"] \
        == cluster.network.retransmits > 0
    return _record(cluster, r, tracer=tracer, metrics=metrics)


SCENARIOS = {f.__name__: f for f in (
    stashed_to_decode, cancel_chunk_in_flight, transfer_timestamps,
    stop_ids_only, sampling_params, cancel_during_transfer,
    flip_during_drain, arrival_clamped, cache_on_no_shared_prefixes,
    shared_prefixes, chaos_with_cache, chaos_decode_death,
    hang_below_timeout, hang_past_timeout, permanent_drop,
    corrupt_and_delay, overload_shedding, total_decode_loss,
    stall_snapshot, chaos_traced)}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sim_scenario_matches_reference(apis, reference, name):
    _same(SCENARIOS[name], apis, reference)


# -- the coupled baseline -----------------------------------------------------
def coupled(S, workload):
    """``CoupledSimulator`` as the cluster comparison runs it (2
    instances, batch 16); ``LPHD-pressure`` on a small pool, so it
    swaps."""
    pressure = workload.endswith("-pressure")
    reqs = S.generate(workload.split("-")[0], 64, seed=3)
    kw = dict(n_pages=256) if pressure else {}
    r = S.CoupledSimulator(S.cfg, S.cost, n_instances=2, prefill_batch=16,
                           max_batch=16, **kw).run(copy.deepcopy(reqs))
    assert r.metrics["n"] == 64
    assert (r.swap_events > 0) == pressure
    return dict(_snap(r), requests=[
        dict({f: getattr(q, f) for f in _REQ_FIELDS}, phase=q.phase.value)
        for q in r.requests])


@pytest.mark.parametrize("workload", ["LPLD", "LPHD", "HPLD", "HPHD",
                                      "Mixed", "LPHD-pressure"])
def test_coupled_simulator_matches_reference(apis, reference, workload):
    _same(coupled, apis, reference, workload)


# -- the sim runtime stays on the host ----------------------------------------
def test_cluster_sim_touches_no_device(apis, monkeypatch):
    """A sim Cluster with the default ``device="cuda"`` builds, serves
    and reports with every CUDA entry point made to raise."""
    def boom(*a, **k):
        raise AssertionError("the sim runtime touched torch.cuda")
    for name in ("is_available", "synchronize", "current_stream",
                 "device_count", "set_device", "Stream"):
        monkeypatch.setattr(torch.cuda, name, boom)
    S = apis[1]
    cluster = S.cluster(n_prefill=2, n_decode=2)
    assert cluster.device is None
    r = cluster.serve(copy.deepcopy(S.generate("Mixed", 16, seed=2)))
    assert r.metrics["n"] == 16
    _no_leaks(cluster)
