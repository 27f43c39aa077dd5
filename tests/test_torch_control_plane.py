"""The port's host-only control plane against the reference's copies:
the flip machine, the global scheduler and cluster monitor, the oracle
length predictor, the fault plane and recovery policy, the workload
generator and the observability plane (tracer export, histograms,
``summarize(slo=)``).  Each is driven through the same calls on both
sides and must give the same results, draw for draw.
"""
import dataclasses

import numpy as np
import pytest

from repro_torch.core import predictor as TP
from repro_torch.core.sched import flip as TF
from repro_torch.core.sched import global_scheduler as TG
from repro_torch.obs import metrics as TM
from repro_torch.obs import slo as TS
from repro_torch.obs import tracer as TT
from repro_torch.runtime import request as TR
from repro_torch.runtime import workload as TW
from repro_torch.serving import faults as TFa


@pytest.fixture(scope="module")
def ref():
    """The reference's modules (JAX-free ones; imported lazily so the
    module still collects where the reference is absent)."""
    pytest.importorskip("jax")
    import importlib
    return {name: importlib.import_module(f"repro.{name}") for name in (
        "core.predictor", "core.sched.flip", "core.sched.global_scheduler",
        "obs.metrics", "obs.slo", "obs.tracer", "runtime.request",
        "runtime.workload", "serving.faults")}


def _fields(obj):
    """A dataclass as a plain dict, enums as their values and arrays as
    lists, so the port's and the reference's compare."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if hasattr(v, "value") and not isinstance(v, (int, float)):
            v = v.value
        elif isinstance(v, np.ndarray):
            v = (str(v.dtype), v.tolist())
        out[f.name] = v
    return out


@pytest.mark.parametrize("role", ["prefill", "decode"])
def test_flip_machine_matches_reference(ref, role):
    R = ref["core.sched.flip"]
    machines = [(TF, TF.FlipMachine(TF.Role(role))),
                (R, R.FlipMachine(R.Role(role)))]
    trace = []
    for mod, m in machines:
        steps = []
        for now, op in ((0.0, "complete"), (0.1, "begin"),
                        (0.2, "complete"), (0.3, "drained"),
                        (0.301, "complete"), (0.31, "complete"),
                        (0.4, "begin"), (0.5, "drained"),
                        (0.6, "complete")):
            if op == "begin":
                m.begin_flip()
                done = None
            elif op == "drained":
                m.drained(now)
                done = None
            else:
                done = m.maybe_complete(now)
            steps.append((done, m.role.value, m.state.value, m.accepting,
                          m.flip_done_at, m.flips))
        trace.append(steps)
    assert trace[0] == trace[1]
    assert TF.FLIP_LATENCY_S == R.FLIP_LATENCY_S


@pytest.mark.parametrize("max_queued", [None, 40])
def test_global_scheduler_and_monitor_match_reference(ref, max_queued):
    G, Rq = ref["core.sched.global_scheduler"], ref["runtime.request"]
    runs = []
    for gmod, rmod in ((TG, TR), (G, Rq)):
        gs = gmod.GlobalScheduler(max_queued_tokens=max_queued)
        mon = gmod.ClusterMonitor(interval_s=0.1, flip_idle_s=0.25,
                                  heartbeat_timeout_s=0.3)
        out = []
        loads = {"i0": 0, "i1": 12}
        for k in range(6):
            req = rmod.Request(rid=f"r{k}", prompt_len=10 + 7 * k,
                               decode_len=5)
            shed = gs.overloaded(loads)
            iid = None if shed else gs.route(req, loads)
            if iid is not None:
                loads[iid] += req.prompt_len
                gs.note_dispatch(req.rid, f"i{2 + k % 2}")
                if k % 3 == 0:
                    req.phase = rmod.Phase.FINISHED
            out.append((shed, iid, dict(loads)))
            now = 0.1 * k
            mon.heartbeat("i0", now)
            if k < 2:
                mon.heartbeat("i2", now)
            mon.report_prefill("i0", loads["i0"] if k < 3 else 0, now)
            mon.report_prefill("i1", 0, now)
            mon.report_decode("i2", dict(free_pages=20 - k, n_heavy=k % 2,
                                         n_light=1, queued=0,
                                         batch=0 if k > 3 else 1), now)
            out.append((sorted(mon.silent(now)),
                        sorted(mon.flip_candidates(now)),
                        {i: dataclasses.asdict(d)
                         for i, d in mon.broadcast().items()}))
            if k == 4:
                mon.forget("i2")
        out.append((gs.shed, sorted(r.rid for r in gs.finished()),
                     {rid: (e.prefill_iid, e.decode_iid)
                      for rid, e in gs.table.items()}))
        runs.append(out)
    assert runs[0] == runs[1]


@pytest.mark.parametrize("accuracy,granularity,seed", [
    (0.749, 200, 0), (0.5, 100, 3), (1.0, 400, 7)])
def test_oracle_predictor_matches_reference(ref, accuracy, granularity,
                                            seed):
    P = ref["core.predictor"]
    lens = np.random.default_rng(seed).integers(1, 3000, 64)
    got, want = (
        [mod.OraclePredictor(accuracy, granularity, seed=seed)
         .predict_range(None, int(n)) for n in lens] for mod in (TP, P))
    assert list(got) == list(want)
    assert [TP.bucket_of(int(n), granularity) for n in lens] == \
        [P.bucket_of(int(n), granularity) for n in lens]
    assert TP.bucket_range(3, granularity) == P.bucket_range(3, granularity)


@pytest.mark.parametrize("spec", [
    dict(seed=0, drop_kv=0.1, corrupt_kv=0.05, delay_kv=0.2, delay_s=0.01),
    dict(seed=5, drop_kv=0.4),
    dict(seed=9)])
def test_fault_plane_and_recovery_match_reference(ref, spec):
    F = ref["serving.faults"]
    planes = [mod.FaultSpec(**spec).plane() for mod in (TFa, F)]
    draws = [[p.transfer_outcome(f"r{k:05d}", a) for k in range(200)
              for a in range(3)] for p in planes]
    assert draws[0] == draws[1]
    assert planes[0].stats() == planes[1].stats()
    pol = [mod.RecoveryPolicy(retry_backoff_s=0.01, backoff_factor=3.0)
           for mod in (TFa, F)]
    assert [pol[0].backoff(a) for a in range(6)] == \
        [pol[1].backoff(a) for a in range(6)]
    assert dataclasses.asdict(TFa.RecoveryPolicy()) == \
        dataclasses.asdict(F.RecoveryPolicy())
    ev = [mod.FaultEvent(t=0.5, kind=mod.HANG, iid="i1", duration=0.2)
          for mod in (TFa, F)]
    assert dataclasses.asdict(ev[0]) == dataclasses.asdict(ev[1])
    for mod in (TFa, F):
        with pytest.raises(AssertionError):
            mod.FaultSpec(drop_kv=0.7, corrupt_kv=0.7)


@pytest.mark.parametrize("workload,kw", [
    ("Mixed", dict(n=16, seed=0, max_prompt=48, max_decode=12,
                   vocab_size=512)),
    ("HPLD", dict(n=8, seed=3, arrival_rate=5.0)),
    ("LPHD", dict(n=6, seed=1, vocab_size=100, enc_ctx=4, enc_dim=3)),
    ("Mixed", dict(n=12, seed=2, vocab_size=64, prefix_pool=3,
                   prefix_len=8)),
])
def test_workload_generator_matches_reference(ref, workload, kw):
    W = ref["runtime.workload"]
    got, want = TW.generate(workload, **kw), W.generate(workload, **kw)
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert np.array_equal(TW.length_histogram(got),
                          W.length_histogram(want))


def test_observability_plane_matches_reference(ref):
    """The same emissions give the same JSONL and Perfetto documents,
    histogram summaries and SLO-aware summaries on both sides."""
    Tt, Mm, Ss, Rq = (ref[k] for k in ("obs.tracer", "obs.metrics",
                                       "obs.slo", "runtime.request"))
    docs = []
    for tmod, mmod, smod, rmod in ((TT, TM, TS, TR), (Tt, Mm, Ss, Rq)):
        tr = tmod.Tracer(clock="virtual")
        tr.span("prefill_chunk", "i0", 0.0, 0.01)
        tr.span("queued", "i0", 0.0, 0.02, rid="r1")
        tr.instant("finished", "i2", 0.3, rid="r1")
        tr.counter("load", "i0", 0.1, free_pages=9, decode_queued=1)
        reg = mmod.MetricsRegistry()
        reqs = []
        for k in range(5):
            r = rmod.Request(rid=f"r{k}", prompt_len=8, decode_len=4,
                             arrival=0.01 * k)
            r.phase = rmod.Phase.FINISHED if k < 4 else rmod.Phase.FAILED
            r.t_prefill_start, r.t_first_token = 0.05 * k, 0.06 * k + 0.01
            r.t_transfer_done, r.t_decode_start = r.t_first_token, 0.1 * k
            r.t_finish, r.generated = 0.2 + 0.1 * k, 3
            mmod.observe_request(reg, r)
            reqs.append(r)
        snap = reg.snapshot()
        slo = smod.SLOSpec(ttft_target_s=0.1, tbt_target_s=0.1)
        docs.append((tr.to_jsonl_records(), tr.to_perfetto(),
                     tmod.validate_chains(tr.to_jsonl_records()),
                     snap["counters"], snap["histograms"],
                     rmod.summarize(reqs), rmod.summarize(reqs, slo=slo),
                     rmod.summarize(reqs[4:], slo=slo)))
    assert docs[0] == docs[1]
