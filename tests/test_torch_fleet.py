"""The port's fleet harness and cost-model entry points against the
reference's, bit for bit.

``generate_trace`` arrays for every arrival process and workload, trace
files saved by one package and loaded by the other, the format-version
check, ``run_fleet`` reports (equal except the wall-clock fields), the
``h100`` preset against the reference's cluster on the same constants,
``serve`` without ``--real`` (stdout and its ``--trace-jsonl`` and
``--metrics-out`` files) and ``python -m repro_torch.serve_cluster``
against ``examples/serve_cluster.py``.
"""
import contextlib
import io
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.fleet import harness as ref_harness  # noqa: E402
from repro.fleet import traces as ref_traces  # noqa: E402
from repro_torch.fleet import harness, traces  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reqs(requests):
    """Requests as plain dicts (each package has its own ``Phase``)."""
    return [dict(vars(r), phase=r.phase.value) for r in requests]


def _trace_equal(a, b):
    assert a.meta == b.meta
    for f in traces._ARRAY_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        assert np.array_equal(x, y), f


# -- traces -------------------------------------------------------------------
@pytest.mark.parametrize("workload", ["LPLD", "LPHD", "HPLD", "HPHD",
                                      "Mixed"])
@pytest.mark.parametrize("process", traces.PROCESSES)
def test_generate_trace_matches_reference(process, workload):
    kw = dict(seed=3, process=process, rate=50.0, period_s=40.0,
              n_tenants=4, max_prompt=1024, max_decode=512)
    got = traces.generate_trace(workload, 400, **kw)
    want = ref_traces.generate_trace(workload, 400, **kw)
    _trace_equal(got, want)
    assert got.summary() == want.summary()
    assert _reqs(got.to_requests("q")) == _reqs(want.to_requests("q"))


def test_trace_tables_and_requests_match_reference():
    assert traces.CLASS_NAMES == ref_traces.CLASS_NAMES
    assert traces.PROCESSES == ref_traces.PROCESSES
    assert traces.TRACE_FORMAT_VERSION == ref_traces.TRACE_FORMAT_VERSION
    rng_a, rng_b = np.random.default_rng(9), np.random.default_rng(9)
    assert np.array_equal(traces._vec_lognormal(rng_a, 100, 0.8, 50, 300),
                          ref_traces._vec_lognormal(rng_b, 100, 0.8, 50, 300))
    got = traces.generate_requests("Mixed", 64, seed=2, process="bursty",
                                   rate=10.0, period_s=5.0)
    want = ref_traces.generate_requests("Mixed", 64, seed=2,
                                        process="bursty", rate=10.0,
                                        period_s=5.0)
    assert _reqs(got) == _reqs(want)
    with pytest.raises(AssertionError, match="burst_factor"):
        traces.generate_trace("Mixed", 10, process="bursty",
                              burst_factor=5.0, burst_fraction=0.3)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_trace_file_loads_in_the_other_package(tmp_path, writer):
    """A trace saved by either package loads in the other, equal array
    for array; the ``.npz`` suffix is added when missing."""
    save_mod, load_mod = ((traces, ref_traces) if writer == "port"
                          else (ref_traces, traces))
    tr = save_mod.generate_trace("Mixed", 300, seed=7, process="diurnal",
                                 rate=30.0, period_s=20.0, n_tenants=3)
    path = tr.save(str(tmp_path / "t"))
    assert path.endswith("t.npz")
    back = load_mod.load_trace(str(tmp_path / "t"))
    _trace_equal(back, tr)
    _trace_equal(back, load_mod.generate_trace(
        "Mixed", 300, seed=7, process="diurnal", rate=30.0, period_s=20.0,
        n_tenants=3))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_trace_load_rejects_wrong_version(tmp_path, monkeypatch, writer):
    """A file of another format version is refused by both loaders."""
    save_mod = traces if writer == "port" else ref_traces
    with monkeypatch.context() as m:
        m.setattr(save_mod, "TRACE_FORMAT_VERSION", 99)
        path = save_mod.generate_trace("LPLD", 20, seed=1).save(
            str(tmp_path / "v.npz"))
    for load_mod in (traces, ref_traces):
        with pytest.raises(ValueError, match="version"):
            load_mod.load_trace(path)


# -- run_fleet ----------------------------------------------------------------
def _report(rep):
    """A FleetReport without its wall-clock fields; the profile's kinds
    and event count (host timings aside)."""
    out = rep.to_json()
    for k in ("wall_s", "events_per_s", "profile"):
        out.pop(k)
    if rep.profile is not None:
        out["profile"] = (rep.profile["events"],
                          {k: v["events"]
                           for k, v in rep.profile["kinds"].items()})
    return out


FLEETS = {
    # tests/test_fleet.py's smoke: 6 + 4 instances, profiled
    "smoke": (dict(workload="Mixed", n=800, seed=5, process="poisson",
                   rate=30.0, n_tenants=4),
              dict(n_prefill=6, n_decode=4, monitor_interval_s=0.5), True),
    "tokens_on": (dict(workload="LPLD", n=50, seed=6, process="poisson",
                       rate=20.0),
                  dict(n_prefill=2, n_decode=2, collect_tokens=True),
                  False),
    "flips_tpu_roce": (dict(workload="Mixed", n=400, seed=8,
                            process="bursty", rate=40.0, period_s=10.0),
                       dict(n_prefill=4, n_decode=2, hardware="tpu_v5e",
                            link="roce", enable_flip=True, flip_idle_s=0.2,
                            prefill_policy="ljf",
                            dispatch_policy="imbalance",
                            model="opt_13b", n_params=0), False),
}


@pytest.mark.parametrize("name", list(FLEETS))
def test_run_fleet_matches_reference(name):
    tkw, skw, profile = FLEETS[name]
    tkw = dict(tkw)
    wl, n = tkw.pop("workload"), tkw.pop("n")
    got = harness.run_fleet(traces.generate_trace(wl, n, **tkw),
                            harness.FleetSpec(**skw), profile=profile)
    want = ref_harness.run_fleet(ref_traces.generate_trace(wl, n, **tkw),
                                 ref_harness.FleetSpec(**skw),
                                 profile=profile)
    assert _report(got) == _report(want)
    assert got.finished + got.failed == n
    if name == "flips_tpu_roce":
        assert got.metrics["n"] == n
        assert harness.FleetSpec(**skw).build_cluster().serve(
            traces.generate_trace(wl, n, **tkw).to_requests()).flips > 0
    assert harness.FleetSpec(**skw).to_json() \
        == ref_harness.FleetSpec(**skw).to_json()


def test_run_fleet_flip_stall_matches_reference():
    """The reference's flip watcher can flip every prefill instance to
    decode and leave arrivals with no prefill instance: the run stalls.
    The port keeps that fault (ROADMAP §C) and stalls at the same
    event, with the same snapshot."""
    from repro.serving import ClusterStallError as RefStall
    from repro_torch.serving import ClusterStallError
    kw = dict(n_prefill=4, n_decode=2, hardware="tpu_v5e", link="roce",
              enable_flip=True, flip_idle_s=0.5, prefill_policy="ljf",
              decode_policy="reserve-static", dispatch_policy="imbalance",
              model="qwen2_0_5b", n_params=0)
    tr = dict(seed=8, process="bursty", rate=40.0, period_s=10.0)
    with pytest.raises(ClusterStallError) as got:
        harness.run_fleet(traces.generate_trace("Mixed", 400, **tr),
                          harness.FleetSpec(**kw))
    with pytest.raises(RefStall) as want:
        ref_harness.run_fleet(ref_traces.generate_trace("Mixed", 400, **tr),
                              ref_harness.FleetSpec(**kw))
    assert got.value.snapshot == want.value.snapshot
    assert str(got.value) == str(want.value)
    assert {d["role"] for d in got.value.snapshot.values()} == {"decode"}


def test_run_fleet_with_faults_and_page_leaks():
    """A crash and dropped transfers under a fleet spec; ``page_leaks``
    of a drained cluster is 0 on both."""
    from repro.serving import FaultEvent as RFE
    from repro.serving import FaultSpec as RFS
    from repro_torch.serving import FaultEvent, FaultSpec
    tr = dict(seed=4, process="poisson", rate=25.0)
    skw = dict(n_prefill=3, n_decode=3)
    got = harness.run_fleet(
        traces.generate_trace("Mixed", 300, **tr), harness.FleetSpec(**skw),
        faults=FaultSpec(seed=1, drop_kv=0.05, events=(
            FaultEvent(t=3.0, kind="crash", iid="i4"),)))
    want = ref_harness.run_fleet(
        ref_traces.generate_trace("Mixed", 300, **tr),
        ref_harness.FleetSpec(**skw),
        faults=RFS(seed=1, drop_kv=0.05, events=(
            RFE(t=3.0, kind="crash", iid="i4"),)))
    assert _report(got) == _report(want)
    cluster = harness.FleetSpec(**skw).build_cluster()
    for r in traces.generate_trace("LPLD", 60, **tr).to_requests():
        cluster._submit_request(r)
    cluster.run()
    assert harness.page_leaks(cluster) == 0


def test_h100_preset_matches_reference_cluster_on_its_constants():
    """``FleetSpec(hardware="h100")`` runs the reference's arithmetic:
    the reference's cluster priced by a ``HardwareSpec`` with the same
    constants gives the same report."""
    from repro.configs import get_config
    from repro.core.kv_transfer import TS_NVLINK, NetworkStack
    from repro.runtime.costmodel import CostModel, HardwareSpec
    from repro.serving import Cluster
    assert set(harness.HARDWARE) == set(ref_harness.HARDWARE) | {"h100"}
    assert set(harness.LINKS) == set(ref_harness.LINKS)
    spec = harness.FleetSpec(n_prefill=4, n_decode=2, hardware="h100")
    got = harness.run_fleet(traces.generate_trace("Mixed", 300, seed=2),
                            spec)
    hw = harness.HARDWARE["h100"]()
    ref_hw = HardwareSpec(name=hw.name, peak_flops=hw.peak_flops,
                          hbm_bw=hw.hbm_bw,
                          saturate_tokens=hw.saturate_tokens)
    cfg = get_config(spec.model)
    cluster = Cluster(cfg, runtime="sim",
                      cost=CostModel(cfg, ref_hw, n_params=spec.n_params),
                      n_prefill=4, n_decode=2,
                      network=NetworkStack(TS_NVLINK),
                      monitor_interval_s=spec.monitor_interval_s,
                      collect_tokens=False)
    reqs = ref_traces.generate_trace("Mixed", 300, seed=2).to_requests()
    res = cluster.serve(reqs)
    assert got.metrics == res.metrics
    assert got.events == cluster.events_processed
    assert got.finished == 300 and got.failed == 0


# -- the entry points ---------------------------------------------------------
@contextlib.contextmanager
def _argv(argv):
    old = sys.argv
    sys.argv = argv
    try:
        yield
    finally:
        sys.argv = old


def _serve(main, argv, where, monkeypatch):
    os.makedirs(where)
    monkeypatch.chdir(where)
    out = io.StringIO()
    with _argv(["serve"] + argv), contextlib.redirect_stdout(out):
        main()
    files = {name: open(os.path.join(where, name)).read()
             for name in sorted(os.listdir(where))}
    return out.getvalue(), files


@pytest.mark.parametrize("argv", [
    ["--requests", "24", "--arch", "deepseek_v2_236b",
     "--trace-jsonl", "t.jsonl", "--metrics-out", "m.json"],
    ["--workload", "HPLD", "--requests", "32", "--no-flip",
     "--n-prefill", "2", "--n-decode", "2", "--prefill-policy", "ljf",
     "--dispatch", "random", "--slo-ttft", "2.0", "--slo-tbt", "0.1",
     "--metrics-out", "m.json"],
], ids=["deepseek_traced", "opt13b_slo"])
def test_serve_cost_model_run_matches_reference(tmp_path, monkeypatch,
                                                argv):
    """``serve`` without ``--real``: the full-size ``--arch`` priced with
    no ``n_params``, so its output equals the reference's only if
    ``param_count`` is exact."""
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve
    got = _serve(serve.main, argv, str(tmp_path / "port"), monkeypatch)
    want = _serve(ref_serve.main, argv, str(tmp_path / "ref"), monkeypatch)
    assert got == want
    assert "avg TTFT" in got[0] and got[1]


def test_serve_cluster_prints_the_reference_table():
    """``python -m repro_torch.serve_cluster --requests 32`` against
    ``examples/serve_cluster.py``, line for line."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    got = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve_cluster", "--requests",
         "32"], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=120, check=True).stdout
    out = io.StringIO()
    with _argv(["serve_cluster.py", "--requests", "32"]), \
            contextlib.redirect_stdout(out):
        runpy.run_path(os.path.join(ROOT, "examples", "serve_cluster.py"),
                       run_name="__main__")
    assert got == out.getvalue()
    assert len(got.splitlines()) == 6


def test_serve_cluster_compare_is_the_table(capsys):
    """``compare`` and ``row`` are the table ``main`` prints; every
    request ends terminal and no page stays held."""
    from repro_torch import serve_cluster
    from repro_torch.runtime.costmodel import CostModel, HardwareSpec
    from repro_torch.runtime.request import TERMINAL_PHASES
    serve_cluster.main(["--requests", "16", "--link", "roce"])
    printed = capsys.readouterr().out.splitlines()
    cfg = serve_cluster.get_config("opt_13b")
    cost = CostModel(cfg, HardwareSpec.v100_tp2(), n_params=13_000_000_000)
    rows = [serve_cluster.HEADER]
    for wl, ra, cluster, rb in serve_cluster.compare(cost, 16, 0, "roce"):
        rows.append(serve_cluster.row(wl, ra, rb))
        assert all(r.phase in TERMINAL_PHASES for r in rb.requests)
        assert harness.page_leaks(cluster) == 0
    assert rows == printed
