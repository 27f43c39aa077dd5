"""The join of a device trace with the program's spans, on a hand-made
trace: each idle stretch labelled by both workers' states, the idle
time split between host work and no work, each role's stream found by
its kernel, and the readers returning nothing without a trace."""
from types import SimpleNamespace

import pytest

from portbench import spans as SP
from portbench.spec import Spec
from portbench.trace import Trace
from repro_torch.obs.tracer import Tracer

MS = 1_000_000                        # ns
DEC, PRE = 7, 3                       # stream ids


def _spans():
    """Over [0, 10) ms: decode polls, runs one step, waits for its lock,
    polls; prefill polls (with a lock wait inside), runs a chunk,
    polls."""
    tr = Tracer(clock="wall")
    tr.anchor = {"wall_ns": 0, "ts": 0.0}

    def span(name, track, a, b, **args):
        tr.span(name, track, a * 1e-3, (b - a) * 1e-3, **args)
    span("poll", "i1", 0, 2)
    span("decode_step", "i1", 2, 6, step=1, slots=2)
    for name, a, b in (("admit", 2, 2.5), ("build", 2.5, 3),
                       ("launch", 3, 5), ("sync", 5, 5.5),
                       ("post", 5.5, 6)):
        span(f"decode.{name}", "i1", a, b, step=1)
    span("lock_wait", "i1", 6, 6.5, lock="i1")
    span("poll", "i1", 7, 10)
    span("poll", "i0", 0, 4)
    span("lock_wait", "i0", 1, 1.5, lock="i0")
    span("prefill_chunk", "i0", 4, 8, step=1, tokens=5, rows=8)
    for name, a, b in (("build", 4, 5), ("launch", 5, 7), ("sync", 7, 7.5),
                       ("post", 7.5, 8)):
        span(f"prefill.{name}", "i0", a, b, step=1)
    span("poll", "i0", 8, 10)
    tr.span("decode", "i1", 0.0, 0.01, rid="r1")     # a request's span
    return tr


def _trace(decode_streams=(DEC,)):
    events = [(s, int(3.5 * MS), int(4.5 * MS), "void decode_kernel<64>")
              for s in decode_streams]
    events += [(DEC, int(4.5 * MS), 5 * MS, "elementwise_kernel"),
               (PRE, int(5.5 * MS), int(6.2 * MS),
                "void prefill_tc_kernel<128, 128>")]
    return Trace(events, window_s=0.010)


def test_idle_stretches_are_labelled_by_both_workers():
    tr = _spans()
    gaps = SP.host_gaps(_trace(), tr.events, tr.wall_ns, 0, 10 * MS)
    want = {"decode:poll | prefill:poll": 4.0,
            "decode:admit | prefill:poll": 0.5,
            "decode:build | prefill:poll": 0.5,
            "decode:launch | prefill:poll": 0.5,
            "decode:sync | prefill:launch": 0.5,
            "decode:lock_wait | prefill:launch": 0.3,
            "decode:between | prefill:launch": 0.5,
            "decode:poll | prefill:sync": 0.5,
            "decode:poll | prefill:post": 0.5}
    assert gaps.keys() == want.keys()
    for k, v in want.items():
        assert gaps[k] == pytest.approx(v * 1e-3, abs=1e-12), k
    assert SP.top(gaps, 2)[0] == ["decode:poll | prefill:poll",
                                  pytest.approx(4e-3)]


def test_idle_split_adds_up_to_the_idle_share():
    tr = _spans()
    trace = _trace()
    gaps = SP.host_gaps(trace, tr.events, tr.wall_ns, 0, 10 * MS)
    host, nowork = SP.idle_split(gaps, 0.010)
    assert host == pytest.approx(38.0) and nowork == pytest.approx(40.0)
    assert host + nowork == pytest.approx(100.0 * trace.idle_share(),
                                          abs=1e-9)


def test_host_and_device_ms_of_each_role():
    tr = _spans()
    assert SP.host_ms(tr.events, "decode", 0.0, 0.01) == pytest.approx(2.5)
    assert SP.host_ms(tr.events, "prefill", 0.0, 0.01) == pytest.approx(3.0)
    assert SP.host_ms(tr.events, "decode", 0.003, 0.01) is None
    assert SP.roles(_trace()) == {"prefill": PRE, "decode": DEC}
    assert SP.device_ms(_trace(), "decode", 1) == pytest.approx(1.5)
    assert SP.device_ms(_trace(), "prefill", 2) == pytest.approx(0.35)


@pytest.mark.parametrize("streams", [(DEC, DEC + 1), (PRE,)])
def test_roles_refuse_a_kernel_on_two_streams_or_one_shared(streams):
    trace = _trace(streams)
    assert SP.roles(trace) is None
    assert SP.device_ms(trace, "decode", 1) is None


@pytest.mark.parametrize("metric", ["decode_device_ms", "prefill_device_ms"])
def test_new_readers_find_nothing_without_a_trace_or_steps(metric):
    read = Spec().reader(metric)
    assert read(SimpleNamespace(trace=None, decode_iterations=4,
                                prefill_chunks=4)) is None
    assert read(SimpleNamespace(trace=_trace(), decode_iterations=0,
                                prefill_chunks=0)) is None
    assert read(SimpleNamespace(trace=_trace(), decode_iterations=2,
                                prefill_chunks=2)) > 0


def test_joins_find_nothing_without_spans_or_a_trace():
    tr = _spans()
    no_decode_steps = [e for e in tr.events if e["name"] != "decode_step"]
    assert SP.host_gaps(None, tr.events, tr.wall_ns, 0, MS) is None
    assert SP.host_gaps(_trace(), no_decode_steps, tr.wall_ns, 0, MS) is None
    assert SP.idle_split(None, 1.0) is None
    assert SP.host_ms([], "decode", 0.0, 1.0) is None
