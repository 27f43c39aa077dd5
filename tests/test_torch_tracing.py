"""The wall-clock ``AsyncCluster``'s tracing (on the CPU, f32, smoke
widths): the tracer's clock anchor against ``torch.profiler``'s events,
the step spans' work and phases against the engines' counters, tracing
off, and a handle that reads done only once its last token is
streamed.

Every wait has a timeout and every cluster is closed by its ``with``.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import model as M
from repro_torch.obs.tracer import (Tracer, validate_chains,
                                    validate_jsonl_records,
                                    validate_perfetto)
from repro_torch.runtime.request import Phase
from repro_torch.serving import AsyncCluster, SamplingParams
from repro_torch.serving import async_runtime as AR

DRAIN_S = 60.0
CLUSTER = dict(n_prefill=1, n_decode=1, chunk_size=16, max_seq=128,
               max_batch=8, n_pages=256, device="cpu")
PHASES = {"prefill_chunk": ("prefill.build", "prefill.launch",
                            "prefill.sync", "prefill.post"),
          "decode_step": ("decode.admit", "decode.build", "decode.launch",
                          "decode.sync", "decode.post")}


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_smoke_config("qwen2_0_5b"),
                              dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    return cfg, params


def _prompts(n=10, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 512, size=int(p)).astype(np.int32), int(m))
            for p, m in zip(rng.integers(2, 60, n), rng.integers(1, 10, n))]


def _serve(setup, tracer=None, **kw):
    """Greedy requests through a 1 + 1 cluster: (cluster, tokens)."""
    cfg, params = setup
    with AsyncCluster(cfg, params=params, tracer=tracer, **CLUSTER,
                      **kw) as ac:
        hs = [ac.submit(p, sampling=SamplingParams(max_new_tokens=m,
                                                   ignore_eos=True))
              for p, m in _prompts()]
        assert ac.drain(timeout=DRAIN_S), "run wedged"
        assert ac.worker_errors == []
    return ac, [h.result(wait=False).tokens for h in hs]


def test_anchor_lays_a_span_over_the_profilers_event():
    """A span around ``torch.mm``, converted by the anchor, holds the
    profiler's ``aten::mm`` event (the profiler stamps Unix ns)."""
    from torch.profiler import ProfilerActivity, profile
    tr = Tracer(clock="wall")
    t0 = time.monotonic()
    tr.set_anchor(lambda: time.monotonic() - t0)
    x = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        a = time.monotonic() - t0
        torch.mm(x, x)
        b = time.monotonic() - t0
    tr.span("mm", "test", a, b - a)
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert len(mm) == 1
    start, end = mm[0].start_ns(), mm[0].start_ns() + mm[0].duration_ns()
    assert tr.wall_ns(a) <= start <= end <= tr.wall_ns(b)
    head = tr.to_jsonl_records()[0]
    assert head["anchor"] == tr.anchor
    assert validate_jsonl_records(tr.to_jsonl_records()) == []
    assert tr.to_perfetto()["otherData"]["anchor"] == tr.anchor


def test_validators_read_the_anchor():
    tr = Tracer(clock="wall")
    assert "anchor" not in tr.to_jsonl_records()[0]
    recs = tr.to_jsonl_records()
    recs[0]["anchor"] = {"wall_ns": 1.5, "ts": 0.0}
    assert validate_jsonl_records(recs) == [
        "bad anchor {'wall_ns': 1.5, 'ts': 0.0}"]
    tr.anchor = {"wall_ns": 10 ** 18, "ts": 2.0}
    assert tr.wall_ns(2.5) == 10 ** 18 + 500_000_000


@pytest.mark.parametrize("backend", ["paged", "dense"])
def test_step_spans_carry_the_counted_work(setup, backend):
    """The step spans' tokens, rows and slots sum to the engines'
    counters, and each step's phases tile it with its ``step``."""
    tr = Tracer(clock="wall")
    ac, _ = _serve(setup, tr, backend=backend)
    pe, de = ac.instances[0].pe, ac.instances[1].de
    spans = [e for e in tr.events if e["type"] == "span"]
    steps = {n: [e for e in spans if e["name"] == n] for n in PHASES}
    assert len(steps["prefill_chunk"]) == pe.chunk_steps > 0
    assert len(steps["decode_step"]) == de.iterations > 0
    assert sum(e["args"]["tokens"] for e in steps["prefill_chunk"]) \
        == pe.tokens_prefilled == sum(len(p) for p, _ in _prompts())
    assert sum(e["args"]["rows"] for e in steps["prefill_chunk"]) \
        == pe.rows_computed >= pe.tokens_prefilled
    assert sum(e["args"]["slots"] for e in steps["decode_step"]) \
        == de.slot_steps
    if backend == "paged":
        assert pe.rows_computed > pe.tokens_prefilled     # padding
    else:
        assert pe.rows_computed == pe.tokens_prefilled
    for name, phases in PHASES.items():
        for st in steps[name]:
            kids = [e for e in spans if e["track"] == st["track"]
                    and e["name"] in phases
                    and e["args"]["step"] == st["args"]["step"]]
            # the dense prefill copies a token to the host only for a
            # request that its chunk finishes
            need = set(phases) if backend == "paged" or name == \
                "decode_step" else {phases[0], phases[1], phases[3]}
            assert kids and kids[0]["name"] == phases[0]
            assert {k["name"] for k in kids} >= need
            t = st["ts"]
            for k in kids:             # back to back, inside the step
                assert k["ts"] == pytest.approx(t, abs=1e-9)
                t = k["ts"] + k["dur"]
            assert t == pytest.approx(st["ts"] + st["dur"], abs=1e-9)
    ds = steps["decode_step"][0]["args"]
    assert ds["max_slots"] == CLUSTER["max_batch"]
    assert ds["slots"] == len(ds["rids"]) and ds["context"] > 0
    # each worker's poll stretches are unbroken: none touches the next
    for track in ("i0", "i1"):
        polls = sorted((e["ts"], e["ts"] + e["dur"]) for e in spans
                       if e["name"] == "poll" and e["track"] == track)
        assert polls
        assert all(b < c for (_, b), (c, _) in zip(polls, polls[1:]))
    assert validate_jsonl_records(tr.to_jsonl_records()) == []
    assert validate_chains(tr.to_jsonl_records()) == []
    assert validate_perfetto(tr.to_perfetto()) == []


def test_tracing_off_makes_no_span_and_streams_the_same(setup,
                                                        monkeypatch):
    """Without a tracer no step recorder or timed lock exists and the
    engines' hooks stay unset; the tokens equal a traced run's."""
    _, on = _serve(setup, Tracer(clock="wall"))

    def refuse(*a, **kw):
        raise AssertionError("a span site ran with tracing off")
    monkeypatch.setattr(AR._StepSpans, "__init__", refuse)
    monkeypatch.setattr(AR._TimedLock, "__init__", refuse)
    ac, off = _serve(setup)
    assert off == on
    assert ac._steps == {}
    for inst in ac.instances:
        assert inst.pe.phase_hook is None and inst.de.phase_hook is None


def test_lock_waits_are_spans_of_the_waiter(setup):
    """A thread that finds an instance's lock held records its wait."""
    cfg, params = setup
    tr = Tracer(clock="wall")
    with AsyncCluster(cfg, params=params, tracer=tr, **CLUSTER) as ac:
        p = ac.instances[0]
        with p.lock:
            t = threading.Thread(target=ac.submit, args=(
                np.arange(8, dtype=np.int32),), name="client")
            t.start()
            time.sleep(0.05)
        t.join(10)
        assert not t.is_alive()
        assert ac.drain(timeout=DRAIN_S)
    waits = [e for e in tr.events if e["name"] == "lock_wait"]
    mine = [e for e in waits if e["track"] == "client"]
    assert len(mine) == 1 and mine[0]["args"]["lock"] == p.iid
    assert mine[0]["dur"] >= 0.03
    assert any(e["track"] == p.iid for e in waits)    # its worker too


def test_handle_reads_done_only_once_its_last_token_is_streamed(setup):
    """The decode worker held between the step that finishes a request
    (its phase is FINISHED) and the stream of that step's token: the
    handle is not done, nor the drain, until the token is buffered."""
    cfg, params = setup
    held, release = threading.Event(), threading.Event()
    with AsyncCluster(cfg, params=params, **CLUSTER) as ac:
        stream = ac._stream

        def slow_stream(rid, tok):
            if ac._reqs[rid].phase is Phase.FINISHED and not held.is_set():
                held.set()
                release.wait(10)
            stream(rid, tok)
        ac._stream = slow_stream
        h = ac.submit(np.arange(10, dtype=np.int32),
                      sampling=SamplingParams(max_new_tokens=4,
                                              ignore_eos=True))
        assert held.wait(DRAIN_S)
        try:
            assert h.request.phase is Phase.FINISHED
            assert len(h.tokens_so_far()) == 3
            assert not h.done()
            assert not ac.drain(timeout=0.1)
        finally:
            release.set()
        assert len(h.result().tokens) == 4 and h.done()
        assert list(h) == h.result().tokens
