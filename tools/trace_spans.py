#!/usr/bin/env python3
"""Serve one cell of ``portbench`` as ``portbench/run.py`` does, with the
port's tracer attached to the cluster, and read the spans beside the
device trace.

    python3 tools/trace_spans.py --workload opt13b.mixed --seed <n> \
        [--seconds 51] [--tracer 0|1] [--profile 0|1] [--out FILE] \
        [--bench BENCHMARK.json] [--device cuda:0]

The window is ``portbench.serve``'s own (same traffic, warm-up and
window for a seed); ``--tracer 1`` sets ``Tracer(clock="wall")`` on the
cluster before it starts, ``--profile 1`` records the window's device
trace as ``--trace 1`` does.  Prints one JSON line: the card, the wall
time of a step (``decode_step_ms``, ``prefill_chunk_ms``: instance busy
over steps, in every mode); with ``--profile 1`` the benchmark's
per-layer metrics; with both, the seven readings of the spans and the
device trace together (``portbench/spans.py``), ``host_gaps``, the
counters' window deltas beside the step spans' sums, and the clock
check: the share of the decode stream's ops in the window that start
inside a ``decode_step`` span, 1 ms of slack either side.  ``--out``
writes the tracer's JSONL records there.  The reference is not run:
``portbench/run.py`` judges correctness.
"""
from __future__ import annotations

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def counters(cluster):
    """(cluster ts, prompt tokens prefilled, rows computed, slot steps),
    read with both instances' locks held: no step is half counted."""
    pre, dec = cluster.instances
    with pre.lock, dec.lock:
        return (cluster.now(), pre.pe.tokens_prefilled,
                pre.pe.rows_computed, dec.de.slot_steps)


def span_sums(events, t0, t1):
    """The step spans' tokens, rows and slots, of steps started in
    [t0, t1)."""
    sums = {"tokens": 0, "rows": 0, "slots": 0}
    for e in events:
        if e["type"] == "span" and t0 <= e["ts"] < t1:
            if e["name"] == "prefill_chunk":
                sums["tokens"] += e["args"]["tokens"]
                sums["rows"] += e["args"]["rows"]
            elif e["name"] == "decode_step":
                sums["slots"] += e["args"]["slots"]
    return sums


def clock_check(trace, events, to_ns, t0, t1, slack_ns=1_000_000):
    """Share of the decode stream's ops starting in [t0, t1) (ns) that
    start inside some ``decode_step`` span, converted, give or take
    ``slack_ns``."""
    from portbench import spans as SP
    streams = SP.roles(trace)
    if streams is None:
        return None
    steps = sorted((to_ns(e["ts"]) - slack_ns,
                    to_ns(e["ts"] + e["dur"]) + slack_ns)
                   for e in events if e["name"] == "decode_step")
    starts = [a for a, _ in steps]
    ops = [a for s, a, _, _ in trace.events
           if s == streams["decode"] and t0 <= a < t1]
    if not ops or not steps:
        return None
    inside = 0
    for a in ops:
        k = bisect.bisect_right(starts, a) - 1
        inside += k >= 0 and a <= steps[k][1]
    return inside / len(ops)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    ap.add_argument("--profile", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out")
    ap.add_argument("--bench", default=str(ROOT / "BENCHMARK.json"))
    ap.add_argument("--device", default="cuda:0")
    a = ap.parse_args()

    import torch

    from portbench import serve as SV
    from portbench import spans as SP
    from portbench import trace as TR
    from portbench import traffic as T
    from portbench.spec import Spec
    from repro_torch.obs.tracer import Tracer

    if a.device.startswith("cuda") and not torch.cuda.is_available():
        print("trace_spans: no CUDA card", file=sys.stderr)
        return 2
    bench = Path(a.bench).resolve()
    spec = Spec(bench, bench.parent / "portbench")
    cell = SV.Cell(spec, a.workload, a.seed, a.device)
    items = T.schedule(cell.mix, a.seconds, a.seed, cell.cfg["vocab_size"])
    tracer = Tracer(clock="wall") if a.tracer else None
    held = {}
    make = cell.cluster

    def cluster():
        held["c"] = c = make()
        c.tracer = tracer
        return c
    cell.cluster = cluster
    marks = []
    start, stop = TR.start, TR.stop

    def traced_start(device):
        marks.append(counters(held["c"]))
        return start(device)

    def traced_stop(prof, window_s, device):
        marks.append(counters(held["c"]))
        return stop(prof, window_s, device)
    TR.start, TR.stop = traced_start, traced_stop

    run, errors, _ = SV.serve(cell, items, a.seconds, T0, bool(a.profile))
    dev = cell.device
    out = {"workload": a.workload, "seed": a.seed, "tracer": a.tracer,
           "profile": a.profile,
           "device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu"),
           "failed": sum(r.failed for r in run.requests),
           "worker_errors": len(errors),
           "decode_step_ms": 1e3 * run.decode_busy_s
           / max(1, run.decode_iterations),
           "prefill_chunk_ms": 1e3 * run.prefill_busy_s
           / max(1, run.prefill_chunks),
           "decode_iterations": run.decode_iterations,
           "prefill_chunks": run.prefill_chunks}
    if a.profile:
        metrics = {}
        for m in spec.metrics(a.workload, True):
            metrics[m["name"]] = spec.reader(m["name"])(run)
        out["metrics"] = metrics
    if a.tracer and a.profile:
        ev = tracer.events
        w0, w1 = run.t_open - run.c0, run.t_close - run.c0
        n0, n1 = tracer.wall_ns(w0), tracer.wall_ns(w1)
        gaps = SP.host_gaps(run.trace, ev, tracer.wall_ns, n0, n1)
        split = SP.idle_split(gaps, (n1 - n0) * 1e-9)
        (c_t0, tok0, rows0, slots0), (c_t1, tok1, rows1, slots1) = marks
        out["spans"] = {
            "idle_host_share": split and split[0],
            "idle_nowork_share": split and split[1],
            "device_idle_share": out["metrics"].get("device_idle_share"),
            "decode_host_ms": SP.host_ms(ev, "decode", w0, w1),
            "decode_device_ms": out["metrics"].get("decode_device_ms"),
            "prefill_host_ms": SP.host_ms(ev, "prefill", w0, w1),
            "prefill_device_ms": out["metrics"].get("prefill_device_ms"),
            "prefill_fill_share": (100.0 * (tok1 - tok0) / (rows1 - rows0)
                                   if rows1 > rows0 else None),
            "host_gaps": SP.top(gaps) if gaps else None,
            "counters": {"tokens": tok1 - tok0, "rows": rows1 - rows0,
                         "slots": slots1 - slots0},
            "span_sums": span_sums(ev, c_t0, c_t1),
            "clock_inside_share": clock_check(run.trace, ev,
                                              tracer.wall_ns, n0, n1),
            "n_spans": len(ev)}
    if a.out and tracer is not None:
        tracer.write_jsonl(a.out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
