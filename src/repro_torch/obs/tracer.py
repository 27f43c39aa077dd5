"""Structured tracing: span/instant/counter records + exporters.

The ``Tracer`` is an append-only event sink the runtimes write into
when one is attached (``Cluster(tracer=...)``, ``AsyncCluster(tracer=
Tracer(clock="wall"))``); with no tracer attached every emission site
is a single ``is not None`` branch, so tracing off costs nothing
measurable.

Record model (the JSONL schema, one JSON object per line):

  {"type": "meta",    "schema": 1, "clock": "virtual"|"wall",
                      "anchor"?: {"wall_ns": int, "ts": float}}
  {"type": "span",    "name", "track", "ts", "dur", "rid"?, "args"?}
  {"type": "instant", "name", "track", "ts",        "rid"?, "args"?}
  {"type": "counter", "name", "track", "ts", "values": {series: num}}

``track`` names the timeline row owner — an instance id (``"i0"``) for
execution steps and instance-local events, or ``"cluster"`` for
cluster-scope events.  Request-phase spans additionally carry ``rid``
and are grouped per request on export.  ``ts``/``dur`` are seconds on
the runtime's clock: the event-loop runtimes emit virtual-clock times,
the wall-clock runtime emits real seconds since cluster start.

The anchor joins a wall-clock trace to other clocks: a ``time.time_ns()``
read and the runtime's clock read back to back (``set_anchor``, which
``AsyncCluster.start()`` calls).  ``wall_ns(ts)`` turns a ``ts`` into
Unix nanoseconds, the clock ``torch.profiler`` stamps its events with,
so a span can be laid over a device trace.

Spans of the wall-clock runtime (``serving/async_runtime.py``), each on
its instance's track unless said otherwise:

  * ``prefill_chunk`` (args ``step``, ``segments``, ``tokens``, ``rows``,
    ``rids``) and ``decode_step`` (``step``, ``slots``, ``max_slots``,
    ``context``, ``rids``): one engine step, with child spans of the
    same ``step`` that tile it: ``prefill.build`` / ``decode.admit``,
    ``*.build``, ``*.launch``, ``*.sync``, ``*.post``;
  * ``poll``: one unbroken stretch in which the worker found nothing to
    run;
  * ``lock_wait`` (arg ``lock``: the instance waited on): a wait for an
    instance lock, on the waiting worker's track (the thread's name for
    ``submit()`` and the transfer worker);
  * the request spans below, and ``transfer``.

Thread safety: emission is a single ``list.append`` of a fresh dict —
atomic under the CPython GIL — so threaded emitters share one
tracer with no lock on the hot path ("lock-free append").  Export
happens after (or outside) the run.

Perfetto export maps the records onto the Chrome ``trace_event``
format (https://ui.perfetto.dev loads the file directly):

  * each instance track becomes a *process* (named via ``M`` metadata
    events) whose thread 0 holds its execution-step slices — prefill
    chunks and decode iterations render side by side, which is exactly
    where interference and transfer overlap become visible;
  * requests live in one ``requests`` process, one *thread per rid*,
    so a request reads as a QUEUED → PREFILL → TRANSFER → DECODE slice
    sequence ending in a terminal instant;
  * counters become ``C`` events (queue depths, free pages over time).
"""
from __future__ import annotations

import json
import time
from typing import Callable, Dict, Iterable, List, Optional

SCHEMA_VERSION = 1

#: instants that terminate a request's span chain — every traced
#: request must reach exactly one of these (validate_chains)
TERMINAL_EVENTS = ("finished", "cancelled", "failed")

#: span names that belong to a request's phase chain (vs instance
#: execution-step spans, which carry rids only as annotations)
REQUEST_SPANS = ("queued", "prefill", "transfer", "decode_queued",
                 "decode")


class Tracer:
    """Append-only structured trace sink (see module docstring)."""

    def __init__(self, clock: str = "virtual"):
        assert clock in ("virtual", "wall"), clock
        self.clock = clock
        self.events: List[dict] = []
        #: {"wall_ns", "ts"}: a time.time_ns() read beside a ts read
        self.anchor: Optional[dict] = None

    def set_anchor(self, now: Callable[[], float]) -> None:
        """Anchor ``ts`` (read from ``now``) to the Unix clock: of five
        ``now``, ``time_ns``, ``now`` triples, the one whose two ``now``
        reads lie closest, with ``ts`` their midpoint."""
        best = None
        for _ in range(5):
            a = now()
            wall = time.time_ns()
            b = now()
            if best is None or b - a < best[0]:
                best = (b - a, wall, 0.5 * (a + b))
        self.anchor = {"wall_ns": best[1], "ts": best[2]}

    def wall_ns(self, ts: float) -> int:
        """``ts`` in Unix nanoseconds (``torch.profiler``'s clock)."""
        return self.anchor["wall_ns"] + round(
            (ts - self.anchor["ts"]) * 1e9)

    def __len__(self) -> int:
        return len(self.events)

    # -- emission (hot path: one dict + one append) ---------------------
    def span(self, name: str, track: str, ts: float, dur: float,
             rid: Optional[str] = None, **args) -> None:
        rec = {"type": "span", "name": name, "track": track,
               "ts": ts, "dur": dur}
        if rid is not None:
            rec["rid"] = rid
        if args:
            rec["args"] = args
        self.events.append(rec)

    def instant(self, name: str, track: str, ts: float,
                rid: Optional[str] = None, **args) -> None:
        rec = {"type": "instant", "name": name, "track": track, "ts": ts}
        if rid is not None:
            rec["rid"] = rid
        if args:
            rec["args"] = args
        self.events.append(rec)

    def counter(self, name: str, track: str, ts: float,
                **values) -> None:
        self.events.append({"type": "counter", "name": name,
                            "track": track, "ts": ts, "values": values})

    # -- queries (tests / validators) -----------------------------------
    def by_rid(self) -> Dict[str, List[dict]]:
        out: Dict[str, List[dict]] = {}
        for ev in self.events:
            rid = ev.get("rid")
            if rid is not None:
                out.setdefault(rid, []).append(ev)
        return out

    # -- JSONL ----------------------------------------------------------
    def to_jsonl_records(self) -> List[dict]:
        head = {"type": "meta", "schema": SCHEMA_VERSION,
                "clock": self.clock}
        if self.anchor is not None:
            head["anchor"] = dict(self.anchor)
        return [head] + list(self.events)

    def write_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for rec in self.to_jsonl_records():
                f.write(json.dumps(rec) + "\n")

    # -- Chrome/Perfetto trace_event ------------------------------------
    def to_perfetto(self) -> dict:
        """Render as a Chrome ``trace_event`` JSON object (ts/dur in
        microseconds; integer pids/tids with metadata naming)."""
        pids: Dict[str, int] = {}          # track -> pid
        tids: Dict[str, int] = {}          # rid -> tid in REQ_PID
        out: List[dict] = []
        REQ_PID = 1                         # all request rows
        pid_seq = [REQ_PID + 1]
        out.append({"ph": "M", "name": "process_name", "pid": REQ_PID,
                    "tid": 0, "ts": 0, "args": {"name": "requests"}})

        def pid_for(track: str) -> int:
            p = pids.get(track)
            if p is None:
                p = pids[track] = pid_seq[0]
                pid_seq[0] += 1
                out.append({"ph": "M", "name": "process_name", "pid": p,
                            "tid": 0, "ts": 0, "args": {"name": track}})
                out.append({"ph": "M", "name": "thread_name", "pid": p,
                            "tid": 0, "ts": 0, "args": {"name": "exec"}})
            return p

        def tid_for(rid: str) -> int:
            t = tids.get(rid)
            if t is None:
                t = tids[rid] = len(tids) + 1
                out.append({"ph": "M", "name": "thread_name",
                            "pid": REQ_PID, "tid": t, "ts": 0,
                            "args": {"name": rid}})
            return t

        for ev in self.events:
            rid = ev.get("rid")
            on_request_row = rid is not None and (
                ev["type"] != "span" or ev["name"] in REQUEST_SPANS)
            if on_request_row:
                pid, tid = REQ_PID, tid_for(rid)
            else:
                pid, tid = pid_for(ev["track"]), 0
            ts_us = ev["ts"] * 1e6
            base = {"name": ev["name"], "cat": ev["type"], "pid": pid,
                    "tid": tid, "ts": ts_us}
            args = dict(ev.get("args", ()))
            if rid is not None:
                args["rid"] = rid
            if on_request_row:
                # keep the owning instance visible on request rows
                args.setdefault("instance", ev["track"])
            if ev["type"] == "span":
                out.append(dict(base, ph="X", dur=ev["dur"] * 1e6,
                                args=args))
            elif ev["type"] == "instant":
                out.append(dict(base, ph="i", s="t", args=args))
            else:                          # counter
                out.append(dict(base, ph="C", args=dict(ev["values"])))
        other = {"schema": SCHEMA_VERSION, "clock": self.clock}
        if self.anchor is not None:
            other["anchor"] = dict(self.anchor)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": other}

    def write_perfetto(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_perfetto(), f)


# -- readers / validators (tools/check_trace.py + tests) ----------------
def read_jsonl(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def validate_jsonl_records(records: Iterable[dict]) -> List[str]:
    """Schema-check JSONL records; returns a list of problems (empty =
    valid).  First record must be the meta header."""
    errs: List[str] = []
    records = list(records)
    if not records:
        return ["empty trace"]
    head = records[0]
    if head.get("type") != "meta":
        errs.append("first record is not the meta header")
    elif head.get("schema") != SCHEMA_VERSION:
        errs.append(f"unknown schema version {head.get('schema')!r}")
    elif head.get("clock") not in ("virtual", "wall"):
        errs.append(f"unknown clock {head.get('clock')!r}")
    elif "anchor" in head and not (
            isinstance(head["anchor"], dict)
            and isinstance(head["anchor"].get("wall_ns"), int)
            and isinstance(head["anchor"].get("ts"), (int, float))):
        errs.append(f"bad anchor {head['anchor']!r}")
    for i, rec in enumerate(records[1:], start=2):
        kind = rec.get("type")
        if kind not in ("span", "instant", "counter"):
            errs.append(f"line {i}: unknown record type {kind!r}")
            continue
        for key in ("name", "track", "ts"):
            if key not in rec:
                errs.append(f"line {i}: missing {key!r}")
        if not isinstance(rec.get("ts", 0.0), (int, float)) \
                or rec.get("ts", 0.0) < 0:
            errs.append(f"line {i}: bad ts {rec.get('ts')!r}")
        if kind == "span":
            dur = rec.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"line {i}: span needs dur >= 0, "
                            f"got {dur!r}")
        if kind == "counter":
            vals = rec.get("values")
            if not isinstance(vals, dict) or not all(
                    isinstance(v, (int, float)) for v in vals.values()):
                errs.append(f"line {i}: counter needs numeric values")
    return errs


def validate_perfetto(doc: dict) -> List[str]:
    """Schema-check a Chrome ``trace_event`` JSON object."""
    errs: List[str] = []
    evs = doc.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        return ["traceEvents missing or empty"]
    for i, ev in enumerate(evs):
        ph = ev.get("ph")
        if ph not in ("X", "i", "C", "M"):
            errs.append(f"event {i}: unknown ph {ph!r}")
            continue
        for key in ("name", "pid", "tid", "ts"):
            if key not in ev:
                errs.append(f"event {i}: missing {key!r}")
        if not isinstance(ev.get("ts", 0), (int, float)) \
                or ev.get("ts", 0) < 0:
            errs.append(f"event {i}: bad ts {ev.get('ts')!r}")
        if ph == "X" and (not isinstance(ev.get("dur"), (int, float))
                          or ev["dur"] < 0):
            errs.append(f"event {i}: X needs dur >= 0")
        if ph == "i" and ev.get("s") not in ("t", "p", "g"):
            errs.append(f"event {i}: i needs scope s")
        if ph == "M" and "args" not in ev:
            errs.append(f"event {i}: M needs args")
    return errs


def validate_chains(records: Iterable[dict]) -> List[str]:
    """Span-chain liveness over JSONL records (meta header optional):
    every rid that appears must reach exactly one terminal instant
    (``finished`` / ``cancelled`` / ``failed``) — zero orphan spans.
    A recovered request may emit phase spans more than once (the retry
    re-runs its pipeline) but still terminates exactly once."""
    errs: List[str] = []
    terminals: Dict[str, int] = {}
    seen: Dict[str, int] = {}
    for rec in records:
        rid = rec.get("rid")
        if rid is None:
            continue
        seen[rid] = seen.get(rid, 0) + 1
        if rec.get("type") == "instant" \
                and rec.get("name") in TERMINAL_EVENTS:
            terminals[rid] = terminals.get(rid, 0) + 1
    for rid in seen:
        n = terminals.get(rid, 0)
        if n == 0:
            errs.append(f"{rid}: span chain never reaches a terminal "
                        "event (orphan)")
        elif n > 1:
            errs.append(f"{rid}: {n} terminal events (must be exactly 1)")
    return errs
