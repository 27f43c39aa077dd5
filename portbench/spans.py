"""The device trace of a traced run joined to the program's own record
of it: which stream each instance ran on, and what the two workers of
``AsyncCluster`` were doing in each stretch in which the card was idle.

Spans are the records of ``repro_torch.obs.tracer.Tracer`` (dicts with
``name``, ``track``, ``ts``, ``dur`` and ``args``), stamped on the
cluster's clock; ``to_ns`` is the tracer's ``wall_ns``, which puts a
``ts`` on the clock of the profiler's events.  Nothing else joins the
two clocks.
"""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

from portbench import trace as TR
from portbench.metrics.k1_roofline import KERNELS as PREFILL_KERNELS
from portbench.metrics.k2_roofline import KERNELS as DECODE_KERNELS

#: each worker's step span, by role
STEPS = {"prefill": "prefill_chunk", "decode": "decode_step"}
#: a state outranks those after it where spans nest: a poll stretch
#: holds the lock waits of the polls in it, a step its phases
_RANK = {"poll": 3, "lock_wait": 2}
BETWEEN = "between"

Interval = Tuple[int, int, str]


def roles(trace: TR.Trace) -> Optional[Dict[str, int]]:
    """The stream each role's instance ran on: the one stream on which
    the kernel only that role launches ran (kernel 1 for prefill, kernel
    2 for decode); None when a role's kernel ran on no stream or on two,
    or both on one."""
    out = {}
    for role, pattern in (("prefill", PREFILL_KERNELS),
                          ("decode", DECODE_KERNELS)):
        rx = re.compile(pattern)
        streams = {s for s, _, _, n in trace.events if rx.search(n)}
        if len(streams) != 1:
            return None
        out[role] = streams.pop()
    if out["prefill"] == out["decode"]:
        return None
    return out


def device_ms(trace: Optional[TR.Trace], role: str, steps: int
              ) -> Optional[float]:
    """The union of the ops on ``role``'s stream, in ms a step."""
    if trace is None or steps <= 0:
        return None
    streams = roles(trace)
    if streams is None:
        return None
    busy = TR._union([(a, b) for s, a, b, _ in trace.events
                      if s == streams[role]])
    return 1e-6 * sum(b - a for a, b in busy) / steps


def host_ms(spans: List[dict], role: str, t0: float, t1: float
            ) -> Optional[float]:
    """Mean over ``role``'s steps that started in [t0, t1) (cluster
    seconds) of their build and launch phases, in ms."""
    step = STEPS[role]
    starts = {(sp["track"], sp["args"]["step"]) for sp in spans
              if sp["name"] == step and t0 <= sp["ts"] < t1}
    if not starts:
        return None
    phases = (f"{role}.build", f"{role}.launch")
    host = sum(sp["dur"] for sp in spans if sp["name"] in phases
               and (sp["track"], sp["args"]["step"]) in starts)
    return 1e3 * host / len(starts)


def worker_tracks(spans: List[dict]) -> Optional[Dict[str, str]]:
    """Each role's worker track: the one that carries its step spans;
    None unless each role has exactly one."""
    out = {}
    for role, step in STEPS.items():
        tracks = {sp["track"] for sp in spans if sp["name"] == step}
        if len(tracks) != 1:
            return None
        out[role] = tracks.pop()
    return out


def timeline(spans: List[dict], track: str, to_ns: Callable[[float], int],
             t0: int, t1: int) -> List[Interval]:
    """What the worker on ``track`` was doing over [t0, t1) (ns), as
    back-to-back (start, end, state) intervals: ``poll``, ``lock_wait``,
    a step's phase (``build``, ``launch``...), or ``between`` where no
    span of its covers the instant."""
    edges = []
    for sp in spans:
        if sp["track"] != track or "rid" in sp:
            continue
        name = sp["name"]
        if name in _RANK:
            state, rank = name, _RANK[name]
        elif "." in name:
            state, rank = name.split(".", 1)[1], 1
        else:
            continue
        a = max(to_ns(sp["ts"]), t0)
        b = min(to_ns(sp["ts"] + sp["dur"]), t1)
        if a < b:
            edges.append((a, 1, rank, state))
            edges.append((b, -1, rank, state))
    edges.sort(key=lambda e: e[0])
    out: List[Interval] = []
    live: Dict[Tuple[int, str], int] = defaultdict(int)
    t, i = t0, 0
    while t < t1:
        while i < len(edges) and edges[i][0] <= t:
            _, d, rank, state = edges[i]
            live[(rank, state)] += d
            if not live[(rank, state)]:
                del live[(rank, state)]
            i += 1
        nxt = edges[i][0] if i < len(edges) else t1
        state = max(live)[1] if live else BETWEEN
        if out and out[-1][2] == state:
            out[-1] = (out[-1][0], nxt, state)
        else:
            out.append((t, nxt, state))
        t = nxt
    return out


def idle(trace: TR.Trace, t0: int, t1: int) -> List[Tuple[int, int]]:
    """The stretches of [t0, t1) (ns) in which no op ran on any stream."""
    out, t = [], t0
    for a, b in TR._union([(a, b) for _, a, b, _ in trace.events]):
        a, b = max(a, t0), min(b, t1)
        if a >= b:
            continue
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < t1:
        out.append((t, t1))
    return out


def host_gaps(trace: Optional[TR.Trace], spans: List[dict],
              to_ns: Callable[[float], int], t0: int, t1: int
              ) -> Optional[Dict[str, float]]:
    """The device's idle seconds in [t0, t1) (ns) by what the two
    workers were doing then, labelled ``decode:<state> |
    prefill:<state>``; None without a trace or without both workers'
    steps."""
    tracks = worker_tracks(spans)
    if trace is None or tracks is None or t1 <= t0:
        return None
    dec = timeline(spans, tracks["decode"], to_ns, t0, t1)
    pre = timeline(spans, tracks["prefill"], to_ns, t0, t1)
    gaps: Dict[str, float] = defaultdict(float)
    i = j = 0              # both timelines tile [t0, t1): walk them once
    for a, b in idle(trace, t0, t1):
        t = a
        while t < b:
            while dec[i][1] <= t:
                i += 1
            while pre[j][1] <= t:
                j += 1
            e = min(b, dec[i][1], pre[j][1])
            gaps[f"decode:{dec[i][2]} | prefill:{pre[j][2]}"] += \
                (e - t) * 1e-9
            t = e
    return dict(gaps)


NOWORK = "decode:poll | prefill:poll"


def idle_split(gaps: Optional[Dict[str, float]], window_s: float
               ) -> Optional[Tuple[float, float]]:
    """(idle while some worker was not polling, idle while both were),
    each in % of the window: together the window's idle share."""
    if gaps is None or window_s <= 0:
        return None
    nowork = gaps.get(NOWORK, 0.0)
    host = sum(v for k, v in gaps.items() if k != NOWORK)
    return 100.0 * host / window_s, 100.0 * nowork / window_s


def top(gaps: Dict[str, float], n: int = 10) -> List[list]:
    """The ``n`` labels with the most idle seconds, as [label, s]."""
    return [[k, v] for k, v in
            sorted(gaps.items(), key=lambda kv: -kv[1])[:n]]
