"""Per-event-kind profiler for the serving runtimes (a copy of the
reference's ``obs/profile.py``).

Assign an instance to ``Cluster.profiler`` (the event loop calls
``record(kind, dt)`` around each dispatched event) and read
``report()`` after the run.  Its cost is two ``perf_counter`` calls
per event.  It takes no lock: the event loop records from one thread.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional


class EventLoopProfiler:
    def __init__(self) -> None:
        self.counts: Dict[str, int] = defaultdict(int)
        self.time_s: Dict[str, float] = defaultdict(float)

    def record(self, kind: str, dt: float) -> None:
        self.counts[kind] += 1
        self.time_s[kind] += dt

    @property
    def total_events(self) -> int:
        return sum(self.counts.values())

    @property
    def total_time_s(self) -> float:
        return sum(self.time_s.values())

    def report(self, wall_s: Optional[float] = None) -> Dict:
        """Per-kind breakdown, sorted by total handler time (descending).

        ``share`` is each kind's fraction of total HANDLER time; the
        ``wall_s`` argument (full run wall-clock, including heap pops
        and Python overhead outside handlers) feeds events_per_s when
        given, else handler time is used.
        """
        total = self.total_time_s
        kinds = {}
        for kind in sorted(self.time_s, key=self.time_s.get, reverse=True):
            n, t = self.counts[kind], self.time_s[kind]
            kinds[kind] = {
                "events": n,
                "total_s": round(t, 6),
                "us_per_event": round(1e6 * t / n, 3) if n else 0.0,
                "share": round(t / total, 4) if total else 0.0,
            }
        denom = wall_s if wall_s else total
        return {
            "events": self.total_events,
            "handler_time_s": round(total, 6),
            "events_per_s": round(self.total_events / denom, 1)
            if denom else 0.0,
            "kinds": kinds,
        }
