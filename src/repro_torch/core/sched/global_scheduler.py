"""Centralized control plane: global scheduler + cluster monitor (§3.2)
and instance flip (§3.5).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.sched.dispatcher import DecodeLoad
from repro_torch.runtime.request import Phase, Request

FLIP_LATENCY_S = 0.006   # 5-7 ms measured in the paper (§3.5)


@dataclasses.dataclass
class StatusEntry:
    req: Request
    prefill_iid: Optional[str] = None
    decode_iid: Optional[str] = None


class GlobalScheduler:
    """Forwards arriving requests to the least-loaded prefill instance and
    tracks request status; decode-instance choice is delegated to the
    prefill-side dispatcher (disaggregation principle, §3.2).

    ``max_queued_tokens`` arms overload shedding (graceful degradation,
    docs/fault_tolerance.md): when EVERY prefill queue already holds at
    least that many tokens, new arrivals are rejected outright — the
    cluster fails them fast (``Phase.FAILED``) instead of letting the
    backlog grow without bound while capacity is degraded."""

    def __init__(self, max_queued_tokens: Optional[int] = None):
        self.table: Dict[str, StatusEntry] = {}
        self.max_queued_tokens = max_queued_tokens
        self.shed = 0

    def overloaded(self, prefill_loads: Dict[str, int]) -> bool:
        """Should a new arrival be shed rather than queued?"""
        if self.max_queued_tokens is None or not prefill_loads:
            return False
        if min(prefill_loads.values()) >= self.max_queued_tokens:
            self.shed += 1
            return True
        return False

    def route(self, req: Request, prefill_loads: Dict[str, int]) -> str:
        """prefill_loads: iid -> queued tokens. Returns chosen iid."""
        iid = min(prefill_loads, key=lambda k: prefill_loads[k])
        self.table[req.rid] = StatusEntry(req=req, prefill_iid=iid)
        return iid

    def note_dispatch(self, rid: str, decode_iid: str) -> None:
        self.table[rid].decode_iid = decode_iid

    def finished(self) -> List[Request]:
        return [e.req for e in self.table.values()
                if e.req.phase == Phase.FINISHED]


class ClusterMonitor:
    """Collects instance load stats and broadcasts decode loads to all
    prefill instances (every ``interval``); owns instance lifecycle,
    the flip transition-watcher (§3.5) and per-instance heartbeat
    liveness (docs/fault_tolerance.md): every monitor tick each
    responsive instance heartbeats, and an instance silent for longer
    than ``heartbeat_timeout_s`` is declared DEAD by the cluster."""

    def __init__(self, interval_s: float = 0.1,
                 flip_idle_s: float = 60.0,
                 heartbeat_timeout_s: float = 0.5):
        self.interval_s = interval_s
        self.flip_idle_s = flip_idle_s
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.decode_loads: Dict[str, DecodeLoad] = {}
        self.prefill_loads: Dict[str, int] = {}
        self._idle_since: Dict[str, float] = {}
        self.heartbeats: Dict[str, float] = {}

    # -- liveness -------------------------------------------------------
    def heartbeat(self, iid: str, now: float) -> None:
        self.heartbeats[iid] = now

    def silent(self, now: float) -> List[str]:
        """Instances whose last heartbeat is older than the timeout —
        the detection half of failure handling (the cluster fences and
        recovers them)."""
        return [iid for iid, t in self.heartbeats.items()
                if now - t > self.heartbeat_timeout_s]

    def forget(self, iid: str) -> None:
        """Drop every record of a dead instance so no scheduler, flip
        watcher or dispatcher ever selects it again."""
        self.heartbeats.pop(iid, None)
        self.decode_loads.pop(iid, None)
        self.prefill_loads.pop(iid, None)
        self._idle_since.pop(iid, None)

    def report_decode(self, iid: str, load: dict, now: float) -> None:
        self.decode_loads[iid] = DecodeLoad(
            iid=iid, free_pages=load["free_pages"], n_heavy=load["n_heavy"],
            n_light=load["n_light"], queued=load["queued"])
        if load["batch"] == 0 and load["queued"] == 0:
            self._idle_since.setdefault(iid, now)
        else:
            self._idle_since.pop(iid, None)

    def report_prefill(self, iid: str, queued_tokens: int,
                       now: float) -> None:
        self.prefill_loads[iid] = queued_tokens
        if queued_tokens == 0:
            self._idle_since.setdefault(iid, now)
        else:
            self._idle_since.pop(iid, None)

    def broadcast(self) -> Dict[str, DecodeLoad]:
        """What every prefill instance's dispatcher sees."""
        return dict(self.decode_loads)

    def flip_candidates(self, now: float) -> List[str]:
        """Instances idle past the threshold — transition watcher policy."""
        return [iid for iid, t0 in self._idle_since.items()
                if now - t0 >= self.flip_idle_s]
