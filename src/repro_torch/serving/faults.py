"""Deterministic fault-injection plane + recovery policy for the
serving ``Cluster`` (docs/fault_tolerance.md).

Disaggregation multiplies failure surfaces: one request now spans a
prefill instance, a KV transfer, and a decode instance.  This module
is the *injection* side — a seeded, fully reproducible schedule of
instance crashes/hangs and per-transfer payload faults that works
identically on the sim and engine runtimes, because every decision is
a pure function of ``(seed, key)``:

  * **instance faults** (``FaultEvent``) are scheduled on the cluster
    event clock: ``crash`` kills an instance permanently (it stops
    heartbeating and its in-flight step completions are lost);
    ``hang`` freezes it for ``duration`` seconds (completions and
    heartbeats are delayed — a hang longer than the heartbeat timeout
    gets the instance *declared* dead and fenced, exactly like a
    crash).
  * **transfer faults** are drawn per ``(rid, attempt)`` from a
    counter-free hash of the spec seed — deterministic regardless of
    event interleaving, so a chaos run replays bit-identically:
    ``drop_kv`` loses the payload (detected by the sender's
    per-transfer timeout), ``corrupt_kv`` delivers a bad payload
    (detected on arrival, NACKed), ``delay_kv`` adds ``delay_s`` of
    extra latency.

Recovery itself lives in ``Cluster`` (cluster.py), parameterized by
``RecoveryPolicy``; with ``faults=None`` (the default) none of the
failure paths are armed and the no-fault event stream is byte-for-byte
unchanged (golden sim metrics stay pinned).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Optional, Tuple

CRASH = "crash"
HANG = "hang"

# per-transfer outcomes drawn by the plane
OK = "ok"
DROP = "drop"
CORRUPT = "corrupt"
DELAY = "delay"


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled instance fault on the cluster event clock."""
    t: float
    kind: str                 # CRASH | HANG
    iid: str
    duration: float = 0.0     # HANG only: freeze length (seconds)

    def __post_init__(self):
        assert self.kind in (CRASH, HANG), self.kind
        assert self.kind != HANG or self.duration > 0, \
            "hang needs a positive duration"


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Seeded chaos schedule.  Immutable so a spec can be logged/pinned
    alongside the benchmark JSON it produced."""
    seed: int = 0
    events: Tuple[FaultEvent, ...] = ()
    drop_kv: float = 0.0       # P(transfer payload lost in flight)
    corrupt_kv: float = 0.0    # P(payload delivered corrupted; NACKed)
    delay_kv: float = 0.0      # P(payload delayed by ``delay_s``)
    delay_s: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))
        total = self.drop_kv + self.corrupt_kv + self.delay_kv
        assert 0.0 <= total <= 1.0, \
            f"fault rates must sum into [0, 1], got {total}"

    def plane(self) -> "FaultPlane":
        return FaultPlane(self)


class FaultPlane:
    """Runtime face of a ``FaultSpec``: draws per-transfer outcomes and
    counts what it injected (surfaced in the chaos benchmark)."""

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self.dropped = 0
        self.corrupted = 0
        self.delayed = 0

    def _unit(self, key: str) -> float:
        """Uniform [0,1) from (seed, key) — stable across processes and
        call orders (no shared RNG stream to perturb)."""
        h = zlib.crc32(f"{self.spec.seed}:{key}".encode())
        return (h & 0xFFFFFFFF) / 2**32

    def transfer_outcome(self, rid: str, attempt: int) -> str:
        """OK / DROP / CORRUPT / DELAY for one transfer attempt."""
        u = self._unit(f"xfer:{rid}:{attempt}")
        s = self.spec
        if u < s.drop_kv:
            self.dropped += 1
            return DROP
        if u < s.drop_kv + s.corrupt_kv:
            self.corrupted += 1
            return CORRUPT
        if u < s.drop_kv + s.corrupt_kv + s.delay_kv:
            self.delayed += 1
            return DELAY
        return OK

    def stats(self) -> dict:
        return {"dropped": self.dropped, "corrupted": self.corrupted,
                "delayed": self.delayed}


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Detection + recovery knobs the Cluster applies (all of them are
    inert until a fault actually fires; defaults documented in
    docs/fault_tolerance.md).

    ``max_retries`` is a per-REQUEST budget shared by transfer
    retransmits and re-prefills: every recovery action increments
    ``Request.retries``, and the request fails terminally
    (``Phase.FAILED``) once the budget is exhausted.
    """
    heartbeat_timeout_s: float = 0.5   # silent this long -> declared DEAD
    transfer_timeout_s: float = 0.25   # sender re-arms per attempt
    retry_backoff_s: float = 0.02      # base backoff before attempt 1
    backoff_factor: float = 2.0        # exponential: base * factor**(n-1)
    max_retries: int = 3
    # overload shedding: reject arrivals outright (fast FAILED) once
    # every prefill queue holds at least this many tokens; None = never
    shed_queued_tokens: Optional[int] = None

    def backoff(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based)."""
        return self.retry_backoff_s * self.backoff_factor ** max(
            0, attempt - 1)
