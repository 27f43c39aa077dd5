"""Instance flip: prefill <-> decode role transition (paper §3.5, Fig 10).

The flip itself is an internal-variable change (5-7 ms, no process restart
or model reload); the dominant cost is draining.  Mechanism:

  flip prefill->decode : global scheduler stops forwarding; drain queued
                         prefill requests; flip.
  flip decode->prefill : all prefill instances stop dispatching to it;
                         drain running decodes; flip.
"""
from __future__ import annotations

import dataclasses
import enum

FLIP_LATENCY_S = 0.006


class Role(enum.Enum):
    PREFILL = "prefill"
    DECODE = "decode"


class FlipState(enum.Enum):
    ACTIVE = "active"
    DRAINING = "draining"
    FLIPPING = "flipping"


@dataclasses.dataclass
class FlipMachine:
    role: Role
    state: FlipState = FlipState.ACTIVE
    flip_done_at: float = -1.0
    flips: int = 0

    @property
    def accepting(self) -> bool:
        """May the global scheduler / dispatchers send new work here?"""
        return self.state == FlipState.ACTIVE

    def begin_flip(self) -> None:
        assert self.state == FlipState.ACTIVE
        self.state = FlipState.DRAINING

    def drained(self, now: float) -> None:
        """Call when the instance's queues are empty while DRAINING."""
        assert self.state == FlipState.DRAINING
        self.state = FlipState.FLIPPING
        self.flip_done_at = now + FLIP_LATENCY_S

    def maybe_complete(self, now: float) -> bool:
        if self.state == FlipState.FLIPPING and now >= self.flip_done_at:
            self.role = (Role.DECODE if self.role == Role.PREFILL
                         else Role.PREFILL)
            self.state = FlipState.ACTIVE
            self.flips += 1
            return True
        return False
