"""The narrow execution protocol the ``Cluster`` orchestrates against.

The cluster core (event loop, global scheduler, dispatcher, monitor,
flip machines, KV-transfer events) is execution-agnostic: it drives N
``InstanceRuntime`` objects and never touches an engine directly.  The
port has one implementation so far, ``EngineInstance``
(engine_instance.py): the port's ``PrefillEngine``/``DecodeEngine``
pair on a CUDA card or the CPU.  The reference's cost-model
``SimInstance`` comes with the sim slice.

Both facets (prefill + decode) live in the same object so an instance
flip (§3.5) is an internal-variable change, exactly like the paper.

Timing contract: ``*_start`` inspects/admits work and returns the
duration of ONE execution step (one prefill chunk / one decode
iteration) or ``None`` when there is nothing to run; the cluster then
schedules a ``*_done`` event and calls ``*_complete`` at that time,
which performs the step's effects and reports what finished.  The
engine runtime runs the real model and bills a fixed virtual tick
(``step_dt``).

Concurrency extension: an instance that runs under the wall-clock
``AsyncCluster`` also exposes a reentrant ``lock`` serializing every
method above (the async runtime takes it around each worker step,
transfer enqueue, cancel and recovery sweep) and a ``stream``: the CUDA
stream its engine calls run on, entered by every thread that calls
into it, or ``None`` (the caller's current stream; always on the CPU).
``EngineInstance`` provides both; the synchronous event-loop
``Cluster`` ignores them (single-threaded access).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol, Tuple, runtime_checkable

from repro_torch.core.sched.flip import FlipMachine
from repro_torch.runtime.request import Request


@dataclasses.dataclass
class PrefillOutcome:
    """One request whose prefill completed, ready to dispatch.

    ``payload`` is the runtime's KV handoff object (a ``PrefilledKV``
    for the engine runtime, nothing for sim).  ``transfer_delay_s`` is
    the emulated network wait when the runtime already accounted it
    (engine); ``None`` asks the cluster to price the transfer on its
    own ``NetworkStack`` (sim).  ``first_token`` is the prefill-emitted
    token streamed to the request handle at dispatch time (-1 on the
    sim runtime, which generates lengths, not tokens).
    """
    req: Request
    n_chunks: int = 1
    first_token: int = -1
    payload: object = None
    transfer_delay_s: Optional[float] = None


@dataclasses.dataclass
class StepEvents:
    """What one completed decode iteration produced."""
    stream: List[Tuple[str, int]] = dataclasses.field(default_factory=list)
    finished: List[Request] = dataclasses.field(default_factory=list)


@runtime_checkable
class InstanceRuntime(Protocol):
    """One cluster instance: both role facets behind a flip machine."""

    iid: str
    flip: FlipMachine
    busy: float          # accumulated execution seconds (sim: modeled;
    running: bool        # engine: wall) / an execution step in flight
    swaps: int

    # -- prefill facet --------------------------------------------------
    def prefill_enqueue(self, req: Request) -> None: ...

    def prefill_queued_tokens(self) -> int: ...

    def prefill_start(self, now: float) -> Optional[float]: ...

    def prefill_complete(self, now: float) -> List[PrefillOutcome]: ...

    def prefill_idle(self) -> bool: ...

    # -- decode facet ---------------------------------------------------
    def decode_enqueue(self, outcome: PrefillOutcome, now: float) -> None:
        ...

    def decode_queue_len(self) -> int: ...

    def decode_load(self) -> dict: ...

    def decode_start(self, now: float) -> Optional[float]: ...

    def decode_complete(self, now: float) -> StepEvents: ...

    def decode_idle(self) -> bool: ...

    # -- shared ---------------------------------------------------------
    def idle(self) -> bool: ...

    def cancel(self, rid: str) -> bool: ...

    def resident_requests(self) -> List[Request]:
        """Every request currently owned by this instance — prefill
        queue/chunks, decode queue/slots, in-flight steps.  Recovery
        support (docs/fault_tolerance.md): when the cluster declares an
        instance dead it reclaims these via ``cancel()`` and re-drives
        them from the prompt on surviving instances."""
        ...
