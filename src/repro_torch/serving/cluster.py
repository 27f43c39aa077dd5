"""Execution-agnostic cluster orchestration (the TetriInfer control
plane, extracted from the old ``DisaggSimulator``).

One ``Cluster`` owns the event loop, the ``GlobalScheduler`` (arrival
routing + overload shedding), the ``Dispatcher`` (prefill→decode
placement by predicted length), the ``ClusterMonitor`` (load broadcast
+ flip watcher + heartbeat liveness), the per-instance ``FlipMachine``s
and the KV-transfer events — and drives N instances through the narrow
``InstanceRuntime`` protocol:

  * ``runtime="engine"`` — ``EngineInstance``: the port's engines on
    ``device`` ("cuda" unless the caller asks for "cpu"), each facet
    with its own page pool; multi-instance serving of actual models.
  * ``runtime="sim"``    — ``SimInstance``: analytic cost-model timing
    (``runtime.costmodel``); cluster-scale workloads (OPT-13B, 128+
    requests) in milliseconds, on the host only: it holds no tensor and
    ignores ``device``.

The event loop is the reference's (``src/repro/serving/cluster.py``),
copied as it is.  On the sim runtime the port gives the reference's
metrics bit for bit (tests/golden_sim_metrics.json); with the engine
runtime's fixed virtual ``step_dt`` a step, the whole event sequence is
a function of host logic and greedy tokens, so the port and the
reference give the same streams, timestamps, placements, flips and
transfer accounting on the same weights and requests.

On top sits the user-facing request API: ``submit()`` returns a
``RequestHandle`` whose iterator streams tokens as they are generated
(lazily pumping the event loop), with ``cancel()`` freeing pages/slots
mid-flight and ``result()`` carrying per-phase timestamps.  Stop
criteria come from ``SamplingParams`` instead of the oracle
``decode_len``.

Fault tolerance (docs/fault_tolerance.md): pass ``faults=FaultSpec``
to inject deterministic instance crashes/hangs and KV-transfer
drop/corrupt/delay faults.  Detection is heartbeat-based (silent past
``RecoveryPolicy.heartbeat_timeout_s`` ⇒ declared DEAD and fenced)
plus per-transfer timeouts; recovery retransmits lost KV payloads with
exponential backoff, re-dispatches to surviving decode instances,
re-prefills requests stranded on a dead instance from the prompt, and
fails a request terminally (``Phase.FAILED``) once its retry budget is
exhausted.  With ``faults=None`` every failure path is unarmed and the
event stream is byte-for-byte the pre-fault-tolerance one.

Event kinds (a heap of ``(t, seq, kind, payload)``):

  arrival           a submitted request reaches the global scheduler
  prefill_done      one prefill chunk completes on an instance
  kv_arrive         a prefilled KV lands on its decode instance (post
                    emulated transfer wait; stamps ``t_transfer_done``)
  decode_done       one decode iteration completes on an instance
  monitor           periodic load broadcast / liveness / flips / routing
  fault             a scheduled ``FaultEvent`` fires (chaos runs only)
  transfer_timeout  sender-side per-transfer timer (chaos runs only)
  transfer_retry    backed-off KV retransmission (chaos runs only)
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from time import perf_counter as _perf_counter
from typing import Dict, List, Optional, Set

import numpy as np

from repro_torch.core.kv_transfer import NetworkStack, TS_NVLINK
from repro_torch.core.predictor import OraclePredictor
from repro_torch.core.sched.dispatcher import Dispatcher
from repro_torch.core.sched.flip import FlipState, Role
from repro_torch.core.sched.global_scheduler import (ClusterMonitor,
                                                     GlobalScheduler)
from repro_torch.obs.metrics import MetricsRegistry, observe_request
from repro_torch.obs.tracer import Tracer
from repro_torch.runtime.request import (TERMINAL_PHASES, Phase, Request,
                                         SamplingParams, summarize)
from repro_torch.serving.faults import (CORRUPT, CRASH, DELAY, DROP,
                                        FaultPlane, FaultSpec,
                                        RecoveryPolicy)
from repro_torch.serving.engine_instance import EngineInstance
from repro_torch.serving.runtime import InstanceRuntime, PrefillOutcome
from repro_torch.serving.sim_instance import SimInstance

_UNSET = object()


class ClusterStallError(RuntimeError):
    """The cluster holds queued work but no event can make progress
    (e.g. the page pool is too small for a request, or every instance
    that could serve the work is gone).

    ``snapshot`` maps each instance id to its state at stall time —
    role, flip state, health, running flag, queue depths and free
    pages — so the stall is diagnosable from the exception alone.
    """

    def __init__(self, message: str, snapshot: Dict[str, dict]):
        lines = [message]
        for iid, s in snapshot.items():
            lines.append(
                f"  {iid}: role={s['role']} flip={s['flip_state']} "
                f"health={s['health']} running={s['running']} "
                f"prefill_queued_tokens={s['prefill_queued_tokens']} "
                f"decode_queued={s['decode_queued']} "
                f"decode_batch={s['decode_batch']} "
                f"free_pages={s['free_pages']}")
        super().__init__("\n".join(lines))
        self.snapshot = snapshot


@dataclasses.dataclass
class SimResult:
    """Cluster run summary (the old simulator's result type)."""
    metrics: dict
    resource_time: float
    prefill_busy: float
    decode_busy: float
    swap_events: int
    flips: int
    requests: List[Request]

    @property
    def perf_per_dollar(self) -> float:
        """Requests completed per instance-busy-second (§5.1 perf/$)."""
        n = self.metrics.get("n", 0)
        return n / self.resource_time if self.resource_time else 0.0


@dataclasses.dataclass
class RequestResult:
    """Terminal state of one request, with per-phase timestamps."""
    rid: str
    phase: Phase
    tokens: List[int]
    arrival: float
    t_prefill_start: float
    t_first_token: float
    t_transfer_done: float
    t_decode_start: float
    t_finish: float
    retries: int = 0
    error: Optional[str] = None

    @property
    def ttft(self) -> float:
        return self.t_first_token - self.arrival

    @property
    def jct(self) -> float:
        return self.t_finish - self.arrival


class RequestHandle:
    """Streaming view of one submitted request.

    Iterating yields generated tokens in order as the cluster produces
    them, pumping the event loop on demand — ``for tok in handle`` is
    the streaming API.  On the sim runtime tokens are ``-1``
    placeholders (the cost model generates lengths, not ids); counts
    and timing are real.

    On a recovery (instance death ⇒ re-prefill) the token buffer is
    reset and refilled by the retried attempt, so ``result().tokens``
    is always the surviving attempt's output; an iterator that already
    consumed tokens from the lost attempt does not replay the retried
    prefix (``tokens_so_far()``/``result()`` are authoritative).
    """

    def __init__(self, cluster: "Cluster", req: Request):
        self._cluster = cluster
        self._req = req
        self._cursor = 0

    @property
    def rid(self) -> str:
        return self._req.rid

    @property
    def request(self) -> Request:
        return self._req

    def done(self) -> bool:
        return self._req.phase in TERMINAL_PHASES

    def tokens_so_far(self) -> List[int]:
        # empty when the cluster runs with collect_tokens=False (the
        # fleet harness's memory knob — timing metrics stay complete)
        return list(self._cluster._buffers.get(self.rid, ()))

    def __iter__(self):
        buf = self._cluster._buffers.get(self.rid)
        if buf is None:
            while not self.done() and self._cluster._pump():
                pass
            return
        while True:
            while self._cursor < len(buf):
                tok = buf[self._cursor]
                self._cursor += 1
                yield tok
            if self.done() or not self._cluster._pump():
                return

    def cancel(self) -> bool:
        """Abort the request wherever it is; frees its pages/slots."""
        return self._cluster.cancel(self.rid)

    def result(self, wait: bool = True) -> RequestResult:
        """Terminal result; ``wait`` pumps the event loop to completion
        for this request first."""
        while wait and not self.done() and self._cluster._pump():
            pass
        r = self._req
        return RequestResult(
            rid=r.rid, phase=r.phase,
            tokens=self.tokens_so_far(), arrival=r.arrival,
            t_prefill_start=r.t_prefill_start,
            t_first_token=r.t_first_token,
            t_transfer_done=r.t_transfer_done,
            t_decode_start=r.t_decode_start, t_finish=r.t_finish,
            retries=r.retries, error=r.error)


class Cluster:
    """N prefill/decode instances under one orchestration core."""

    def __init__(self, cfg, *, runtime: str = "sim",
                 cost=None, params=None,
                 n_prefill: int = 1, n_decode: int = 1,
                 prefill_policy: str = "sjf", sched_batch: int = 16,
                 chunk_size: Optional[int] = None,
                 decode_policy: str = "reserve-dynamic",
                 dispatch_policy: str = "power2",
                 predictor=_UNSET,
                 network: Optional[NetworkStack] = None,
                 n_pages: Optional[int] = None, page_size: int = 16,
                 max_batch: Optional[int] = None,
                 enable_flip: bool = False, flip_idle_s: float = 60.0,
                 co_run_predictor: bool = True,
                 max_seq: int = 128, backend: str = "auto",
                 step_dt: float = 0.01,
                 faults: Optional[FaultSpec] = None,
                 recovery: Optional[RecoveryPolicy] = None,
                 monitor_interval_s: Optional[float] = None,
                 collect_tokens: bool = True,
                 prefix_cache: bool = False,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 device="cuda"):
        assert runtime in ("sim", "engine"), runtime
        self.cfg = cfg
        self.runtime = runtime
        self.prefix_cache = prefix_cache
        self.predictor = (OraclePredictor() if predictor is _UNSET
                          else predictor)
        self.network = network or NetworkStack(TS_NVLINK)
        self.dispatcher = Dispatcher(dispatch_policy, page_size)
        self.recovery = recovery or RecoveryPolicy()
        monitor_kw = {} if monitor_interval_s is None \
            else {"interval_s": monitor_interval_s}
        self.monitor = ClusterMonitor(
            flip_idle_s=flip_idle_s,
            heartbeat_timeout_s=self.recovery.heartbeat_timeout_s,
            **monitor_kw)
        self.gsched = GlobalScheduler(
            max_queued_tokens=self.recovery.shed_queued_tokens)
        self.enable_flip = enable_flip
        self.page_size = page_size
        self.max_seq = max_seq

        if runtime == "sim":
            assert cost is not None, "sim runtime needs a CostModel"
            chunk_size = 512 if chunk_size is None else chunk_size
            n_pages = 4096 if n_pages is None else n_pages
            max_batch = 64 if max_batch is None else max_batch
            self.chunk_size = chunk_size
            self.device = None          # host only: no tensor, no card

            def mk(i, role):
                return SimInstance(
                    f"i{i}", role, cfg=cfg, cost=cost,
                    sched_policy=prefill_policy, sched_batch=sched_batch,
                    chunk_size=chunk_size, decode_policy=decode_policy,
                    n_pages=n_pages, page_size=page_size,
                    max_batch=max_batch,
                    co_run_predictor=co_run_predictor,
                    prefix_cache=prefix_cache)
        else:
            assert params is not None, "engine runtime needs model params"
            chunk_size = 16 if chunk_size is None else chunk_size
            n_pages = 256 if n_pages is None else n_pages
            max_batch = 8 if max_batch is None else max_batch
            self.chunk_size = chunk_size
            self.device = device

            def mk(i, role):
                return EngineInstance(
                    f"i{i}", role, cfg=cfg, params=params,
                    network=self.network,
                    prefill_policy=prefill_policy,
                    sched_batch=sched_batch, chunk_size=chunk_size,
                    decode_policy=decode_policy, max_slots=max_batch,
                    n_pages=n_pages, page_size=page_size,
                    max_seq=max_seq, backend=backend, step_dt=step_dt,
                    prefix_cache=prefix_cache, device=device)

        self.instances: List[InstanceRuntime] = \
            [mk(i, Role.PREFILL) for i in range(n_prefill)] \
            + [mk(n_prefill + i, Role.DECODE) for i in range(n_decode)]
        # O(1) id lookup + role-partitioned views (rebuilt on the rare
        # role transitions); at fleet scale the event loop must never
        # rescan ``self.instances`` per event
        self._by_iid: Dict[str, InstanceRuntime] = \
            {i.iid: i for i in self.instances}
        self._role_members: Dict[Role, List[InstanceRuntime]] = {}
        self._rebuild_role_index()
        self._now = 0.0
        self._events: list = []
        self._seq = itertools.count()
        self._rid_seq = itertools.count()
        self._monitor_armed = False
        self._stall_ticks = 0
        self._collect_tokens = collect_tokens
        #: optional event-loop instrumentation (duck-typed — see
        #: repro_torch.obs.profile.EventLoopProfiler): when set, _pump
        #: times each event and calls ``profiler.record(kind, dt)``
        self.profiler = None
        #: total events processed (fleet harness events/sec metric)
        self.events_processed = 0
        self._pending_arrivals: List[Request] = []
        # fully-prefilled requests stashed while NO decode instance
        # existed — routed to a decode queue once a flip creates one
        # (the old simulator re-enqueued these into a PREFILL scheduler,
        # double-prefilling them and corrupting TTFT/busy accounting)
        self._pending_decode: List[PrefillOutcome] = []
        self._buffers: Dict[str, List[int]] = {}
        self._reqs: Dict[str, Request] = {}
        self._cancelled: set = set()

        # -- observability plane (docs/observability.md) -----------------
        # The registry always exists (probes are pull-only — free until
        # snapshot()); event-driven metric sites check ``enabled``.  The
        # tracer is optional and every emission site is one ``is not
        # None`` branch, so tracing off stays off the hot path.
        self.tracer = tracer
        self.metrics = metrics if metrics is not None \
            else MetricsRegistry(enabled=False)
        self.metrics.register_probe("instances", self._instance_stats)
        self.metrics.register_probe("network", lambda: {
            "bytes_sent": self.network.bytes_sent,
            "bytes_saved": self.network.bytes_saved,
            "retransmits": self.network.retransmits})
        # transfer-span start times, keyed (rid, attempt); tracer-only
        self._xfer_t0: Dict[tuple, float] = {}

        # -- fault plane (docs/fault_tolerance.md) -----------------------
        self.faults = faults
        self.fault_plane: Optional[FaultPlane] = \
            faults.plane() if faults is not None else None
        self._crashed: Set[str] = set()       # ground truth (undetected)
        self._hung_until: Dict[str, float] = {}
        self._dead: Set[str] = set()          # DECLARED dead (fenced)
        for inst in self.instances:           # liveness baseline at t=0
            self.monitor.heartbeat(inst.iid, 0.0)
        if faults is not None:
            known = {i.iid for i in self.instances}
            for ev in faults.events:
                assert ev.iid in known, \
                    f"FaultEvent targets unknown instance {ev.iid!r} " \
                    f"(have {sorted(known)})"
                self._push(ev.t, "fault", ev)

    # -- role views ---------------------------------------------------------
    def _rebuild_role_index(self) -> None:
        """Partition instances by CURRENT flip role, preserving
        ``self.instances`` order (role views must iterate in exactly
        the order the pre-index full scans did).  Called at init and
        after any flip completion — the only times a role changes."""
        self._role_members = {
            Role.PREFILL: [i for i in self.instances
                           if i.flip.role == Role.PREFILL],
            Role.DECODE: [i for i in self.instances
                          if i.flip.role == Role.DECODE],
        }

    def _prefills(self, accepting=True):
        return [i for i in self._role_members[Role.PREFILL]
                if i.iid not in self._dead
                and (i.flip.accepting or not accepting)]

    def _decodes(self, accepting=True):
        return [i for i in self._role_members[Role.DECODE]
                if i.iid not in self._dead
                and (i.flip.accepting or not accepting)]

    def _inst(self, iid) -> InstanceRuntime:
        return self._by_iid[iid]

    def _health(self, iid: str) -> str:
        if iid in self._dead:
            return "dead"
        if iid in self._crashed:
            return "crashed"          # not yet detected by heartbeats
        if self._now < self._hung_until.get(iid, -1.0):
            return "hung"
        return "alive"

    # -- event helpers ------------------------------------------------------
    def _push(self, t, kind, payload=None):
        heapq.heappush(self._events, (t, next(self._seq), kind, payload))

    def _arm_monitor(self):
        if not self._monitor_armed:
            self._monitor_armed = True
            self._push(self._now + self.monitor.interval_s, "monitor")

    def _decode_loads(self):
        for d in self._decodes():
            self.monitor.report_decode(d.iid, d.decode_load(), self._now)
        # drop stale entries for flipped instances
        for iid in list(self.monitor.decode_loads):
            if self._inst(iid).flip.role != Role.DECODE:
                del self.monitor.decode_loads[iid]
        return self.monitor.broadcast()

    # -- public API ---------------------------------------------------------
    def submit(self, prompt_tokens=None, *, sampling: Optional[
               SamplingParams] = None, rid: Optional[str] = None,
               arrival: Optional[float] = None,
               decode_len: Optional[int] = None,
               enc_embeds=None, request: Optional[Request] = None
               ) -> RequestHandle:
        """Submit one request; returns a streaming handle.

        Either pass ``prompt_tokens`` (+ ``sampling`` stop criteria),
        or a pre-built ``Request`` (oracle mode — the paper-experiment
        path, where ``decode_len`` is ground truth).
        """
        if request is None:
            assert prompt_tokens is not None, \
                "submit() needs prompt_tokens or a Request"
            prompt_tokens = np.asarray(prompt_tokens, dtype=np.int32)
            plen = len(prompt_tokens)
            if decode_len is None:
                cap = (sampling.max_new_tokens
                       if sampling and sampling.max_new_tokens else None)
                decode_len = cap or max(1, self.max_seq - plen - 2)
            request = Request(
                rid=rid or f"req{next(self._rid_seq):05d}",
                prompt_len=plen, decode_len=decode_len,
                arrival=self._now if arrival is None else arrival,
                prompt_tokens=prompt_tokens, enc_embeds=enc_embeds)
        if sampling is not None:
            request.sampling = sampling
        return self._submit_request(request)

    def _submit_request(self, req: Request) -> RequestHandle:
        assert req.rid not in self._reqs, f"duplicate rid {req.rid}"
        # an arrival can never predate the event clock: clamp BOTH the
        # event time and the request's own timestamp, else a stale
        # ``arrival=`` in the past inflates TTFT/JCT by the difference
        t = max(req.arrival, self._now)
        req.arrival = t
        self._reqs[req.rid] = req
        if self._collect_tokens:
            self._buffers[req.rid] = []
        self._push(t, "arrival", req)
        self._arm_monitor()
        return RequestHandle(self, req)

    def cancel(self, rid: str) -> bool:
        """Abort a request wherever it is; its pages/slots are freed on
        whichever instance holds it, and any in-flight KV payload is
        dropped on arrival."""
        req = self._reqs.get(rid)
        if req is None or req.phase in TERMINAL_PHASES:
            return False
        self._cancelled.add(rid)
        self._pending_arrivals = [r for r in self._pending_arrivals
                                  if r.rid != rid]
        self._pending_decode = [oc for oc in self._pending_decode
                                if oc.req.rid != rid]
        for inst in self.instances:
            inst.cancel(rid)
        req.phase = Phase.CANCELLED
        req.t_finish = self._now
        if self.tracer is not None:
            self.tracer.instant("cancelled", "cluster", self._now,
                                rid=rid)
        observe_request(self.metrics, req)
        return True

    def run(self) -> None:
        """Drain the event loop (all submitted requests to terminal)."""
        while self._pump():
            pass

    def serve(self, requests: List[Request], slo=None) -> SimResult:
        """Batch API (and the ``DisaggSimulator`` compat path): submit
        pre-built requests, run to completion, summarize.  Shares
        ``_submit_request`` with ``submit()`` — duplicate rids are
        rejected and each request gets its streaming buffer.  ``slo``
        (an ``SLOSpec``) adds attainment/goodput to the metrics."""
        for r in requests:
            self._submit_request(r)
        self.run()
        return self.result(requests, slo=slo)

    def result(self, requests: Optional[List[Request]] = None,
               slo=None) -> SimResult:
        reqs = requests if requests is not None \
            else list(self._reqs.values())
        pf = sum(i.busy for i in self.instances
                 if i.flip.role == Role.PREFILL)
        db = sum(i.busy for i in self.instances
                 if i.flip.role == Role.DECODE)
        return SimResult(
            metrics=summarize(reqs, slo=slo), resource_time=pf + db,
            prefill_busy=pf, decode_busy=db,
            swap_events=sum(i.swaps for i in self.instances),
            flips=sum(i.flip.flips for i in self.instances),
            requests=reqs)

    # -- event loop ---------------------------------------------------------
    def _pump(self) -> bool:
        """Process ONE event; returns False when the loop is drained."""
        if not self._events:
            return False
        t, _, kind, payload = heapq.heappop(self._events)
        self._now = t
        self.events_processed += 1
        if self.profiler is not None:
            t0 = _perf_counter()
            self._dispatch_event(kind, payload, t)
            self.profiler.record(kind, _perf_counter() - t0)
        else:
            self._dispatch_event(kind, payload, t)
        return True

    def _dispatch_event(self, kind: str, payload, t: float) -> None:
        if kind == "arrival":
            if payload.rid not in self._cancelled:
                self._pending_arrivals.append(payload)
                self._route_pending()
        elif kind == "prefill_done":
            if not self._completion_lost(payload, kind, t):
                self._on_prefill_done(self._inst(payload))
        elif kind == "kv_arrive":
            self._on_kv_arrive(*payload)
        elif kind == "decode_done":
            if not self._completion_lost(payload, kind, t):
                self._on_decode_done(self._inst(payload))
        elif kind == "monitor":
            self._on_monitor()
        elif kind == "fault":
            self._on_fault(payload)
        elif kind == "transfer_timeout":
            self._on_transfer_timeout(*payload)
        elif kind == "transfer_retry":
            self._on_transfer_retry(payload)

    # -- fault plane --------------------------------------------------------
    def _completion_lost(self, iid: str, kind: str, t: float) -> bool:
        """A crashed/fenced instance never reports a step completion; a
        hung one reports it when the freeze ends (the event is delayed,
        exactly like a stalled host).  No-op unless faults fired."""
        if iid in self._crashed or iid in self._dead:
            return True
        hu = self._hung_until.get(iid)
        if hu is not None and t < hu:
            self._push(hu, kind, iid)
            return True
        return False

    def _on_fault(self, ev) -> None:
        if self.tracer is not None:
            self.tracer.instant(ev.kind, ev.iid, self._now)
        if self.metrics.enabled:
            self.metrics.counter(f"faults_{ev.kind}").inc()
        if ev.kind == CRASH:
            self._crashed.add(ev.iid)
        else:  # HANG: freeze until t + duration (extends any prior hang)
            self._hung_until[ev.iid] = max(
                self._hung_until.get(ev.iid, 0.0), ev.t + ev.duration)
        self._arm_monitor()       # detection must run even if no work

    def _declare_dead(self, iid: str) -> None:
        """Heartbeat timeout fired: fence the instance and recover every
        request stranded on it.  Pages/slots are reclaimed through the
        same ``cancel()`` plumbing user cancels use; the requests then
        re-enter the pipeline from the prompt (their KV died with the
        instance) unless their retry budget is already spent."""
        self._dead.add(iid)
        self.monitor.forget(iid)
        if self.tracer is not None:
            self.tracer.instant("declared_dead", iid, self._now)
        if self.metrics.enabled:
            self.metrics.counter("instances_declared_dead").inc()
        inst = self._inst(iid)
        resident = inst.resident_requests()
        for req in resident:
            inst.cancel(req.rid)
        for req in resident:
            if req.rid in self._cancelled or req.phase in TERMINAL_PHASES:
                continue
            self._recover(req, f"instance {iid} died")

    def _recover(self, req: Request, why: str) -> None:
        """Re-prefill a stranded request from its prompt on a surviving
        instance (or fail it once the budget is exhausted)."""
        req.retries += 1
        if req.retries > self.recovery.max_retries:
            self._fail(req, f"{why}; retry budget "
                            f"({self.recovery.max_retries}) exhausted")
            return
        if self.tracer is not None:
            self.tracer.instant("recovery", "cluster", self._now,
                                rid=req.rid, why=why,
                                attempt=req.retries)
        if self.metrics.enabled:
            self.metrics.counter("recoveries").inc()
        req.phase = Phase.WAITING
        req.prefilled = 0
        req.generated = 0
        req.swapped = False
        req.cached_prefix_tokens = 0     # re-prefill re-evaluates the
        req.cached_prefix_pages = 0      # cache on the new instance
        req.t_prefill_start = req.t_first_token = -1.0
        req.t_transfer_done = req.t_decode_start = -1.0
        buf = self._buffers.get(req.rid)
        if buf is not None:
            del buf[:]        # the retried attempt refills the stream
        self._pending_arrivals.append(req)

    def _fail(self, req: Request, reason: str) -> None:
        """Terminal failure — fast, explicit, never a hang.  Callers
        guarantee the request holds no pages/slots at this point."""
        req.phase = Phase.FAILED
        req.error = reason
        req.t_finish = self._now
        if self.tracer is not None:
            self.tracer.instant("failed", "cluster", self._now,
                                rid=req.rid, reason=reason)
        observe_request(self.metrics, req)

    def _shed_unservable(self) -> None:
        """Graceful degradation: requests whose only possible servers
        are gone convert to fast FAILED results instead of queueing
        forever (capacity may still come back via a flip — only shed
        when no alive instance could ever take the work)."""
        alive = [i for i in self.instances if i.iid not in self._dead]
        can_flip = self.enable_flip and bool(alive)
        if self._pending_arrivals and not can_flip \
                and not self._prefills(accepting=False):
            for req in self._pending_arrivals:
                if req.phase not in TERMINAL_PHASES:
                    self._fail(req, "no prefill capacity left")
            self._pending_arrivals = []
        if self._pending_decode and not can_flip \
                and not self._decodes(accepting=False):
            for oc in self._pending_decode:
                if oc.req.phase not in TERMINAL_PHASES:
                    self._fail(oc.req, "no decode capacity left")
            self._pending_decode = []

    # -- prefill side -------------------------------------------------------
    def _kick_prefill(self, p: InstanceRuntime):
        if p.iid in self._dead:
            return                    # fenced: no new work, no events
        if p.running or p.flip.role != Role.PREFILL:
            return
        dur = p.prefill_start(self._now)
        if dur is None:
            return
        p.running = True
        self._push(self._now + dur, "prefill_done", p.iid)
        if self.tracer is not None:
            self.tracer.span("prefill_chunk", p.iid, self._now, dur)

    def _predict(self, req: Request) -> None:
        if self.predictor is not None and req.predicted_bucket < 0:
            b, lo, hi = self.predictor.predict_range(
                req.prompt_tokens, req.decode_len)
            req.predicted_bucket, req.predicted_lo, req.predicted_hi = \
                b, lo, hi

    def _select_decode(self, loads, req: Request) -> Optional[str]:
        did = self.dispatcher.select(
            loads, req.prompt_len, req.predicted_hi,
            heavy=req.is_heavy_decode())
        if did is None or did in self._dead \
                or self._inst(did).flip.role != Role.DECODE:
            cands = self._decodes() or self._decodes(accepting=False)
            did = cands[0].iid if cands else None
        return did

    def _dispatch(self, oc: PrefillOutcome, did: str) -> None:
        req = oc.req
        self.gsched.note_dispatch(req.rid, did)
        delay = oc.transfer_delay_s
        if delay is None:
            delay = self.network.send_kv(
                self.cfg, req.prompt_len, n_chunks=oc.n_chunks,
                enc_len=self.cfg.cross_ctx,
                cached_tokens=req.cached_prefix_tokens)
        req.phase = Phase.TRANSFER
        attempt = req.retries
        if self.tracer is not None:
            self._xfer_t0[(req.rid, attempt)] = self._now
        if self.fault_plane is None:
            self._push(self._now + delay, "kv_arrive",
                       (oc, did, attempt, False))
            return
        outcome = self.fault_plane.transfer_outcome(req.rid, attempt)
        if outcome == DROP:
            # payload lost in flight: only the sender's per-transfer
            # timer notices (no kv_arrive will ever fire)
            timeout = max(self.recovery.transfer_timeout_s, delay)
            self._push(self._now + timeout, "transfer_timeout",
                       (oc, attempt))
            return
        extra = self.faults.delay_s if outcome == DELAY else 0.0
        self._push(self._now + delay + extra, "kv_arrive",
                   (oc, did, attempt, outcome == CORRUPT))

    def _on_prefill_done(self, p: InstanceRuntime):
        outcomes = p.prefill_complete(self._now)
        loads = self._decode_loads()
        for oc in outcomes:
            req = oc.req
            if req.rid in self._cancelled:
                continue
            self._stream(req.rid, oc.first_token)
            if self.tracer is not None and req.t_prefill_start >= 0:
                self.tracer.span(
                    "queued", p.iid, req.arrival,
                    max(0.0, req.t_prefill_start - req.arrival),
                    rid=req.rid)
                self.tracer.span(
                    "prefill", p.iid, req.t_prefill_start,
                    max(0.0, self._now - req.t_prefill_start),
                    rid=req.rid, chunks=oc.n_chunks)
            self._predict(req)
            did = self._select_decode(loads, req)
            if did is None:
                # no decode instance at all: stash; the monitor's flip
                # watcher counts these as decode backlog, and
                # _route_pending dispatches them once a flip completes
                self._pending_decode.append(oc)
                continue
            self._dispatch(oc, did)
        p.running = False
        self._kick_prefill(p)

    # -- decode side --------------------------------------------------------
    def _on_kv_arrive(self, oc: PrefillOutcome, did: str,
                      attempt: int = 0, corrupted: bool = False):
        req = oc.req
        if req.rid in self._cancelled or req.phase in TERMINAL_PHASES:
            return      # payload dropped; pages were freed at cancel
        if attempt != req.retries or req.phase is not Phase.TRANSFER:
            return      # stale attempt, superseded by a retry/recovery
        if self.fault_plane is not None:
            target_lost = did in self._dead or did in self._crashed
            if corrupted or target_lost:
                self._retry_transfer(
                    oc, "payload corrupted" if corrupted
                    else f"decode target {did} lost")
                return
        if self.tracer is not None:
            t0 = self._xfer_t0.pop((req.rid, attempt), None)
            if t0 is not None:
                self.tracer.span("transfer", did, t0, self._now - t0,
                                 rid=req.rid, attempt=attempt)
        if self.metrics.enabled:
            self.metrics.counter("kv_transfers").inc()
        d = self._inst(did)
        d.decode_enqueue(oc, self._now)
        self._kick_decode(d)

    def _on_transfer_timeout(self, oc: PrefillOutcome, attempt: int):
        req = oc.req
        if req.rid in self._cancelled or req.phase in TERMINAL_PHASES:
            return
        if attempt != req.retries or req.phase is not Phase.TRANSFER:
            return      # that attempt already landed or was superseded
        self._retry_transfer(oc, "transfer timed out")

    def _retry_transfer(self, oc: PrefillOutcome, why: str) -> None:
        """Retransmit a lost/corrupted KV payload with exponential
        backoff, possibly to a different decode instance; fail the
        request once the shared retry budget is spent."""
        req = oc.req
        req.retries += 1
        if req.retries > self.recovery.max_retries:
            self._fail(req, f"kv transfer: {why}; retry budget "
                            f"({self.recovery.max_retries}) exhausted")
            return
        self.network.note_retransmit()
        if self.tracer is not None:
            self.tracer.instant("retransmit", "cluster", self._now,
                                rid=req.rid, why=why,
                                attempt=req.retries)
        if self.metrics.enabled:
            self.metrics.counter("kv_retransmits").inc()
        self._push(self._now + self.recovery.backoff(req.retries),
                   "transfer_retry", oc)

    def _on_transfer_retry(self, oc: PrefillOutcome) -> None:
        req = oc.req
        if req.rid in self._cancelled or req.phase in TERMINAL_PHASES:
            return
        loads = self._decode_loads()
        did = self._select_decode(loads, req)
        if did is None:
            # decode fleet gone: stash as decode backlog so the flip
            # watcher can convert a prefill instance (capacity
            # recovery); _route_pending re-dispatches after the flip
            self._pending_decode.append(oc)
            return
        self._dispatch(oc, did)

    def _kick_decode(self, d: InstanceRuntime):
        if d.iid in self._dead:
            return                    # fenced: no new work, no events
        if d.running or d.flip.role != Role.DECODE:
            return
        dur = d.decode_start(self._now)
        if dur is None:
            return
        d.running = True
        self._push(self._now + dur, "decode_done", d.iid)
        if self.tracer is not None:
            self.tracer.span("decode_step", d.iid, self._now, dur)

    def _on_decode_done(self, d: InstanceRuntime):
        ev = d.decode_complete(self._now)
        for rid, tok in ev.stream:
            self._stream(rid, tok)
        if self.tracer is not None or self.metrics.enabled:
            for req in ev.finished:
                self._finish_obs(req, d.iid)
        d.running = False
        self._kick_decode(d)

    def _finish_obs(self, req: Request, iid: str) -> None:
        """Terminal-success observability: close the request's span
        chain (decode_queued → decode → ``finished`` instant) and feed
        the latency histograms."""
        tr = self.tracer
        if tr is not None:
            if req.t_transfer_done >= 0 and req.t_decode_start >= 0:
                tr.span("decode_queued", iid, req.t_transfer_done,
                        max(0.0, req.t_decode_start - req.t_transfer_done),
                        rid=req.rid)
            if req.t_decode_start >= 0:
                tr.span("decode", iid, req.t_decode_start,
                        max(0.0, self._now - req.t_decode_start),
                        rid=req.rid, generated=req.generated)
            tr.instant("finished", iid, self._now, rid=req.rid)
        observe_request(self.metrics, req)

    def _stream(self, rid: str, tok: int) -> None:
        buf = self._buffers.get(rid)
        if buf is not None:
            buf.append(tok)

    # -- flips / routing ----------------------------------------------------
    def _maybe_flip(self):
        # complete in-flight flips; drain watchers
        for inst in self.instances:
            if inst.iid in self._dead:
                continue
            if inst.flip.state == FlipState.DRAINING:
                if (inst.flip.role == Role.PREFILL and inst.prefill_idle()
                        and not inst.running) or \
                   (inst.flip.role == Role.DECODE and inst.decode_idle()
                        and not inst.running):
                    inst.flip.drained(self._now)
            if inst.flip.maybe_complete(self._now):
                if self.tracer is not None:
                    self.tracer.instant("flip_complete", inst.iid,
                                        self._now,
                                        role=inst.flip.role.value)
                if self.metrics.enabled:
                    self.metrics.counter("flips").inc()
                # newly active in the flipped role
                self._rebuild_role_index()
                if inst.flip.role == Role.PREFILL:
                    self._kick_prefill(inst)
                else:
                    self._kick_decode(inst)
        if not self.enable_flip:
            return
        decode_backlog = sum(d.decode_queue_len()
                             for d in self._decodes()) \
            + len(self._pending_decode)
        prefill_backlog = sum(0 if p.prefill_idle() else 1
                              for p in self._prefills())
        if self.faults is not None and self._pending_arrivals:
            # capacity recovery: arrivals stranded because the prefill
            # fleet died count as prefill backlog so a surviving decode
            # instance can flip back (faults-only — parity-safe)
            prefill_backlog += 1
        for iid in self.monitor.flip_candidates(self._now):
            if iid in self._dead:
                continue
            inst = self._inst(iid)
            if not inst.flip.accepting or not inst.idle() or inst.running:
                continue
            if inst.flip.role == Role.PREFILL and decode_backlog > 0:
                inst.flip.begin_flip()
                if self.tracer is not None:
                    self.tracer.instant("flip_begin", inst.iid,
                                        self._now, to="decode")
            elif inst.flip.role == Role.DECODE and prefill_backlog > 0 \
                    and len(self._decodes()) > 1:
                inst.flip.begin_flip()
                if self.tracer is not None:
                    self.tracer.instant("flip_begin", inst.iid,
                                        self._now, to="prefill")

    def _route_pending(self):
        # stashed fully-prefilled requests first: once a decode instance
        # exists they go straight to its queue (NEVER back to prefill)
        if self._pending_decode and self._decodes(accepting=False):
            loads = self.monitor.broadcast()
            still: List[PrefillOutcome] = []
            for oc in self._pending_decode:
                did = self._select_decode(loads, oc.req)
                if did is None:
                    still.append(oc)
                    continue
                self._dispatch(oc, did)
            self._pending_decode = still
        loads = {p.iid: p.prefill_queued_tokens()
                 for p in self._prefills()}
        if not loads:
            return
        for req in self._pending_arrivals:
            if req.rid in self._cancelled or req.phase in TERMINAL_PHASES:
                continue
            if self.gsched.overloaded(loads):
                # overload shedding: fast failure instead of unbounded
                # queueing (docs/fault_tolerance.md)
                self._fail(req, "shed: every prefill queue over "
                                f"{self.gsched.max_queued_tokens} "
                                "queued tokens")
                continue
            iid = self.gsched.route(req, loads)
            p = self._inst(iid)
            p.prefill_enqueue(req)
            loads[iid] = p.prefill_queued_tokens()
            self._kick_prefill(p)
        self._pending_arrivals = []

    def _instance_stats(self) -> Dict[str, dict]:
        """Per-instance state — the ``"instances"`` pull-probe on
        ``self.metrics`` and (through it) the ``ClusterStallError``
        snapshot; one source of truth for both."""
        snap: Dict[str, dict] = {}
        for i in self.instances:
            load = i.decode_load()
            snap[i.iid] = {
                "role": i.flip.role.value,
                "flip_state": i.flip.state.value,
                "health": self._health(i.iid),
                "running": i.running,
                "prefill_queued_tokens": i.prefill_queued_tokens(),
                "decode_queued": load.get("queued", 0),
                "decode_batch": load.get("batch", 0),
                "free_pages": load.get("free_pages", 0),
            }
        return snap

    def _on_monitor(self):
        # liveness first: every responsive instance heartbeats; anyone
        # silent past the timeout is declared dead and recovered.  With
        # no fault plane instances cannot crash or hang, so every
        # heartbeat would land on time and silent() would always be
        # empty — the whole block is skipped (pure bookkeeping, no
        # observable effect on fault-free runs, and a large win at
        # fleet scale where it would rescan hundreds of instances per
        # tick for nothing).
        if self.faults is not None:
            for inst in self.instances:
                iid = inst.iid
                if iid in self._dead or iid in self._crashed:
                    continue
                hu = self._hung_until.get(iid)
                if hu is not None:
                    if self._now < hu:
                        continue          # frozen: heartbeat missed
                    del self._hung_until[iid]
                self.monitor.heartbeat(iid, self._now)
            for iid in self.monitor.silent(self._now):
                if iid not in self._dead:
                    self._declare_dead(iid)
            self._shed_unservable()
        self._decode_loads()
        for p in self._prefills():
            self.monitor.report_prefill(
                p.iid, p.prefill_queued_tokens(), self._now)
        if self.tracer is not None:
            for i in self.instances:
                if i.iid in self._dead:
                    continue
                load = i.decode_load()
                self.tracer.counter(
                    "load", i.iid, self._now,
                    prefill_queued_tokens=i.prefill_queued_tokens(),
                    decode_queued=load.get("queued", 0),
                    decode_batch=load.get("batch", 0),
                    free_pages=load.get("free_pages", 0))
        self._maybe_flip()
        self._route_pending()
        busy_any = any(not i.idle() or i.running for i in self.instances
                       if i.iid not in self._dead)
        pending_work = busy_any or self._pending_arrivals \
            or self._pending_decode
        if not self._events and pending_work:
            # stall rescue: queued work but nothing in flight and no
            # event left that would kick it (e.g. a decode admission
            # that failed policy with an empty batch).  Kicking here is
            # parity-safe: the pre-refactor simulator would have spun
            # on monitor events forever in this state.
            for inst in self.instances:
                if inst.iid in self._dead:
                    continue
                self._kick_prefill(inst)
                self._kick_decode(inst)
            if not self._events:
                self._stall_ticks += 1
                if self._stall_ticks > 10_000:
                    if self.tracer is not None:
                        self.tracer.instant("stall", "cluster",
                                            self._now)
                    raise ClusterStallError(
                        "cluster stalled: instances hold queued work "
                        "but no event can make progress (pool too "
                        "small for a request?)",
                        self.metrics.probe("instances"))
            else:
                self._stall_ticks = 0
        else:
            self._stall_ticks = 0
        if self._events or pending_work:
            self._push(self._now + self.monitor.interval_s, "monitor")
        else:
            self._monitor_armed = False
