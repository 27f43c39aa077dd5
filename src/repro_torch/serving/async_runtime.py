"""Wall-clock async serving runtime of the port (the reference's
``src/repro/serving/async_runtime.py``; docs/async_runtime.md).

The synchronous ``Cluster`` advances its instances serially inside a
virtual-time event loop: prefill, KV transfer and decode can never
actually overlap, so it measures *simulated* latencies.  This module is
the genuinely concurrent runtime the paper's disaggregation argument
assumes: an ``AsyncCluster`` drives each ``EngineInstance`` on its own
worker thread (prefill chunks and decode iterations on different
instances execute concurrently: the per-instance page pools are
disjoint), ships prefilled KV through a per-prefill-instance
``_TransferWorker`` so the emulated network wait overlaps the NEXT
chunk's prefill instead of serializing behind it, and measures real
TTFT/JCT in wall seconds.

On the card each instance has a CUDA stream of its own
(``EngineInstance.stream``): its worker thread runs inside that stream
for the life of its loop, and every other thread that calls into the
instance's engines (the transfer worker's enqueue, cancels, the
recovery sweep, routing) enters it under the instance's lock.  The
kernels launch on the calling thread's current stream, so two
instances' steps overlap on the card where the host lets them; a KV
payload crosses from a prefill stream to a decode stream through the
event it carries (``PrefilledKV.ready``).  On the CPU there are no
streams.

Semantics contracts preserved from the synchronous runtime:

  * ``submit() → RequestHandle``: same streaming iterator / ``cancel()``
    / ``result()`` surface (handles block on a condition variable
    instead of pumping an event loop).
  * token identity: per-request token streams are byte-identical to the
    synchronous ``Cluster`` on the same workload, for any thread
    interleaving — prefill segments and decode slots are
    batch-composition-independent, and sampled requests derive their
    PRNG keys from (request seed, step), never from slot placement.
  * fault plane: ``FaultSpec`` crash/hang fire on wall-clock timers;
    KV drop/corrupt/delay replay the same per-(rid, attempt) draws as
    the event-loop runtime.  Crashed instances are fenced at the next
    step boundary (fail-stop at iteration granularity), their resident
    requests are cancelled (pages freed) and re-prefilled from the
    prompt on survivors, and every request still reaches a terminal
    phase with zero page leaks.

Deliberate differences (documented in docs/async_runtime.md): crash
detection is immediate rather than heartbeat-based (the fault timer IS
the failure detector), transfer target selection happens after the
network wait rather than before it, and role flips are not supported —
roles are fixed for the lifetime of the cluster.

Locking protocol (deadlock freedom by construction):

  * every ``EngineInstance`` carries one reentrant ``lock`` serializing
    all calls into its engine pair (its worker's step, transfer
    enqueues, cancels, the recovery sweep);
  * the cluster ``_lock`` guards request-state transitions (phase,
    retries, buffers) and is a LEAF: no thread ever acquires an
    instance lock while holding it, or vice versa;
  * the ``PagedAllocator``'s own internal lock (kvcache/paged.py) is
    defense-in-depth underneath both.

Tracing: ``AsyncCluster(tracer=Tracer(clock="wall"))`` (or a tracer
set before ``start()``).  ``start()`` anchors the tracer's clock to the
Unix clock (``Tracer.set_anchor``), so ``tracer.wall_ns(ts)`` lays any
span over a ``torch.profiler`` trace.  Each worker records, on its
instance's track:

  * ``prefill_chunk`` (args ``step``: the engine's ``chunk_steps``,
    ``segments``, ``tokens``: prompt tokens in the chunk, ``rows``: the
    padded rows sent to the model, ``rids``) and ``decode_step``
    (``step``: ``iterations``, ``slots``, ``max_slots``, ``context``: the
    keys the slots attend, ``rids``), from taking the instance's lock
    to the end of the step's host tail (first tokens handed on, tokens
    streamed); their child spans, of the same ``step``, tile them:
    ``decode.admit``, ``*.build`` (input arrays and their copies to the
    device), ``*.launch`` (the model call until it returns), ``*.sync``
    (the copy of the tokens to the host) and ``*.post`` (the rest);
  * ``poll``: one unbroken stretch in which it found nothing to run;
  * ``lock_wait`` (arg ``lock``): a wait for an instance lock, which
    ``submit()`` and the transfer worker record too, on their thread's
    name.

With no tracer none of this reads a clock: each site is one ``is not
None`` branch, and the engines' ``phase_hook`` stays ``None``.

No hidden failure: a worker's exception still fences its instance (its
requests re-prefill on the survivors, as in the reference), but it is
also recorded in ``AsyncCluster.worker_errors`` with its traceback, so
a kernel that fails to launch cannot pass for a tolerated fault.  An
injected ``FaultSpec`` crash or hang raises nothing and records
nothing.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
import traceback
from typing import Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from repro_torch.core.kv_transfer import NetworkStack, TS_NVLINK
from repro_torch.core.predictor import OraclePredictor
from repro_torch.core.sched.dispatcher import DecodeLoad, Dispatcher
from repro_torch.core.sched.flip import Role
from repro_torch.core.sched.global_scheduler import GlobalScheduler
from repro_torch.obs.metrics import MetricsRegistry, observe_request
from repro_torch.obs.tracer import Tracer
from repro_torch.runtime.request import (TERMINAL_PHASES, Phase, Request,
                                         SamplingParams, summarize)
from repro_torch.serving.cluster import RequestResult, SimResult
from repro_torch.serving.engine_instance import EngineInstance
from repro_torch.serving.faults import (CORRUPT, CRASH, DELAY, DROP, OK,
                                        FaultPlane, FaultSpec,
                                        RecoveryPolicy)
from repro_torch.serving.runtime import InstanceRuntime, PrefillOutcome

_UNSET = object()


class AsyncRequestHandle:
    """Streaming view of one request on the wall-clock runtime.

    Same surface as the synchronous ``RequestHandle``, but iteration
    and ``result(wait=True)`` BLOCK on the cluster's condition variable
    until the workers produce tokens — there is no event loop to pump.
    The recovery contract matches the sync handle: a re-prefill resets
    the token buffer, and an iterator that already consumed tokens from
    the lost attempt does not replay the retried prefix.
    """

    def __init__(self, cluster: "AsyncCluster", req: Request):
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
        return self._cluster._done(self._req)

    def tokens_so_far(self) -> List[int]:
        return list(self._cluster._buffers.get(self.rid, ()))

    def __iter__(self):
        c = self._cluster
        buf = c._buffers.get(self.rid)
        if buf is None:                      # collect_tokens=False
            with c._cv:
                while not self.done():
                    c._cv.wait(0.1)
            return
        while True:
            with c._cv:
                while len(buf) <= self._cursor and not self.done():
                    c._cv.wait(0.1)
                chunk = buf[self._cursor:]
            for tok in chunk:
                self._cursor += 1
                yield tok
            if self.done() and self._cursor >= len(buf):
                return

    def cancel(self) -> bool:
        return self._cluster.cancel(self.rid)

    def result(self, wait: bool = True) -> RequestResult:
        c = self._cluster
        if wait:
            with c._cv:
                while not self.done():
                    c._cv.wait(0.1)
        r = self._req
        return RequestResult(
            rid=r.rid, phase=r.phase,
            tokens=self.tokens_so_far(), arrival=r.arrival,
            t_prefill_start=r.t_prefill_start,
            t_first_token=r.t_first_token,
            t_transfer_done=r.t_transfer_done,
            t_decode_start=r.t_decode_start, t_finish=r.t_finish,
            retries=r.retries, error=r.error)


class _TransferWorker(threading.Thread):
    """Per-prefill-instance KV shipper: drains a queue of finished
    prefill outcomes and runs the cluster's transfer state machine for
    each, so the emulated network wait (and any drop/corrupt retry
    backoff) overlaps the prefill worker's next chunk instead of
    blocking it."""

    def __init__(self, cluster: "AsyncCluster", iid: str):
        super().__init__(name=f"xfer-{iid}", daemon=True)
        self._cluster = cluster
        self.q: "queue.Queue" = queue.Queue()

    def run(self) -> None:
        c = self._cluster
        while not c._stop.is_set():
            try:
                item = self.q.get(timeout=0.05)
            except queue.Empty:
                continue
            if item is None:
                return
            oc, attempt = item
            try:
                c._transfer(oc, attempt)
            except Exception as e:       # never wedge the request:
                c._note_error(self.name)
                c._fail(oc.req, f"transfer worker error: {e!r}")


class _TimedLock:
    """An instance's lock whose waits the tracer records as
    ``lock_wait`` spans on ``track``."""

    def __init__(self, cluster: "AsyncCluster", inst, track: str):
        self._cluster, self._inst, self._track = cluster, inst, track

    def __enter__(self):
        lock = self._inst.lock
        if not lock.acquire(blocking=False):
            c = self._cluster
            t = c.now()
            lock.acquire()
            c.tracer.span("lock_wait", self._track, t, c.now() - t,
                          lock=self._inst.iid)

    def __exit__(self, *exc) -> None:
        self._inst.lock.release()


class _StepSpans:
    """One worker's step and poll spans (module docstring): its engines
    report each phase's start through ``phase``, their ``phase_hook``."""

    def __init__(self, tracer: Tracer, now, track: str):
        self._tracer, self._now, self._track = tracer, now, track
        self._marks: List[tuple] = []      # (phase, ts) of this step
        self._args: dict = {}
        self._t_try = self._t0 = 0.0
        self._idle_since: Optional[float] = None

    def phase(self, name: str, **args) -> None:
        self._marks.append((name, self._now()))
        self._args.update(args)

    def attempt(self) -> None:
        """The loop iteration starts (before it takes the lock)."""
        self._t_try = self._now()

    def begin(self) -> None:
        """The lock is held: a step may start."""
        self._t0 = self._now()
        self._marks, self._args = [], {}

    def end(self, name: str, ran: bool) -> None:
        """The iteration is over: a step that ran a chunk or an iteration
        becomes a ``name`` span and its phases; else the poll stretch
        goes on."""
        tr, track = self._tracer, self._track
        if not (ran and self._marks):
            if self._idle_since is None:
                self._idle_since = self._t_try
            return
        self.close(self._t_try)
        t1 = self._now()
        tr.span(name, track, self._t0, t1 - self._t0, **self._args)
        step = self._args.get("step")
        start = self._t0
        ends = [t for _, t in self._marks[1:]] + [t1]
        for (phase, _), end in zip(self._marks, ends):
            tr.span(phase, track, start, end - start, step=step)
            start = end

    def close(self, t: Optional[float] = None) -> None:
        """End the poll stretch, if one is open, at ``t`` (now)."""
        if self._idle_since is not None:
            t = self._now() if t is None else t
            self._tracer.span("poll", self._track, self._idle_since,
                              t - self._idle_since)
            self._idle_since = None


class AsyncCluster:
    """N prefill + N decode ``EngineInstance``s under concurrent
    worker threads, measured in wall-clock seconds.

    Constructor knobs mirror ``Cluster(runtime="engine")`` where they
    apply.  ``overlap_transfer=False`` runs each KV transfer inline on
    the prefill worker (serializing transfer behind prefill — the
    ablation the wallclock benchmark uses to isolate the overlap win);
    ``transfer_delay_scale`` scales the emulated network wait that the
    runtime actually sleeps, so a slow-link scenario doesn't need a
    slow benchmark.  The engines run on ``device`` ("cuda" unless the
    caller asks for "cpu"), each instance on a CUDA stream of its own.
    """

    def __init__(self, cfg, *, params,
                 n_prefill: int = 1, n_decode: int = 1,
                 prefill_policy: str = "sjf", sched_batch: int = 16,
                 chunk_size: int = 16,
                 decode_policy: str = "reserve-dynamic",
                 dispatch_policy: str = "power2",
                 predictor=_UNSET,
                 network: Optional[NetworkStack] = None,
                 n_pages: int = 256, page_size: int = 16,
                 max_batch: int = 8, max_seq: int = 128,
                 backend: str = "auto", step_dt: float = 0.01,
                 faults: Optional[FaultSpec] = None,
                 recovery: Optional[RecoveryPolicy] = None,
                 overlap_transfer: bool = True,
                 transfer_delay_scale: float = 1.0,
                 collect_tokens: bool = True,
                 prefix_cache: bool = False,
                 poll_interval_s: float = 0.001,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.max_seq = max_seq
        self.page_size = page_size
        self.chunk_size = chunk_size
        self.overlap_transfer = overlap_transfer
        self.transfer_delay_scale = transfer_delay_scale
        self.poll_interval_s = poll_interval_s
        self.network = network or NetworkStack(TS_NVLINK)
        self.dispatcher = Dispatcher(dispatch_policy, page_size)
        self.recovery = recovery or RecoveryPolicy()
        self.gsched = GlobalScheduler(
            max_queued_tokens=self.recovery.shed_queued_tokens)
        self.predictor = (OraclePredictor() if predictor is _UNSET
                          else predictor)

        def mk(i, role):
            return EngineInstance(
                f"i{i}", role, cfg=cfg, params=params,
                network=self.network, prefill_policy=prefill_policy,
                sched_batch=sched_batch, chunk_size=chunk_size,
                decode_policy=decode_policy, max_slots=max_batch,
                n_pages=n_pages, page_size=page_size, max_seq=max_seq,
                backend=backend, step_dt=step_dt,
                prefix_cache=prefix_cache, device=self.device,
                own_stream=True)

        self.instances: List[InstanceRuntime] = \
            [mk(i, Role.PREFILL) for i in range(n_prefill)] \
            + [mk(n_prefill + i, Role.DECODE) for i in range(n_decode)]
        # the instances' streams start after the work queued so far on
        # this thread's stream: the weights and the zeroed page pools
        for i in self.instances:
            if i.stream is not None:
                i.stream.wait_stream(
                    torch.cuda.current_stream(i.stream.device))
        self._by_iid: Dict[str, InstanceRuntime] = \
            {i.iid: i for i in self.instances}
        self._prefill_insts = [i for i in self.instances
                               if i.flip.role == Role.PREFILL]
        self._decode_insts = [i for i in self.instances
                              if i.flip.role == Role.DECODE]

        # -- shared state (locking protocol in the module docstring) ----
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._reqs: Dict[str, Request] = {}
        self._buffers: Dict[str, List[int]] = {}
        self._cancelled: Set[str] = set()
        self._dead: Set[str] = set()
        self._hung_until: Dict[str, float] = {}
        self._collect_tokens = collect_tokens
        self._rid_seq = 0
        self._stop = threading.Event()
        self._started = False
        self._t0 = 0.0
        # rids in each decode instance's running step: a step stamps a
        # request FINISHED before its worker streams the step's tokens
        self._stepping: Dict[str, frozenset] = {
            d.iid: frozenset() for d in self._decode_insts}
        self._steps: Dict[str, _StepSpans] = {}    # with a tracer
        #: tracebacks of worker exceptions that no FaultSpec injected
        self.worker_errors: List[str] = []

        self.faults = faults
        self.fault_plane: Optional[FaultPlane] = \
            faults.plane() if faults is not None else None
        self._fault_timers: List[threading.Timer] = []

        # -- observability plane (docs/observability.md) -----------------
        # Same contract as the synchronous Cluster: the registry always
        # exists (pull-probes are free until snapshot()), the tracer is
        # optional and wall-clock-stamped.  Workers append concurrently
        # — Tracer emission is a single list.append of a fresh dict,
        # atomic under the GIL, so there is no lock on the hot path.
        self.tracer = tracer
        self.metrics = metrics if metrics is not None \
            else MetricsRegistry(enabled=False)
        self.metrics.register_probe("instances", self._instance_stats)
        self.metrics.register_probe("network", lambda: {
            "bytes_sent": self.network.bytes_sent,
            "bytes_saved": self.network.bytes_saved,
            "retransmits": self.network.retransmits})

        # workers are created here, started lazily on first submit()
        self._wake: Dict[str, threading.Event] = \
            {i.iid: threading.Event() for i in self.instances}
        self._xfer: Dict[str, _TransferWorker] = {}
        if overlap_transfer:
            for p in self._prefill_insts:
                self._xfer[p.iid] = _TransferWorker(self, p.iid)
        self._threads: List[threading.Thread] = []
        for p in self._prefill_insts:
            self._threads.append(threading.Thread(
                target=self._guarded, args=(self._prefill_loop, p),
                name=f"prefill-{p.iid}", daemon=True))
        for d in self._decode_insts:
            self._threads.append(threading.Thread(
                target=self._guarded, args=(self._decode_loop, d),
                name=f"decode-{d.iid}", daemon=True))

    # -- lifecycle ----------------------------------------------------------
    def now(self) -> float:
        """Wall seconds since the cluster started."""
        return time.monotonic() - self._t0

    def start(self) -> "AsyncCluster":
        if self._started:
            return self
        self._started = True
        self._t0 = time.monotonic()
        if self.tracer is not None:
            self.tracer.set_anchor(self.now)
            for i in self.instances:
                self._steps[i.iid] = _StepSpans(self.tracer, self.now,
                                                i.iid)
                i.trace_phases(self._steps[i.iid].phase)
        for t in self._threads:
            t.start()
        for w in self._xfer.values():
            w.start()
        if self.faults is not None:
            for ev in self.faults.events:
                if ev.iid not in self._by_iid:
                    raise ValueError(
                        f"FaultEvent targets unknown instance {ev.iid!r}")
                tm = threading.Timer(ev.t, self._on_fault, args=(ev,))
                tm.daemon = True
                tm.start()
                self._fault_timers.append(tm)
        return self

    def close(self) -> None:
        """Stop every worker thread.  Safe to call twice; does NOT wait
        for in-flight requests (``drain()`` first for that)."""
        self._stop.set()
        for tm in self._fault_timers:
            tm.cancel()
        for w in self._xfer.values():
            w.q.put(None)
        for ev in self._wake.values():
            ev.set()
        if self._started:
            for t in self._threads:
                t.join(timeout=10.0)
            for w in self._xfer.values():
                w.join(timeout=10.0)
        # work the workers queued may still run on the card: the pools
        # and payloads it reads must outlive it
        for i in self.instances:
            if i.stream is not None:
                i.stream.synchronize()

    def __enter__(self) -> "AsyncCluster":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- public API ---------------------------------------------------------
    def submit(self, prompt_tokens=None, *, sampling: Optional[
               SamplingParams] = None, rid: Optional[str] = None,
               decode_len: Optional[int] = None, enc_embeds=None,
               request: Optional[Request] = None) -> AsyncRequestHandle:
        """Submit one request; returns a streaming handle.  Arrival is
        stamped with the wall clock at the moment of submission (an
        open-loop client controls pacing, not timestamps)."""
        self.start()
        if request is None:
            if prompt_tokens is None:
                raise ValueError("submit() needs prompt_tokens or a Request")
            prompt_tokens = np.asarray(prompt_tokens, dtype=np.int32)
            plen = len(prompt_tokens)
            if decode_len is None:
                cap = (sampling.max_new_tokens
                       if sampling and sampling.max_new_tokens else None)
                decode_len = cap or max(1, self.max_seq - plen - 2)
            with self._lock:
                auto_rid = f"req{self._rid_seq:05d}"
                self._rid_seq += 1
            request = Request(rid=rid or auto_rid, prompt_len=plen,
                              decode_len=decode_len,
                              prompt_tokens=prompt_tokens,
                              enc_embeds=enc_embeds)
        if sampling is not None:
            request.sampling = sampling
        request.arrival = self.now()
        with self._lock:
            if request.rid in self._reqs:
                raise ValueError(f"duplicate rid {request.rid}")
            self._reqs[request.rid] = request
            if self._collect_tokens:
                self._buffers[request.rid] = []
        self._route_prefill(request)
        return AsyncRequestHandle(self, request)

    def cancel(self, rid: str) -> bool:
        """Abort a request wherever it is; pages/slots are freed on
        whichever instance holds it and any in-flight KV payload is
        dropped before enqueue (or removed by the engine cancel)."""
        with self._lock:
            req = self._reqs.get(rid)
            if req is None or req.phase in TERMINAL_PHASES:
                return False
            self._cancelled.add(rid)
        for inst in self.instances:
            with self._on(inst):
                inst.cancel(rid)
        with self._cv:
            if req.phase not in TERMINAL_PHASES:
                req.phase = Phase.CANCELLED
                req.t_finish = self.now()
                if self.tracer is not None:
                    self.tracer.instant("cancelled", "cluster",
                                        req.t_finish, rid=rid)
                observe_request(self.metrics, req)
            self._cv.notify_all()
        return True

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted request is terminal; returns
        False on timeout (the liveness guard chaos tests rely on —
        a hang shows up as a False, never a wedged suite)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                if all(self._done(r) for r in self._reqs.values()):
                    return True
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(0.1 if remaining is None
                              else min(0.1, remaining))

    def serve(self, requests: Sequence[Request],
              timeout: Optional[float] = None, slo=None) -> SimResult:
        """Batch API: submit pre-built requests now, drain, summarize.
        Unlike the sync cluster the wall clock cannot replay recorded
        ``arrival`` offsets — use ``OpenLoopClient`` for paced load.
        ``slo`` (an ``SLOSpec``) adds attainment/goodput."""
        self.start()
        for r in requests:
            self.submit(request=r)
        ok = self.drain(timeout)
        if not ok:
            raise TimeoutError(f"drain timed out after {timeout}s")
        return self.result(list(requests), slo=slo)

    def result(self, requests: Optional[List[Request]] = None,
               slo=None) -> SimResult:
        reqs = requests if requests is not None \
            else list(self._reqs.values())
        pf = sum(i.busy for i in self._prefill_insts)
        db = sum(i.busy for i in self._decode_insts)
        return SimResult(
            metrics=summarize(reqs, slo=slo), resource_time=pf + db,
            prefill_busy=pf, decode_busy=db,
            swap_events=sum(i.swaps for i in self.instances),
            flips=0, requests=reqs)

    # -- internals ----------------------------------------------------------
    def _inst(self, iid: str) -> InstanceRuntime:
        return self._by_iid[iid]

    def _done(self, req: Request) -> bool:
        """Terminal, and a finished request's last token in its buffer."""
        if req.phase not in TERMINAL_PHASES:
            return False
        return req.phase is not Phase.FINISHED or not any(
            req.rid in rids for rids in self._stepping.values())

    @contextlib.contextmanager
    def _on(self, inst: InstanceRuntime):
        """Hold ``inst``'s lock and run on its stream: how a thread other
        than the instance's worker calls into its engines."""
        lock = inst.lock if self.tracer is None else _TimedLock(
            self, inst, threading.current_thread().name)
        with lock, torch.cuda.stream(inst.stream):
            yield

    def _note_error(self, where: str) -> None:
        """Record the exception being handled (a worker's, not injected)."""
        with self._lock:
            self.worker_errors.append(f"{where}: {traceback.format_exc()}")

    def _health(self, iid: str) -> str:
        if iid in self._dead:
            return "dead"
        if self.now() < self._hung_until.get(iid, -1.0):
            return "hung"
        return "alive"

    def _instance_stats(self) -> Dict[str, dict]:
        """Per-instance state — the ``"instances"`` pull-probe, same
        shape as the synchronous cluster's (instance locks taken per
        instance, so a mid-run snapshot sees step-consistent state)."""
        snap: Dict[str, dict] = {}
        for i in self.instances:
            with i.lock:
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

    def _stream(self, rid: str, tok: int) -> None:
        with self._cv:
            buf = self._buffers.get(rid)
            if buf is not None and rid not in self._cancelled:
                buf.append(tok)
            self._cv.notify_all()

    def _predict(self, req: Request) -> None:
        if self.predictor is not None and req.predicted_bucket < 0:
            b, lo, hi = self.predictor.predict_range(
                req.prompt_tokens, req.decode_len)
            req.predicted_bucket, req.predicted_lo, req.predicted_hi = \
                b, lo, hi

    def _fail(self, req: Request, reason: str) -> None:
        with self._cv:
            if req.phase in TERMINAL_PHASES:
                return
            req.phase = Phase.FAILED
            req.error = reason
            req.t_finish = self.now()
            if self.tracer is not None:
                self.tracer.instant("failed", "cluster", req.t_finish,
                                    rid=req.rid, reason=reason)
            observe_request(self.metrics, req)
            self._cv.notify_all()

    def _finish_obs(self, req: Request, iid: str) -> None:
        """Terminal-success observability: close the request's span
        chain (decode_queued → decode → ``finished`` instant) and feed
        the latency histograms.  Called by the decode worker that
        finished the request, AFTER its terminal phase is stamped, so
        a racing ``cancel()`` can no longer emit a second terminal."""
        tr = self.tracer
        if tr is not None:
            if req.t_transfer_done >= 0 and req.t_decode_start >= 0:
                tr.span("decode_queued", iid, req.t_transfer_done,
                        max(0.0,
                            req.t_decode_start - req.t_transfer_done),
                        rid=req.rid)
            if req.t_decode_start >= 0:
                tr.span("decode", iid, req.t_decode_start,
                        max(0.0, req.t_finish - req.t_decode_start),
                        rid=req.rid, generated=req.generated)
            tr.instant("finished", iid, req.t_finish, rid=req.rid)
        observe_request(self.metrics, req)

    # -- routing ------------------------------------------------------------
    def _route_prefill(self, req: Request) -> None:
        while True:
            cands = [p for p in self._prefill_insts
                     if p.iid not in self._dead]
            if not cands:
                self._fail(req, "no prefill capacity left")
                return
            loads = {p.iid: p.prefill_queued_tokens() for p in cands}
            if self.gsched.overloaded(loads):
                self._fail(req, "shed: every prefill queue over "
                                f"{self.gsched.max_queued_tokens} "
                                "queued tokens")
                return
            iid = self.gsched.route(req, loads)
            p = self._inst(iid)
            with self._on(p):
                if p.iid in self._dead:
                    continue          # died between select and lock
                p.prefill_enqueue(req)
            self._wake[iid].set()
            return

    def _select_decode(self, req: Request) -> Optional[str]:
        alive = [d for d in self._decode_insts if d.iid not in self._dead]
        if not alive:
            return None
        # fresh load snapshot per dispatch (no monitor tick to wait on)
        loads = {}
        for d in alive:
            ld = d.decode_load()
            loads[d.iid] = DecodeLoad(
                iid=d.iid, free_pages=ld["free_pages"],
                n_heavy=ld["n_heavy"], n_light=ld["n_light"],
                queued=ld["queued"])
        did = self.dispatcher.select(
            loads, req.prompt_len, req.predicted_hi,
            heavy=req.is_heavy_decode())
        if did is None or did in self._dead:
            did = alive[0].iid
        return did

    # -- worker loops -------------------------------------------------------
    def _guarded(self, loop, inst: InstanceRuntime) -> None:
        """Worker crash containment: an unexpected engine exception is
        treated exactly like the instance dying — fence it and recover
        its residents — so a bug fails requests fast instead of wedging
        ``drain()`` forever.  The exception is recorded in
        ``worker_errors``.  The loop runs on the instance's stream."""
        try:
            with torch.cuda.stream(inst.stream):
                loop(inst)
        except Exception as e:
            self._note_error(threading.current_thread().name)
            self._declare_dead(inst.iid,
                               f"instance {inst.iid} worker error: {e!r}")
            raise

    def _paused(self, iid: str) -> bool:
        """Hang handling: a frozen instance does no work until the
        freeze ends (its worker sleeps in short slices so a crash or
        shutdown still interrupts it promptly)."""
        until = self._hung_until.get(iid)
        if until is None or self.now() >= until:
            return False
        self._stop.wait(min(0.05, until - self.now()))
        return True

    def _prefill_loop(self, p: InstanceRuntime) -> None:
        wake, xfer = self._wake[p.iid], self._xfer.get(p.iid)
        steps = self._steps.get(p.iid)
        lock = p.lock if steps is None else _TimedLock(self, p, p.iid)
        try:
            while not self._stop.is_set():
                if p.iid in self._dead:
                    return
                if self._paused(p.iid):
                    continue
                if steps is not None:
                    steps.attempt()
                with lock:
                    if steps is not None:
                        steps.begin()
                    ran = p.prefill_start(self.now()) is not None
                    outcomes = p.prefill_complete(self.now()) if ran else []
                if p.iid in self._dead:
                    return    # crashed mid-step: completions are lost
                for oc in outcomes:
                    self._on_prefill_outcome(oc, xfer, p.iid)
                if steps is not None:
                    steps.end("prefill_chunk", ran)
                if not ran:
                    wake.wait(self.poll_interval_s)
                    wake.clear()
        finally:
            if steps is not None:
                steps.close()

    def _on_prefill_outcome(self, oc: PrefillOutcome,
                            xfer: Optional[_TransferWorker],
                            iid: str) -> None:
        req = oc.req
        with self._lock:
            if req.rid in self._cancelled or req.phase in TERMINAL_PHASES:
                return
            # the engine stamped t_first_token with the step's START
            # time (the event-loop convention, where the step's
            # duration is billed by the clock); wall-clock TTFT is
            # honest only if it includes the chunk's execution time —
            # restamped here, under the lock, so a request cancelled
            # mid-prefill keeps its terminal timestamps untouched
            req.t_first_token = self.now()
            attempt = req.retries
            if self.tracer is not None and req.t_prefill_start >= 0:
                self.tracer.span(
                    "queued", iid, req.arrival,
                    max(0.0, req.t_prefill_start - req.arrival),
                    rid=req.rid)
                self.tracer.span(
                    "prefill", iid, req.t_prefill_start,
                    max(0.0, req.t_first_token - req.t_prefill_start),
                    rid=req.rid, chunks=oc.n_chunks)
        self._stream(req.rid, oc.first_token)
        self._predict(req)
        if xfer is not None:
            xfer.q.put((oc, attempt))    # overlapped: next chunk starts
        else:
            self._transfer(oc, attempt)  # serialized ablation

    def _decode_loop(self, d: InstanceRuntime) -> None:
        wake = self._wake[d.iid]
        steps = self._steps.get(d.iid)
        lock = d.lock if steps is None else _TimedLock(self, d, d.iid)
        try:
            while not self._stop.is_set():
                if d.iid in self._dead:
                    return
                if self._paused(d.iid):
                    continue
                if steps is not None:
                    steps.attempt()
                ev = None
                with lock:
                    if steps is not None:
                        steps.begin()
                    ran = d.decode_start(self.now()) is not None
                    if ran:
                        # the step stamps the requests it finishes
                        # FINISHED; their handles read done once its
                        # tokens are streamed
                        self._stepping[d.iid] = d.slot_rids()
                        ev = d.decode_complete(self.now())
                if d.iid in self._dead:
                    return    # crashed mid-step: completions are lost
                if ev is not None:
                    for r in ev.finished:
                        # engine stamped t_finish with the step's start
                        # time; wall-clock JCT must include the final
                        # step itself
                        r.t_finish = self.now()
                        self._finish_obs(r, d.iid)
                    for rid, tok in ev.stream:
                        self._stream(rid, tok)
                    with self._cv:
                        self._stepping[d.iid] = frozenset()
                        self._cv.notify_all()
                if steps is not None:
                    steps.end("decode_step", ran)
                if not ran:
                    wake.wait(self.poll_interval_s)
                    wake.clear()
        finally:
            if steps is not None:
                steps.close()
            with self._cv:
                self._stepping[d.iid] = frozenset()
                self._cv.notify_all()

    # -- KV transfer state machine ------------------------------------------
    def _transfer(self, oc: PrefillOutcome, attempt: int) -> None:
        """Ship one prefilled KV payload: emulated network sleep, fault
        draws per (rid, attempt), retry with backoff on drop/corrupt/
        lost target, terminal ``Phase.FAILED`` once the budget is spent.
        Runs on a ``_TransferWorker`` (overlapped) or inline on the
        prefill worker (``overlap_transfer=False``)."""
        req = oc.req
        delay = oc.transfer_delay_s
        if delay is None:
            delay = self.network.send_kv(
                self.cfg, req.prompt_len, n_chunks=oc.n_chunks,
                enc_len=self.cfg.cross_ctx,
                cached_tokens=req.cached_prefix_tokens)
        delay *= self.transfer_delay_scale
        while not self._stop.is_set():
            with self._lock:
                # phase write and its guard are one atomic section: a
                # cancel()/_fail()/_recover() racing with this worker
                # either lands first (we observe it here and bail) or
                # lands after (overwriting TRANSFER with its terminal/
                # WAITING phase) — a terminal phase is never clobbered
                # back to TRANSFER, preserving the zero-wedge guarantee
                if req.rid in self._cancelled \
                        or req.phase in TERMINAL_PHASES \
                        or req.retries != attempt:
                    return
                req.phase = Phase.TRANSFER
            t_start = self.now() if self.tracer is not None else 0.0
            if self.fault_plane is None:
                outcome = OK
            else:
                with self._lock:
                    outcome = self.fault_plane.transfer_outcome(
                        req.rid, attempt)
            if outcome == DROP:
                # payload lost in flight: the sender's timeout notices
                self._stop.wait(max(self.recovery.transfer_timeout_s,
                                    delay))
            else:
                extra = self.faults.delay_s if outcome == DELAY else 0.0
                self._stop.wait(delay + extra)
            with self._lock:
                if req.rid in self._cancelled \
                        or req.phase in TERMINAL_PHASES:
                    return
                if req.retries != attempt:
                    return    # superseded by a recovery re-prefill
            if outcome in (DROP, CORRUPT):
                why = ("transfer timed out" if outcome == DROP
                       else "payload corrupted")
                attempt = self._bump_retry(req, why)
                if attempt < 0:
                    return
                continue
            did = self._select_decode(req)
            if did is None:
                self._fail(req, "no decode capacity left")
                return
            d = self._inst(did)
            with self._on(d):
                # the cancelled/dead checks live INSIDE the instance
                # lock: a racing cancel() or crash sweep also takes it,
                # so either we see their mark here, or they run after
                # us and reclaim the payload we just enqueued
                if req.rid in self._cancelled \
                        or req.phase in TERMINAL_PHASES \
                        or req.retries != attempt:
                    return
                if did not in self._dead:
                    self.gsched.note_dispatch(req.rid, did)
                    d.decode_enqueue(oc, self.now())
                    enqueued = True
                else:
                    enqueued = False
            if enqueued:
                if self.tracer is not None:
                    self.tracer.span("transfer", did, t_start,
                                     max(0.0, self.now() - t_start),
                                     rid=req.rid, attempt=attempt)
                if self.metrics.enabled:
                    self.metrics.counter("kv_transfers").inc()
                self._wake[did].set()
                return
            attempt = self._bump_retry(req, f"decode target {did} lost")
            if attempt < 0:
                return

    def _bump_retry(self, req: Request, why: str) -> int:
        """Spend one unit of the request's retry budget and sleep the
        exponential backoff; returns the new attempt number, or -1 when
        the budget is exhausted (request FAILED) or shutdown began."""
        with self._lock:
            req.retries += 1
            attempt = req.retries
        if attempt > self.recovery.max_retries:
            self._fail(req, f"kv transfer: {why}; retry budget "
                            f"({self.recovery.max_retries}) exhausted")
            return -1
        self.network.note_retransmit()
        if self.tracer is not None:
            self.tracer.instant("retransmit", "cluster", self.now(),
                                rid=req.rid, why=why, attempt=attempt)
        if self.metrics.enabled:
            self.metrics.counter("kv_retransmits").inc()
        if self._stop.wait(self.recovery.backoff(attempt)):
            return -1
        return attempt

    # -- fault plane --------------------------------------------------------
    def _on_fault(self, ev) -> None:
        if self.tracer is not None:
            self.tracer.instant(ev.kind, ev.iid, self.now())
        if self.metrics.enabled:
            self.metrics.counter(f"faults_{ev.kind}").inc()
        if ev.kind == CRASH:
            self._declare_dead(ev.iid, f"instance {ev.iid} died")
            return
        # HANG: freeze the instance's worker; a hang longer than the
        # heartbeat timeout is declared dead after the timeout elapses,
        # mirroring the sync cluster's detection semantics
        self._hung_until[ev.iid] = max(
            self._hung_until.get(ev.iid, 0.0), self.now() + ev.duration)
        if ev.duration > self.recovery.heartbeat_timeout_s:
            tm = threading.Timer(
                self.recovery.heartbeat_timeout_s, self._declare_dead,
                args=(ev.iid, f"instance {ev.iid} hung past the "
                              "heartbeat timeout"))
            tm.daemon = True
            tm.start()
            self._fault_timers.append(tm)

    def _declare_dead(self, iid: str, why: str) -> None:
        """Fence a crashed instance and recover everything stranded on
        it: pages/slots are reclaimed through the same engine ``cancel``
        plumbing user cancels use, then each request re-enters from the
        prompt on a survivor (its KV died with the instance) unless its
        retry budget is spent."""
        with self._lock:
            if iid in self._dead:
                return
            self._dead.add(iid)
        if self.tracer is not None:
            self.tracer.instant("declared_dead", iid, self.now())
        if self.metrics.enabled:
            self.metrics.counter("instances_declared_dead").inc()
        self._wake[iid].set()
        inst = self._inst(iid)
        with self._on(inst):
            resident = inst.resident_requests()
            for r in resident:
                inst.cancel(r.rid)
        for r in resident:
            self._recover(r, why)
        with self._cv:
            self._cv.notify_all()

    def _recover(self, req: Request, why: str) -> None:
        """Re-prefill a stranded request from its prompt on a surviving
        instance (or fail it once the budget is exhausted) — the same
        reset the synchronous cluster's ``_recover`` applies."""
        with self._lock:
            if req.rid in self._cancelled or req.phase in TERMINAL_PHASES:
                return
            req.retries += 1
            if req.retries > self.recovery.max_retries:
                budget_spent = True
            else:
                budget_spent = False
                req.phase = Phase.WAITING
                req.prefilled = 0
                req.generated = 0
                req.swapped = False
                req.cached_prefix_tokens = 0
                req.cached_prefix_pages = 0
                req.t_prefill_start = req.t_first_token = -1.0
                req.t_transfer_done = req.t_decode_start = -1.0
                buf = self._buffers.get(req.rid)
                if buf is not None:
                    del buf[:]    # the retried attempt refills the stream
                if self.tracer is not None:
                    self.tracer.instant("recovery", "cluster",
                                        self.now(), rid=req.rid,
                                        why=why, attempt=req.retries)
                if self.metrics.enabled:
                    self.metrics.counter("recoveries").inc()
        if budget_spent:
            self._fail(req, f"{why}; retry budget "
                            f"({self.recovery.max_retries}) exhausted")
            return
        self._route_prefill(req)
