"""Real-execution instance runtime: the port's ``PrefillEngine`` /
``DecodeEngine`` pair behind the ``InstanceRuntime`` protocol.

This is what gives the engines multi-instance cluster serving: the
``Cluster`` routes arrivals across N of these, dispatches prefilled KV
by predicted length, applies the emulated transfer wait, and admits
into each instance's slot batch, driving the CUDA kernels on the card
(their plain versions on the CPU).

Time is virtual: one execution step (one prefill chunk / one decode
iteration) is billed a fixed ``step_dt`` tick on the event clock, while
``busy`` accumulates real wall seconds for throughput accounting.  The
engines copy each step's first tokens / argmax to the host before they
return, which waits for the step's device work, so the wall seconds
around an engine call cover its kernels.  Both role facets exist up
front, each with its own page pool on ``device``, so an instance flip
is the same internal-variable change as in the reference.

Under the wall-clock ``AsyncCluster`` every call into the engines takes
the instance's reentrant ``lock``, and with ``own_stream=True`` on the
card the instance has a CUDA ``stream`` of its own that every such
call enters, so two instances' steps can run on the card at once.  The
synchronous ``Cluster`` never contends on the lock and asks for no
stream (``stream`` is ``None``): its steps run on the caller's current
stream.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional

import torch

from repro_torch.core.decode_engine import DecodeEngine
from repro_torch.core.kv_transfer import NetworkStack
from repro_torch.core.prefill_engine import PrefillEngine
from repro_torch.core.sched.flip import FlipMachine, Role
from repro_torch.core.sched.prefill_scheduler import PrefillScheduler
from repro_torch.runtime.request import Request
from repro_torch.serving.runtime import PrefillOutcome, StepEvents


class EngineInstance:
    def __init__(self, iid: str, role: Role, *, cfg, params,
                 network: NetworkStack,
                 prefill_policy="sjf", sched_batch=16, chunk_size=16,
                 decode_policy="reserve-dynamic", max_slots=8,
                 n_pages=256, page_size=16, max_seq=128,
                 backend="auto", step_dt=0.01, prefix_cache=False,
                 device="cuda", own_stream=False):
        self.iid = iid
        # serializes ALL engine calls on this instance under the
        # wall-clock runtime: the instance's worker step, transfer-side
        # decode_enqueue, cancels and the crash-recovery sweep.
        # Reentrant so a holder can nest helper calls; the synchronous
        # Cluster never contends on it.
        self.lock = threading.RLock()
        device = torch.device(device)
        self.stream = (torch.cuda.Stream(device)
                       if own_stream and device.type == "cuda" else None)
        self.flip = FlipMachine(role)
        self.step_dt = step_dt
        self.busy = 0.0
        self.running = False
        self.swaps = 0
        # prediction is cluster-owned (uniform across runtimes), so the
        # prefill engine gets no predictor of its own
        self.pe = PrefillEngine(
            f"{iid}/prefill", cfg, params,
            scheduler=PrefillScheduler(prefill_policy, sched_batch),
            network=network, chunk_size=chunk_size, max_seq=max_seq,
            backend=backend, n_pages=n_pages, page_size=page_size,
            prefix_cache=prefix_cache, device=device)
        self.de = DecodeEngine(
            f"{iid}/decode", cfg, params, max_slots=max_slots,
            max_seq=max_seq, policy=decode_policy, n_pages=n_pages,
            page_size=page_size, backend=backend,
            prefix_cache=prefix_cache, device=device)

    # -- prefill facet ------------------------------------------------------
    def prefill_enqueue(self, req: Request) -> None:
        self.pe.submit(req)

    def prefill_queued_tokens(self) -> int:
        return self.pe.queued_tokens

    def prefill_start(self, now: float) -> Optional[float]:
        if self.pe.idle():
            return None
        return self.step_dt

    def prefill_complete(self, now: float) -> List[PrefillOutcome]:
        t0 = time.perf_counter()
        finished = self.pe.step(now)
        self.busy += time.perf_counter() - t0
        return [PrefillOutcome(req=pk.req, n_chunks=pk.n_chunks,
                               first_token=pk.first_token, payload=pk,
                               transfer_delay_s=pk.transfer_delay_s)
                for pk in finished]

    def prefill_idle(self) -> bool:
        return self.pe.idle()

    # -- decode facet -------------------------------------------------------
    def decode_enqueue(self, outcome: PrefillOutcome, now: float) -> None:
        self.de.receive(outcome.payload, now=now)

    def decode_queue_len(self) -> int:
        return len(self.de.scheduler.queue)

    def decode_load(self) -> dict:
        return self.de.load()

    def decode_start(self, now: float) -> Optional[float]:
        t0 = time.perf_counter()
        self.de.admit(now)
        self.busy += time.perf_counter() - t0
        if not self.de.slots:
            return None
        return self.step_dt

    def decode_complete(self, now: float) -> StepEvents:
        t0 = time.perf_counter()
        finished = self.de.step(now)
        self.busy += time.perf_counter() - t0
        return StepEvents(stream=list(self.de.stream_events),
                          finished=[f.req for f in finished])

    def decode_idle(self) -> bool:
        return self.de.idle()

    # -- shared -------------------------------------------------------------
    def idle(self) -> bool:
        return self.prefill_idle() and self.decode_idle()

    def cancel(self, rid: str) -> bool:
        cancelled = self.pe.cancel(rid)
        return self.de.cancel(rid) or cancelled

    def resident_requests(self) -> List[Request]:
        seen = {r.rid: r for r in self.pe.resident()}
        for r in self.de.resident():
            seen.setdefault(r.rid, r)
        return list(seen.values())
