"""Cost-model-timed instance runtime (the simulator's execution model),
the reference's ``repro.serving.sim_instance`` on the port's schedulers
and allocator.

The operation ORDER inside each method is the reference's, step for
step: the port's ``Cluster(runtime="sim")`` reproduces the reference's
metrics bit for bit on fixed seeds (tests/golden_sim_metrics.json), so
keep RNG-consuming and accounting steps in sequence when editing.  It
holds no tensor and touches no device.
"""
from __future__ import annotations

from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional

from repro_torch.core import chunking
from repro_torch.core.sched.decode_scheduler import DecodeScheduler
from repro_torch.core.sched.flip import FlipMachine, Role
from repro_torch.core.sched.prefill_scheduler import PrefillScheduler
from repro_torch.kvcache.paged import (OutOfPages, PagedAllocator,
                                       request_page_keys)
from repro_torch.runtime.costmodel import CostModel
from repro_torch.runtime.request import Phase, Request
from repro_torch.serving.runtime import PrefillOutcome, StepEvents

SWAP_BW = 4e9   # effective PCIe swap bandwidth (serialized, paper-era V100)


class SimInstance:
    """One engine that can serve either role; flip just switches the flag
    (paper §3.5) — both facets' state lives in the same object."""

    def __init__(self, iid: str, role: Role, *, cfg, cost: CostModel,
                 sched_policy, sched_batch, chunk_size, decode_policy,
                 n_pages, page_size, max_batch, co_run_predictor=True,
                 prefix_cache=False):
        self.iid = iid
        self.cfg = cfg
        self.cost = cost
        self.chunk_size = chunk_size
        self.co_run = co_run_predictor
        # hot-path constants (cfg is frozen; chunk cost depends only on
        # chunk_size + the co-run flag — same floats, computed once)
        self._kv_per_tok = cfg.kv_bytes_per_token()
        self._chunk_cost_s = (cost.prefill_time(chunk_size)
                              * cost.predictor_overhead(co_run_predictor))
        self.flip = FlipMachine(role)
        # prefill facet
        self.psched = PrefillScheduler(sched_policy, sched_batch)
        self.chunks: Deque[chunking.Chunk] = deque()
        self._inflight: Optional[chunking.Chunk] = None
        self.reqs: Dict[str, Request] = {}
        # prefix cache (cost-model analogue): the prefill facet has no
        # device pool, so its cache is a capacity-bounded LRU over page
        # KEYS — a hit skips the chunk cost + wire bytes the real engine
        # would skip.  The decode facet shares pages through the real
        # allocator refcounts, same as the engine runtime.
        self.prefix_cache = prefix_cache and not cfg.sliding_window
        self._prefix_lru: "OrderedDict[bytes, bool]" = OrderedDict()
        self._prefix_cap = n_pages
        # decode facet
        self.alloc = PagedAllocator(n_pages, page_size,
                                    prefix_cache=self.prefix_cache)
        self.dsched = DecodeScheduler(self.alloc, decode_policy, max_batch)
        self.busy = 0.0
        self.running = False
        self.swaps = 0

    # -- prefill facet ------------------------------------------------------
    def prefill_enqueue(self, req: Request) -> None:
        self.psched.add(req)

    def prefill_queued_tokens(self) -> int:
        return self.psched.queued_tokens

    def _prefill_cache_lookup(self, req: Request) -> int:
        """Model the prefill-side prefix cache: count the leading run of
        the request's page keys already in the LRU (cache hit => the
        engine would alias those pages and skip their chunks), then
        commit ALL of its full-page keys.  Returns cached TOKENS, capped
        so at least the last prompt token is always 'recomputed' (the
        engine needs its logits for the first token)."""
        keys = request_page_keys(req, self.alloc.page_size)
        if not keys:
            return 0
        hits = 0
        for k in keys:
            if k not in self._prefix_lru:
                break
            self._prefix_lru.move_to_end(k)
            hits += 1
        for k in keys:
            self._prefix_lru[k] = True
            self._prefix_lru.move_to_end(k)
        while len(self._prefix_lru) > self._prefix_cap:
            self._prefix_lru.popitem(last=False)
        ps = self.alloc.page_size
        return min(hits, max(0, (req.prompt_len - 1) // ps)) * ps

    def _refill(self) -> None:
        batch = self.psched.next_batch(self.psched.sched_batch)
        if batch:
            starts: Dict[str, int] = {}
            if self.prefix_cache:
                for r in batch:
                    cached = self._prefill_cache_lookup(r)
                    if cached:
                        r.cached_prefix_tokens = cached
                        r.cached_prefix_pages = cached // \
                            self.alloc.page_size
                        starts[r.rid] = cached
            pairs = [(r.rid, r.prompt_len) for r in batch]
            self.chunks.extend(chunking.partition(
                pairs, self.chunk_size, starts=starts or None))
            for r in batch:
                self.reqs[r.rid] = r

    def _chunk_cost(self) -> float:
        return self._chunk_cost_s

    def prefill_start(self, now: float) -> Optional[float]:
        if not self.chunks:
            self._refill()
        if not self.chunks:
            return None
        # pop NOW so a cancel() between start and completion can only
        # touch queued chunks, never the one in flight (cancelled
        # requests' segments are skipped at completion instead)
        self._inflight = self.chunks.popleft()
        for seg in self._inflight.segments:
            r = self.reqs.get(seg.rid)
            if r is not None and r.t_prefill_start < 0:
                r.t_prefill_start = now
                r.phase = Phase.PREFILL
        return self._chunk_cost()

    def prefill_complete(self, now: float) -> List[PrefillOutcome]:
        chunk, self._inflight = self._inflight, None
        self.busy += self._chunk_cost()
        out: List[PrefillOutcome] = []
        for seg in chunk.segments:
            req = self.reqs.get(seg.rid)
            if req is None:          # cancelled mid-flight
                continue
            req.prefilled = seg.req_start + seg.length
            if req.prefilled >= req.prompt_len:
                req.t_first_token = now
                self.reqs.pop(req.rid)
                out.append(PrefillOutcome(
                    req=req,
                    n_chunks=chunking.chunks_for(
                        req.prompt_len - req.cached_prefix_tokens,
                        self.chunk_size)))
        return out

    def prefill_idle(self) -> bool:
        return len(self.psched) == 0 and not self.chunks \
            and self._inflight is None

    # -- decode facet -------------------------------------------------------
    def decode_enqueue(self, outcome: PrefillOutcome, now: float) -> None:
        req = outcome.req
        req.phase = Phase.DECODE_QUEUED
        req.t_transfer_done = now
        self.dsched.enqueue(req)

    def decode_queue_len(self) -> int:
        return len(self.dsched.queue)

    def decode_load(self) -> dict:
        return self.dsched.load()

    def decode_start(self, now: float) -> Optional[float]:
        admitted = self.dsched.admit()
        swap_in = 0.0
        for r in admitted:
            if r.swapped:        # pay to bring the KV back (PCIe-class)
                kvb = self._kv_per_tok * (r.prompt_len + r.generated)
                swap_in += kvb / SWAP_BW
                r.swapped = False
            # a request only ever enters the running set through this
            # admit, so stamping the newly admitted ones is identical
            # to the old rescan of the whole batch for t_decode_start<0
            if r.t_decode_start < 0:
                r.t_decode_start = now
                r.phase = Phase.DECODE
        self.busy += swap_in
        batch = len(self.dsched.running)
        if not batch:
            return None
        return self.cost.decode_time(batch, self.dsched.ctx_sum) + swap_in

    def decode_complete(self, now: float) -> StepEvents:
        batch = len(self.dsched.running)
        iter_time = self.cost.decode_time(batch, self.dsched.ctx_sum)
        ev = StepEvents()
        for rid in list(self.dsched.running):
            req = self.dsched.running[rid].req
            try:
                self.dsched.step_token(rid)
            except OutOfPages:
                # greedy-policy thrash: evict (swap out), pay the
                # penalty, requeue
                self.swaps += 1
                self.alloc.swap_events += 1
                kvb = self._kv_per_tok * (req.prompt_len + req.generated)
                self.busy += kvb / SWAP_BW
                self.dsched.finish(rid)          # frees pages
                req.phase = Phase.DECODE_QUEUED
                req.swapped = True
                self.dsched.enqueue(req)
                continue
            ev.stream.append((rid, -1))   # the sim generates lengths,
            if self._should_finish(req):  # not token ids
                req.phase = Phase.FINISHED
                req.t_finish = now
                self.dsched.finish(rid)
                ev.finished.append(req)
        # no device pool here: copy-on-write redirects are bookkeeping
        # only, but the pending list must still be drained (the engine
        # runtime replays these on its PagePool)
        self.alloc.take_cow_copies()
        self.busy += iter_time
        return ev

    def _should_finish(self, req: Request) -> bool:
        if req.sampling is not None:
            # +1: the prefill-emitted first token counts toward the cap.
            # The sim generates lengths, not token ids, so stop_token_ids
            # can never fire here — decode_len (submit() derives it from
            # the cap / max_seq) stays as the hard bound so a
            # stop-ids-only request still terminates.
            return req.sampling.should_stop(1 + req.generated, None) \
                or req.generated >= req.decode_len
        return req.generated >= req.decode_len

    def decode_idle(self) -> bool:
        return not self.dsched.running and not self.dsched.queue

    # -- shared -------------------------------------------------------------
    def idle(self) -> bool:
        return self.prefill_idle() and self.decode_idle()

    def cancel(self, rid: str) -> bool:
        known = False
        if rid in self.reqs or self.psched.remove(rid):
            # queued chunks only — an in-flight chunk's cancelled
            # segments are skipped when it completes
            self.reqs.pop(rid, None)
            self.chunks = deque(chunking.drop_rid(self.chunks, rid))
            known = True
        return self.dsched.cancel(rid) or known

    def resident_requests(self) -> List[Request]:
        seen: Dict[str, Request] = {}
        for r in self.psched.all_requests():
            seen[r.rid] = r
        for r in self.reqs.values():          # chunk-queued / in-flight
            seen[r.rid] = r
        for r in self.dsched.queue:
            seen[r.rid] = r
        for ri in self.dsched.running.values():
            seen[ri.req.rid] = ri.req
        return list(seen.values())
