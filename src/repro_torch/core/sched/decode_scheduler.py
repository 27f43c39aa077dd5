"""Decode-instance local scheduler: intra-decode scheduling (§3.4).

Continuous batching admission policies against the paged KV allocator:

* ``greedy``          — vLLM's policy: admit while there is spare memory
                        *now*; oblivious to working-set growth (can thrash
                        / trigger swaps later).
* ``reserve-static``  — admit only if the request's full predicted memory
                        (prompt + predicted-hi generation) fits free pages.
* ``reserve-dynamic`` — admit if memory suffices until the *shortest
                        remaining* running job finishes and releases its
                        pages: batch growth until then must stay under the
                        free-page budget.  Proactive, paging-friendly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.kvcache.paged import (PagedAllocator, request_cross_key,
                                 request_page_keys)
from repro_torch.runtime.request import Request

POLICIES = ("greedy", "reserve-static", "reserve-dynamic")


@dataclasses.dataclass
class RunningInfo:
    req: Request
    # heavy-decode status is frozen at admission (predicted_hi is set
    # before dispatch and never changes while running) so the monitor's
    # load snapshot can count heavies in O(1) instead of rescanning
    heavy: bool = False

    # pages currently held is tracked by the allocator; remaining below
    # is predicted remaining decode tokens (scheduler never sees truth)
    def predicted_remaining(self) -> int:
        hi = self.req.predicted_hi or self.req.decode_len
        return max(1, hi - self.req.generated)


HEAVY_THRESH = 128


class DecodeScheduler:
    """Incremental-bookkeeping invariants (fleet-scale hot path): the
    batch context sum (``ctx_sum``) and heavy count are maintained on
    admit/step/finish instead of rescanned per event.  Both are exact
    integer mirrors of the scan they replace — ``generated`` only ever
    mutates through ``step_token`` — so fixed-seed metrics are
    byte-identical to the scanning implementation."""

    def __init__(self, allocator: PagedAllocator,
                 policy: str = "reserve-dynamic", max_batch: int = 64):
        assert policy in POLICIES, policy
        self.alloc = allocator
        self.policy = policy
        self.max_batch = max_batch
        self.queue: List[Request] = []
        self.running: Dict[str, RunningInfo] = {}
        self.ctx_sum = 0          # sum(prompt_len + generated) running
        self._n_heavy = 0         # running requests with heavy decode

    # ------------------------------------------------------------------
    def enqueue(self, req: Request) -> None:
        self.queue.append(req)

    def _pages_for_tokens(self, tokens: int) -> int:
        # window-aware: a sliding-window request only ever HOLDS the
        # in-window pages, so admission budgets against that, not the
        # full logical length
        return self.alloc.pages_for_request(max(1, tokens))

    def _keys(self, req: Request) -> Optional[list]:
        """Prefix-cache page keys for admission math + alloc aliasing
        (None when the cache is off or the config windows pages)."""
        if not self.alloc.prefix_cache or self.alloc.window:
            return None
        return request_page_keys(req, self.alloc.page_size)

    def _admissible(self, req: Request,
                    page_keys: Optional[list] = None) -> bool:
        """Policy decision. The request's prefilled KV (prompt_len tokens)
        must be materialized on admission; generation grows it — pages
        already shared through the prefix cache are budgeted ONCE across
        the batch (``pages_needed`` subtracts the cached leading run)."""
        now_pages = self.alloc.pages_needed(req.prompt_len + 1,
                                            page_keys=page_keys)
        hi = req.predicted_hi or req.decode_len
        if self.policy == "greedy":
            return self.alloc.free_pages >= now_pages
        if self.policy == "reserve-static":
            # free pages must cover this request's full predicted usage
            # PLUS the outstanding (reserved but not yet allocated) growth
            # of every running request — a reservation is a commitment.
            total = self.alloc.pages_needed(req.prompt_len + hi,
                                            page_keys=page_keys)
            committed = 0
            for rid, ri in self.running.items():
                r_hi = ri.req.predicted_hi or ri.req.decode_len
                full = self._pages_for_tokens(ri.req.prompt_len + r_hi)
                held = self.alloc.pages_held(rid)
                committed += max(0, full - held)
            return self.alloc.free_pages >= total + committed
        # reserve-dynamic
        if not self.running:
            return self.alloc.free_pages >= now_pages
        shortest = min(ri.predicted_remaining()
                       for ri in self.running.values())
        # batch page growth until the shortest job completes
        growth = sum(
            self._pages_for_tokens(min(ri.predicted_remaining(), shortest))
            - self._pages_for_tokens(0)
            for ri in self.running.values())
        growth += self.alloc.pages_needed(
            req.prompt_len + min(hi, shortest), page_keys=page_keys)
        return self.alloc.free_pages >= growth

    def admit(self) -> List[Request]:
        """Admit queued requests into the running batch per policy.
        Returns newly admitted requests (caller materializes their KV)."""
        admitted: List[Request] = []
        remaining: List[Request] = []
        for i, req in enumerate(self.queue):
            if len(self.running) + len(admitted) >= self.max_batch:
                # batch full: no later candidate can be admitted, so the
                # per-request policy checks would all be dead code —
                # short-circuit the scan (identical admission outcome)
                remaining.extend(self.queue[i:])
                break
            keys = self._keys(req)
            cross_key = (request_cross_key(req)
                         if keys is not None
                         and self.alloc.cross_pages_per_request else None)
            if (self._admissible(req, keys)
                    and self.alloc.can_admit(req.prompt_len + 1,
                                             page_keys=keys,
                                             cross_key=cross_key)):
                self.alloc.alloc(req.rid, req.prompt_len,
                                 page_keys=keys, cross_key=cross_key)
                if keys:
                    # publish ALL full prompt pages: the aliased prefix
                    # is already cached, and the freshly installed pages
                    # become hits for the next sharer admitted here
                    self.alloc.commit(req.rid, keys)
                heavy = req.is_heavy_decode(HEAVY_THRESH)
                self.running[req.rid] = RunningInfo(req, heavy=heavy)
                self.ctx_sum += req.prompt_len + req.generated
                self._n_heavy += heavy
                admitted.append(req)
            else:
                remaining.append(req)
        self.queue = remaining
        return admitted

    def step_token(self, rid: str) -> int:
        """Account one generated token for a running request.  Returns
        the physical page holding the new token (the paged decode engine
        scatters the token's K/V there)."""
        page = self.alloc.append_token(rid)
        self.running[rid].req.generated += 1
        self.ctx_sum += 1
        return page

    def finish(self, rid: str) -> None:
        self.alloc.free(rid)
        ri = self.running.pop(rid)
        self.ctx_sum -= ri.req.prompt_len + ri.req.generated
        self._n_heavy -= ri.heavy

    def cancel(self, rid: str) -> bool:
        """User cancel: frees the pages of a running request, or drops a
        queued one.  Returns whether the request was known here."""
        if rid in self.running:
            self.finish(rid)
            return True
        n = len(self.queue)
        self.queue = [r for r in self.queue if r.rid != rid]
        return len(self.queue) < n

    # -- load snapshot for the cluster monitor --------------------------
    def load(self, heavy_thresh: int = HEAVY_THRESH) -> dict:
        heavy = (self._n_heavy if heavy_thresh == HEAVY_THRESH
                 else sum(1 for ri in self.running.values()
                          if ri.req.is_heavy_decode(heavy_thresh)))
        return {
            "free_pages": self.alloc.free_pages,
            "n_heavy": heavy,
            "n_light": len(self.running) - heavy,
            "queued": len(self.queue),
            "batch": len(self.running),
        }
