"""Prefill-instance local scheduler (paper §3.3.1).

Policies: FCFS / SJF / LJF over a ``PrefillSchedBatch`` window — sorting
happens within a bounded batch of requests at a time, which prevents
starvation of long (SJF) or short (LJF) prompts.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, List

from repro_torch.runtime.request import Request

POLICIES = ("fcfs", "sjf", "ljf")
DEFAULT_SCHED_BATCH = 16     # paper's default (§5.1)


class PrefillScheduler:
    def __init__(self, policy: str = "sjf",
                 sched_batch: int = DEFAULT_SCHED_BATCH):
        assert policy in POLICIES, policy
        self.policy = policy
        self.sched_batch = sched_batch
        self.raw: Deque[Request] = deque()
        self.scheduled: Deque[Request] = deque()
        # incremental queued-token count: the cluster monitor and the
        # global scheduler read this once per arrival/tick, which at
        # fleet scale must not rescan the queue.  A request's
        # contribution (prompt_len - prefilled) is fixed while it sits
        # here — ``prefilled`` only mutates after ``next_batch`` pops it
        # — so add/remove bookkeeping mirrors the scan exactly.
        self._queued_tokens = 0

    def add(self, req: Request) -> None:
        self.raw.append(req)
        self._queued_tokens += req.prompt_len - req.prefilled

    def __len__(self) -> int:
        return len(self.raw) + len(self.scheduled)

    @property
    def queued_tokens(self) -> int:
        return self._queued_tokens

    def _schedule_window(self) -> None:
        """Move up to sched_batch requests raw -> scheduled, sorted by
        policy.  The window bound is the anti-starvation mechanism."""
        window: List[Request] = []
        while self.raw and len(window) < self.sched_batch:
            window.append(self.raw.popleft())
        if self.policy == "sjf":
            window.sort(key=lambda r: r.prompt_len)
        elif self.policy == "ljf":
            window.sort(key=lambda r: -r.prompt_len)
        # fcfs: keep arrival order
        self.scheduled.extend(window)

    def next_batch(self, max_requests: int) -> List[Request]:
        """Pop up to max_requests scheduled requests for chunking."""
        if not self.scheduled:
            self._schedule_window()
        out: List[Request] = []
        while self.scheduled and len(out) < max_requests:
            r = self.scheduled.popleft()
            self._queued_tokens -= r.prompt_len - r.prefilled
            out.append(r)
        return out

    def requeue_front(self, reqs: List[Request]) -> None:
        """Put popped requests back at the head of the scheduled queue in
        their original order (engine backpressure, e.g. KV pages full)."""
        for r in reversed(reqs):
            self.scheduled.appendleft(r)
            self._queued_tokens += r.prompt_len - r.prefilled

    def remove(self, rid: str) -> bool:
        """Drop a queued request (user cancel).  Returns whether it was
        still queued here (False once it moved on to the chunk queue)."""
        n = len(self)
        for q in (self.raw, self.scheduled):
            for r in q:
                if r.rid == rid:
                    self._queued_tokens -= r.prompt_len - r.prefilled
        self.raw = deque(r for r in self.raw if r.rid != rid)
        self.scheduled = deque(r for r in self.scheduled if r.rid != rid)
        return len(self) < n

    def all_requests(self) -> List[Request]:
        """Non-mutating view of every queued request (raw + scheduled) —
        unlike ``peek_all`` this never advances the scheduling window,
        so it is safe for monitoring/recovery snapshots."""
        return list(self.raw) + list(self.scheduled)

    def peek_all(self) -> List[Request]:
        if not self.scheduled:
            self._schedule_window()
        return list(self.scheduled)
