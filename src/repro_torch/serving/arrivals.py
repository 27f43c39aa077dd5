"""Open-loop arrival client for the port's wall-clock runtime (the
reference's ``src/repro/serving/arrivals.py``; docs/async_runtime.md).

Closed-loop drivers (submit, wait, submit…) let a slow server throttle
its own load; an OPEN-loop client submits on a fixed arrival schedule
regardless of completions, which is what latency-under-load studies
need (and what the paper's mixed-downstream-workload scenarios assume).

``ArrivalSchedule`` wraps the fleet harness's arrival machinery (the
port's copy of the reference's ``fleet.traces._arrival_times``: exact
Poisson / bursty / diurnal processes via time-rescaling), so wall-clock
runs draw the same arrival times as the reference for the same seed.
``OpenLoopClient`` then drives ``AsyncCluster.submit()`` from a
dedicated thread: it sleeps until each arrival instant and submits,
never waiting on the previous request.

``time_scale`` compresses the schedule (0.1 ⇒ 10× faster than real
time) so CI smoke runs finish in seconds while keeping the process
shape; metrics stay in wall seconds.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.fleet.traces import PROCESSES, _arrival_times
from repro_torch.runtime.request import Request


@dataclasses.dataclass(frozen=True)
class ArrivalSchedule:
    """Seeded arrival-process parameters (the knobs and semantics of the
    reference's ``fleet.traces.generate_trace``): ``rate`` is the MEAN rate
    in req/s for every non-batch process, ``period_s`` the day length
    (diurnal) or burst cycle (bursty)."""
    process: str = "poisson"
    rate: float = 20.0
    seed: int = 0
    period_s: float = 10.0
    diurnal_amplitude: float = 0.6
    burst_factor: float = 4.0
    burst_fraction: float = 0.1

    def __post_init__(self):
        if self.process not in PROCESSES:
            raise ValueError(f"arrival process {self.process!r} not in "
                             f"{PROCESSES}")
        if self.process != "batch" and not self.rate > 0:
            raise ValueError("non-batch arrivals need rate > 0")
        if (self.process == "bursty"
                and not self.burst_factor * self.burst_fraction < 1.0):
            raise ValueError("bursty profile needs burst_factor * "
                             "burst_fraction < 1")

    def times(self, n: int) -> np.ndarray:
        """(n,) non-decreasing arrival offsets in seconds from t=0.
        Deterministic per (schedule fields, n)."""
        rng = np.random.default_rng(self.seed)
        kw = {}
        if self.process in ("bursty", "diurnal"):
            kw = dict(period_s=self.period_s,
                      diurnal_amplitude=self.diurnal_amplitude,
                      burst_factor=self.burst_factor,
                      burst_fraction=self.burst_fraction)
        return _arrival_times(rng, n, self.process, self.rate, **kw)


class OpenLoopClient:
    """Submit ``requests`` to ``cluster`` on ``schedule``'s wall-clock
    instants, independent of completions (open loop).

    ``cluster`` only needs a ``submit(request=...) -> handle`` method,
    so the client drives ``AsyncCluster`` and (for schedule debugging)
    the synchronous ``Cluster`` alike.  ``start()`` launches the
    submission thread; ``join()`` waits for the LAST submission (not
    for completions — drain the cluster for that) and re-raises any
    submission failure (a ``submit()`` exception stops the schedule;
    it is recorded on ``error`` and surfaced instead of silently
    dropping the remaining arrivals); ``handles`` collects the
    returned streaming handles in submission order.
    """

    def __init__(self, cluster, requests: Sequence[Request],
                 schedule: ArrivalSchedule, *, time_scale: float = 1.0,
                 on_submit: Optional[Callable] = None):
        if not time_scale > 0:
            raise ValueError(f"time_scale {time_scale} must be > 0")
        self._cluster = cluster
        self._requests = list(requests)
        self._offsets = schedule.times(len(self._requests)) * time_scale
        self._on_submit = on_submit
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.handles: List[object] = []
        self.submitted = 0
        self.error: Optional[Exception] = None

    def start(self) -> "OpenLoopClient":
        if self._thread is not None:
            raise RuntimeError("client already started")
        self._thread = threading.Thread(
            target=self._run, name="open-loop-client", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        t0 = time.monotonic()
        try:
            for req, off in zip(self._requests, self._offsets):
                # sleep to the arrival instant; an overloaded submit
                # path makes us late, never early — open loop, no
                # back-pressure
                delay = t0 + float(off) - time.monotonic()
                if delay > 0 and self._stop.wait(delay):
                    return
                if self._stop.is_set():
                    return
                h = self._cluster.submit(request=req)
                self.handles.append(h)
                self.submitted += 1
                if self._on_submit is not None:
                    self._on_submit(h)
        except Exception as e:
            self.error = e    # re-raised by join()/stop()

    def _check(self) -> None:
        if self.error is not None:
            raise RuntimeError(
                f"open-loop client died after {self.submitted}/"
                f"{len(self._requests)} submissions") from self.error

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is None:
            raise RuntimeError("client never started")
        self._thread.join(timeout)
        self._check()

    def stop(self) -> None:
        """Abort remaining submissions (already-submitted requests keep
        running; cancel them through their handles)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._check()
