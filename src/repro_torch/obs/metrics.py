"""Live metrics: counters / gauges / exact-percentile histograms +
pull-probes, snapshot-able mid-run.

Two kinds of metric feed the registry:

  * **event-driven** (counters, histograms) — pushed by the runtimes at
    request/transfer transitions, guarded by ``registry.enabled`` so a
    disabled registry costs one attribute read per site;
  * **pull-probes** — callables registered once and only evaluated
    inside ``snapshot()``, so they are free until someone asks.  The
    cluster registers its per-instance state probe here, and
    ``ClusterStallError`` renders THE SAME probe — stall diagnostics
    and live metrics cannot disagree by construction.

Histograms keep raw observations (``list.append`` — atomic under the
CPython GIL, so threaded callers share them lock-free) and
compute exact nearest-rank p50/p90/p99 at snapshot time.  Counters
take a small lock per ``inc`` because ``+=`` is NOT atomic across
threads; the event-loop runtimes are single-threaded and never
contend on it.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List

PERCENTILES = (50, 90, 99)


class Counter:
    """Monotonic counter."""
    __slots__ = ("value", "_lock")

    def __init__(self) -> None:
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins point value."""
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Raw-observation histogram with exact nearest-rank percentiles."""
    __slots__ = ("samples",)

    def __init__(self) -> None:
        self.samples: List[float] = []

    def observe(self, v: float) -> None:
        self.samples.append(v)

    def summary(self) -> dict:
        xs = sorted(self.samples)       # copy: observe() may race a
        n = len(xs)                     # snapshot on the async runtime
        if not n:
            return {"count": 0}
        out = {"count": n, "sum": float(sum(xs)),
               "avg": float(sum(xs) / n),
               "min": float(xs[0]), "max": float(xs[-1])}
        for p in PERCENTILES:
            # nearest-rank: the smallest sample >= p% of the mass —
            # an actual observation, never an interpolated value
            idx = max(0, -(-p * n // 100) - 1)
            out[f"p{p}"] = float(xs[idx])
        return out


class MetricsRegistry:
    """Name -> metric registry with pull-probes (module docstring)."""

    def __init__(self, enabled: bool = True):
        #: event-driven sites check this before touching a metric;
        #: probes ignore it (they only run inside snapshot())
        self.enabled = enabled
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}
        self._probes: Dict[str, Callable[[], dict]] = {}

    # -- get-or-create ---------------------------------------------------
    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge()
        return g

    def histogram(self, name: str) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram()
        return h

    # -- probes ----------------------------------------------------------
    def register_probe(self, name: str,
                       fn: Callable[[], dict]) -> None:
        self._probes[name] = fn

    def probe(self, name: str) -> dict:
        """Evaluate one pull-probe now (the stall-snapshot path)."""
        return self._probes[name]()

    # -- snapshot --------------------------------------------------------
    def snapshot(self) -> dict:
        """Point-in-time view of everything, safe to call mid-run."""
        return {
            "counters": {k: c.value
                         for k, c in sorted(self.counters.items())},
            "gauges": {k: g.value
                       for k, g in sorted(self.gauges.items())},
            "histograms": {k: h.summary()
                           for k, h in sorted(self.histograms.items())},
            "probes": {k: fn() for k, fn in sorted(self._probes.items())},
        }


def observe_request(metrics: MetricsRegistry, req) -> None:
    """Record one terminal request into the shared per-phase latency
    histograms + outcome counters (both runtimes call this; a disabled
    registry returns before touching anything)."""
    if not metrics.enabled:
        return
    phase = req.phase.value
    metrics.counter(f"requests_{phase}").inc()
    if req.retries:
        metrics.counter("request_retries").inc(req.retries)
    if phase != "finished":
        return
    if req.t_first_token >= 0:
        metrics.histogram("ttft_s").observe(req.ttft)
    metrics.histogram("jct_s").observe(req.jct)
    if req.t_transfer_done >= 0 and req.t_first_token >= 0:
        metrics.histogram("transfer_wait_s").observe(
            req.t_transfer_done - req.t_first_token)
    if req.t_decode_start >= 0 and req.t_first_token >= 0 \
            and req.generated > 0:
        metrics.histogram("tbt_s").observe(
            (req.t_finish - req.t_first_token) / req.generated)
