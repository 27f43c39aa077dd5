"""Unified observability plane (docs/observability.md), the port's own
copy of ``src/repro/obs``: the same records, counters and summaries, so
a traced port run reads as a traced reference run.

The port's event-loop ``Cluster`` (engine runtime) is its one user so
far — zero-cost when off (the default: no tracer, a disabled registry
whose probes are only evaluated on demand).

  * ``Tracer``           — structured span/instant/counter records with
    JSONL and Chrome/Perfetto ``trace_event`` exporters; a run renders
    as a real timeline (instances as tracks, one row per request).
  * ``MetricsRegistry``  — counters / gauges / exact-percentile
    histograms plus pull-probes, snapshot-able mid-run; the single
    source of truth behind ``ClusterStallError`` diagnostics.
  * ``SLOSpec``          — DistServe-style TTFT/TBT attainment targets
    threaded through ``summarize()`` and ``FleetReport`` (goodput).
  * ``EventLoopProfiler`` — per-event-kind handler profiler (hangs off
    ``Cluster.profiler``).
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                               observe_request)
from repro_torch.obs.profile import EventLoopProfiler
from repro_torch.obs.slo import SLOSpec, attainment, good_count, meets_slo
from repro_torch.obs.tracer import (SCHEMA_VERSION, TERMINAL_EVENTS, Tracer,
                              read_jsonl, validate_chains,
                              validate_jsonl_records, validate_perfetto)

__all__ = [
    "Counter", "EventLoopProfiler", "Gauge", "Histogram",
    "MetricsRegistry", "SCHEMA_VERSION", "SLOSpec", "TERMINAL_EVENTS",
    "Tracer", "attainment", "good_count", "meets_slo", "observe_request",
    "read_jsonl", "validate_chains", "validate_jsonl_records",
    "validate_perfetto",
]
