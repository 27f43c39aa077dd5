"""Unified cluster serving API of the port (the reference's is in
``src/repro/serving``; docs/serving_api.md describes both).

One orchestration core (``Cluster``) drives N instances through the
``InstanceRuntime`` protocol — the port's engines on a CUDA card or the
CPU (``runtime="engine"``) — with a streaming request API on top:
``submit()`` → ``RequestHandle`` → iterate / ``cancel()`` /
``result()``, stop criteria via ``SamplingParams``.

Fault tolerance (docs/fault_tolerance.md): ``FaultSpec`` injects
deterministic instance crashes/hangs and KV-transfer faults;
``RecoveryPolicy`` tunes detection timeouts, retry backoff and the
retry budget; ``ClusterStallError`` carries a per-instance snapshot
when the cluster wedges.

Observability (docs/observability.md): pass ``tracer=Tracer()`` and/or
``metrics=MetricsRegistry()`` for per-request span timelines (JSONL +
Perfetto export), live counters/histograms and SLO attainment
(``SLOSpec`` via ``result(slo=...)``) — all zero-cost when left off.

The reference's wall-clock ``AsyncCluster``, ``AsyncRequestHandle``,
``ArrivalSchedule`` and ``OpenLoopClient`` come with the async slice
(ROADMAP A.10).
"""
from repro_torch.obs import MetricsRegistry, SLOSpec, Tracer
from repro_torch.runtime.request import SamplingParams
from repro_torch.serving.cluster import (Cluster, ClusterStallError,
                                         RequestHandle, RequestResult,
                                         SimResult)
from repro_torch.serving.faults import FaultEvent, FaultSpec, RecoveryPolicy
from repro_torch.serving.runtime import (InstanceRuntime, PrefillOutcome,
                                         StepEvents)

__all__ = [
    "Cluster", "ClusterStallError", "RequestHandle", "RequestResult",
    "SimResult", "SamplingParams", "FaultSpec", "FaultEvent",
    "RecoveryPolicy", "InstanceRuntime", "PrefillOutcome", "StepEvents",
    "Tracer", "MetricsRegistry", "SLOSpec",
]
