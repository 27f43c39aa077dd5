"""Unified cluster serving API of the port (the reference's is in
``src/repro/serving``; docs/serving_api.md describes both).

One orchestration core (``Cluster``) drives N instances through the
``InstanceRuntime`` protocol — the port's engines on a CUDA card or the
CPU (``runtime="engine"``) — with a streaming request API on top:
``submit()`` → ``RequestHandle`` → iterate / ``cancel()`` /
``result()``, stop criteria via ``SamplingParams``.

Wall-clock runtime (docs/async_runtime.md): ``AsyncCluster`` runs each
instance on its own worker thread (and, on the card, its own CUDA
stream) with overlapped KV transfer, measuring TTFT/JCT in wall
seconds; ``AsyncRequestHandle`` is its streaming handle.
``OpenLoopClient`` drives it from an ``ArrivalSchedule`` (Poisson /
bursty / diurnal arrivals).  Both runtimes take ``prefix_cache=True``
(docs/prefix_cache.md).

Fault tolerance (docs/fault_tolerance.md): ``FaultSpec`` injects
deterministic instance crashes/hangs and KV-transfer faults;
``RecoveryPolicy`` tunes detection timeouts, retry backoff and the
retry budget; ``ClusterStallError`` carries a per-instance snapshot
when the cluster wedges.

Observability (docs/observability.md): pass ``tracer=Tracer()`` and/or
``metrics=MetricsRegistry()`` for per-request span timelines (JSONL +
Perfetto export), live counters/histograms and SLO attainment
(``SLOSpec`` via ``result(slo=...)``) — all zero-cost when left off.
"""
from repro_torch.obs import MetricsRegistry, SLOSpec, Tracer
from repro_torch.runtime.request import SamplingParams
from repro_torch.serving.arrivals import ArrivalSchedule, OpenLoopClient
from repro_torch.serving.async_runtime import (AsyncCluster,
                                               AsyncRequestHandle)
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
    "Tracer", "MetricsRegistry", "SLOSpec", "AsyncCluster",
    "AsyncRequestHandle", "ArrivalSchedule", "OpenLoopClient",
]
