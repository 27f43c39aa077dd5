"""Fleet run harness: spec -> cluster -> report.

``FleetSpec`` names a cluster shape (counts, policies, link, knobs) and
builds a ``Cluster(runtime="sim")``; ``run_fleet`` replays a trace
through it and reduces the terminal requests to a ``FleetReport`` —
the paper-facing serving metrics (TTFT/JCT/goodput, DistServe-style SLO
attainment) next to harness-facing throughput (wall seconds, events
processed, events/sec, optional per-event-kind profile).

The reference's ``repro.fleet.harness`` on the port.  The sim runtime
runs on the host alone: a fleet run touches no device.  ``HARDWARE``
adds the port's target, ``"h100"``; ``FleetSpec``'s defaults stay the
reference's (``v100_tp2``, 88 + 40 instances).
"""
from __future__ import annotations

import dataclasses
from time import perf_counter
from typing import Dict, List, Optional, Union

from repro_torch.configs import get_config
from repro_torch.core.kv_transfer import (TS_ICI, TS_NVLINK, TS_ROCE,
                                          TS_SOCKET, NetworkStack)
from repro_torch.fleet.profile import EventLoopProfiler
from repro_torch.fleet.traces import Trace
from repro_torch.obs.slo import SLOSpec, good_count
from repro_torch.runtime.costmodel import CostModel, HardwareSpec
from repro_torch.runtime.request import Phase, Request
from repro_torch.serving.cluster import Cluster

LINKS = {"nvlink": TS_NVLINK, "roce": TS_ROCE, "socket": TS_SOCKET,
         "ici": TS_ICI}
HARDWARE = {"v100_tp2": HardwareSpec.v100_tp2,
            "tpu_v5e": HardwareSpec.tpu_v5e, "h100": HardwareSpec.h100}


@dataclasses.dataclass
class FleetSpec:
    """Cluster shape for a fleet scenario (sim runtime only)."""
    n_prefill: int = 88
    n_decode: int = 40
    model: str = "opt_13b"
    n_params: int = 13_000_000_000
    hardware: str = "v100_tp2"
    link: str = "nvlink"
    chunk_size: int = 512
    n_pages: int = 4096
    page_size: int = 16
    max_batch: int = 64
    sched_batch: int = 16
    prefill_policy: str = "sjf"
    decode_policy: str = "reserve-dynamic"
    dispatch_policy: str = "power2"
    enable_flip: bool = False
    flip_idle_s: float = 60.0
    # fleet-scale knobs: sparser monitor ticks (default cluster interval
    # is 0.1s — fine for 16 instances, wasteful for 500) and no token
    # buffers (10^6 requests x decode_len ints is real memory)
    monitor_interval_s: float = 0.25
    collect_tokens: bool = False
    # DistServe-style SLOs for goodput accounting
    slo_ttft_s: float = 5.0
    slo_tbt_s: float = 0.25

    @property
    def slo(self) -> SLOSpec:
        """The spec's SLO targets as the shared ``repro_torch.obs``
        type."""
        return SLOSpec(ttft_target_s=self.slo_ttft_s,
                       tbt_target_s=self.slo_tbt_s)

    @property
    def n_instances(self) -> int:
        return self.n_prefill + self.n_decode

    def build_cluster(self, *, network: Optional[NetworkStack] = None,
                      faults=None, tracer=None, metrics=None) -> Cluster:
        cfg = get_config(self.model)
        cost = CostModel(cfg, HARDWARE[self.hardware](),
                         n_params=self.n_params)
        return Cluster(
            cfg, runtime="sim", cost=cost,
            n_prefill=self.n_prefill, n_decode=self.n_decode,
            prefill_policy=self.prefill_policy,
            sched_batch=self.sched_batch, chunk_size=self.chunk_size,
            decode_policy=self.decode_policy,
            dispatch_policy=self.dispatch_policy,
            network=network or NetworkStack(LINKS[self.link]),
            n_pages=self.n_pages, page_size=self.page_size,
            max_batch=self.max_batch, enable_flip=self.enable_flip,
            flip_idle_s=self.flip_idle_s,
            monitor_interval_s=self.monitor_interval_s,
            collect_tokens=self.collect_tokens, faults=faults,
            tracer=tracer, metrics=metrics)

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class FleetReport:
    """One fleet run reduced to serving + harness metrics."""
    metrics: Dict              # summarize() output (avg/p90 ttft, jct, ...)
    requests: int              # submitted
    finished: int
    failed: int
    goodput: float             # fraction of SUBMITTED requests in-SLO
    goodput_rps: float         # in-SLO requests per sim-second (makespan)
    sim_makespan_s: float
    wall_s: float
    events: int
    events_per_s: float
    profile: Optional[Dict] = None

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


def page_leaks(cluster: Cluster) -> int:
    """Pages still held across the fleet after a drained run (must be 0
    — every terminal path frees its KV)."""
    return sum(i.alloc.n_pages - i.alloc.free_pages
               for i in cluster.instances)


def run_fleet(trace: Union[Trace, List[Request]], spec: FleetSpec, *,
              profile: bool = False,
              network: Optional[NetworkStack] = None,
              faults=None, tracer=None, metrics=None) -> FleetReport:
    """Replay ``trace`` through a ``spec`` cluster and report.

    ``tracer``/``metrics`` (repro_torch.obs) attach the observability
    plane to the underlying cluster — off by default, so the events/sec
    throughput floor is measured with zero instrumentation cost."""
    reqs = trace.to_requests() if isinstance(trace, Trace) else trace
    cluster = spec.build_cluster(network=network, faults=faults,
                                 tracer=tracer, metrics=metrics)
    profiler = EventLoopProfiler() if profile else None
    cluster.profiler = profiler
    t0 = perf_counter()
    result = cluster.serve(reqs)
    wall = perf_counter() - t0

    leaks = page_leaks(cluster)
    if leaks:
        raise RuntimeError(f"fleet run leaked {leaks} KV pages")

    finished = sum(1 for r in reqs if r.phase is Phase.FINISHED)
    failed = sum(1 for r in reqs if r.phase is Phase.FAILED)
    good = good_count(reqs, spec.slo)
    makespan = result.metrics.get("makespan", 0.0)
    return FleetReport(
        metrics=result.metrics,
        requests=len(reqs), finished=finished, failed=failed,
        goodput=good / len(reqs) if reqs else 0.0,
        goodput_rps=(good / makespan) if makespan else 0.0,
        sim_makespan_s=makespan,
        wall_s=round(wall, 3),
        events=cluster.events_processed,
        events_per_s=round(cluster.events_processed / wall, 1)
        if wall else 0.0,
        profile=profiler.report(wall_s=wall) if profiler else None)
