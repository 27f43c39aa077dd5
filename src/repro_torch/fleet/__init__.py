"""Fleet-scale trace-driven simulation harness of the port, the
reference's ``repro.fleet`` (docs/fleet_sim.md): it drives
``Cluster(runtime="sim")`` with O(10^5)-O(10^6) requests over hundreds
of instances in minutes, on the host alone.

* ``repro_torch.fleet.traces``  — vectorized trace generation (Poisson /
  bursty / diurnal arrivals, zipf tenants) + replayable trace files.
* ``repro_torch.fleet.harness`` — ``FleetSpec`` cluster presets and
  ``run_fleet`` producing a ``FleetReport`` (TTFT/JCT/goodput + harness
  throughput), with zero-page-leak verification.
* ``repro_torch.fleet.profile`` — per-event-kind event-loop profiler.
"""
from repro_torch.fleet.harness import (FleetReport, FleetSpec, page_leaks,
                                       run_fleet)
from repro_torch.fleet.profile import EventLoopProfiler
from repro_torch.fleet.traces import Trace, generate_trace, load_trace

__all__ = [
    "EventLoopProfiler", "FleetReport", "FleetSpec", "Trace",
    "generate_trace", "load_trace", "page_leaks", "run_fleet",
]
