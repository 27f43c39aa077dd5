"""Compatibility shim, as the reference's ``repro.fleet.profile``: the
event-loop profiler lives in the observability plane
(``repro_torch.obs.profile``).  Import from ``repro_torch.obs`` in new
code."""
from repro_torch.obs.profile import EventLoopProfiler

__all__ = ["EventLoopProfiler"]
