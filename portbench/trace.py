"""The device trace of a ``--trace 1`` run: ``torch.profiler`` with
CUDA activity only, from the window's start to the end of its
interval.  What the card ran is read once from the profiler's events:
each kernel, copy and set as (stream, start, end, name).
"""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple


class Trace:
    """Device activity of one traced interval of ``window_s`` host
    seconds."""

    def __init__(self, events: List[Tuple[int, int, int, str]],
                 window_s: float):
        self.events = events          # (stream, start ns, end ns, name)
        self.window_s = window_s
        self._merged = _union([(a, b) for _, a, b, _ in events])

    @property
    def busy_s(self) -> float:
        """Seconds in which something ran on the card, on any stream."""
        return sum(b - a for a, b in self._merged) * 1e-9

    def idle_share(self) -> Optional[float]:
        if not self.events or self.window_s <= 0:
            return None
        return max(0.0, 1.0 - self.busy_s / self.window_s)

    def kernel_seconds(self, pattern: str) -> float:
        """Summed device time of the ops whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(b - a for _, a, b, n in self.events
                   if rx.search(n)) * 1e-9

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The ops that took most device time, and the idle gaps summed
        by the op that ran last before each."""
        ops: Dict[str, float] = defaultdict(float)
        for _, a, b, n in self.events:
            ops[short(n)] += (b - a) * 1e-9
        ends = sorted((b, short(n)) for _, _, b, n in self.events)
        gaps: Dict[str, float] = defaultdict(float)
        j = 0
        for (_, prev_end), (start, _) in zip(self._merged, self._merged[1:]):
            while j + 1 < len(ends) and ends[j + 1][0] <= prev_end:
                j += 1
            gaps["after " + ends[j][1]] += (start - prev_end) * 1e-9
        first = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in first],
                "idle_gaps": [[k, v] for k, v in idle]}


def short(name: str) -> str:
    """An op's name without its argument list and template arguments."""
    name = name.split("(")[0] if "(" in name else name
    name = re.sub(r"<.*>", "<>", name)
    name = name.replace("void ", "").strip()
    return name[:96]


def _union(ivs):
    merged: List[Tuple[int, int]] = []
    for a, b in sorted(ivs):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def start(device):
    """A running profiler session that records the card's activity (the
    host's operators when ``device`` is the CPU, for the CPU tests)."""
    from torch.profiler import ProfilerActivity, profile
    act = (ProfilerActivity.CUDA if device.type == "cuda"
           else ProfilerActivity.CPU)
    prof = profile(activities=[act])
    prof.start()
    return prof


def stop(prof, window_s: float, device) -> Trace:
    """End the session and read what the device ran (on the card, the
    host-side API calls are left out)."""
    from torch.autograd import DeviceType
    kind = DeviceType.CUDA if device.type == "cuda" else DeviceType.CPU
    prof.stop()
    events = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == kind and e.duration_ns() > 0:
            a = e.start_ns()
            events.append((e.device_resource_id(), a, a + e.duration_ns(),
                           e.name()))
    return Trace(events, window_s)
