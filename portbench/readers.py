"""Arithmetic the metric readers share (``metrics/<name>.py`` each hold
one ``read(run)``).  A reader that finds nothing to read returns None
and the metric is left out of the result line."""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from portbench import work

INF = float("inf")


def percentile(values: List[float], q: float) -> Optional[float]:
    """The ``q``-th percentile (linear between order statistics); a
    missing value (a failed request) counts as beyond every other."""
    if not values:
        return None
    v = float(np.percentile(np.asarray(values, np.float64), q))
    return v if math.isfinite(v) else None


def decode_contexts(run) -> List[int]:
    """Context lengths of the decode steps that streamed a token inside
    the window."""
    out: List[int] = []
    for r in run.requests:
        out.extend(work.decode_contexts(r.prompt_len, r.n_window))
    return out


def prefilled(run) -> List[int]:
    """Prompt tokens each request had prefilled when the window closed."""
    return [r.prefilled_window for r in run.requests if r.prefilled_window]


def first_tokens(run) -> int:
    """Requests whose prefill ended (and ran the head) in the window."""
    return sum(1 for r in run.requests if r.n_window > 0)


def roofline(run, flops: float, byts: float, pattern: str
             ) -> Optional[float]:
    """The bound time of the work over the device time of the ops that
    match ``pattern``, in %."""
    if run.trace is None or flops <= 0:
        return None
    t = run.trace.kernel_seconds(pattern)
    if t <= 0:
        return None
    return 100.0 * work.bound_s(flops, byts) / t
