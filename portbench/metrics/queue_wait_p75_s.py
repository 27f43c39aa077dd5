"""Serving runtime: 75th percentile over the window's requests of the
seconds from the instant each was due to its prefill's start
(``Request.t_prefill_start``), counted at most to the window's close
(the trace is read after it)."""
import math

from portbench import readers


def read(run):
    return readers.percentile([min(r.prefill_start, run.t_close) - r.due
                               if math.isfinite(r.prefill_start)
                               else run.t_close - r.due
                               for r in run.requests], 75)
