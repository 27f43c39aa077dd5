"""Serving runtime: 75th percentile of how late the benchmark's client
submitted each request (submit - due), in ms.  ``submit`` waits for the
prefill instance's lock, which a running chunk holds."""
from portbench import readers


def read(run):
    return readers.percentile([1e3 * (r.submit - r.due)
                               for r in run.requests], 75)
