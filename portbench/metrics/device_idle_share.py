"""Device: the share of the traced window in which no kernel, copy or
set ran on any stream (the union of their intervals), in %."""


def read(run):
    if run.trace is None:
        return None
    share = run.trace.idle_share()
    return None if share is None else 100.0 * share
