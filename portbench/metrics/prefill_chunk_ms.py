"""Engines: the prefill instance's busy seconds (wall time around each
engine step, which ends in a copy to the host) over the chunks it ran
in the measured interval, in ms a chunk."""


def read(run):
    if not run.prefill_chunks:
        return None
    return 1e3 * run.prefill_busy_s / run.prefill_chunks
