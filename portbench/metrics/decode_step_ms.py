"""Engines: the decode instance's busy seconds over its decode
iterations in the window, in ms an iteration."""


def read(run):
    if not run.decode_iterations:
        return None
    return 1e3 * run.decode_busy_s / run.decode_iterations
