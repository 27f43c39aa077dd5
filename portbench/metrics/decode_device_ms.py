"""Engines: the union of the ops on the decode instance's stream (the
stream kernel 2 ran on) in the traced window over the decode iterations
in it, in ms an iteration: the card's time of a decode step, beside
``decode_step_ms``, its wall time."""
from portbench import spans


def read(run):
    return spans.device_ms(run.trace, "decode", run.decode_iterations)
