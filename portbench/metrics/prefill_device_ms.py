"""Engines: the union of the ops on the prefill instance's stream (the
stream kernel 1 ran on) in the traced window over the chunks in it, in
ms a chunk: the card's time of a prefill step, beside
``prefill_chunk_ms``, its wall time."""
from portbench import spans


def read(run):
    return spans.device_ms(run.trace, "prefill", run.prefill_chunks)
