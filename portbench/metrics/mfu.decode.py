"""Model step: the whole decode step's share of the roofline: the
larger of the window's decode FLOPs at 989 TFLOP/s and its bytes
(weights once an iteration, each token's live K/V read and its new K/V
written) at 3.35 TB/s, over the decode instance's busy seconds in the
window, in %."""
from portbench import readers, work


def read(run):
    ctx = readers.decode_contexts(run)
    if not ctx or run.decode_busy_s <= 0:
        return None
    w = run.widths
    bound = work.bound_s(work.decode_flops(w, ctx),
                         work.decode_bytes(w, run.decode_iterations, ctx))
    return 100.0 * bound / run.decode_busy_s
