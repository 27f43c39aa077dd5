"""Model step: the FLOPs of the prompt tokens prefilled in the window
(matmul weights x 2 a token, causal QK^T + PV, the head on each prompt
finished in it) over the prefill instance's busy seconds in the window
at 989 TFLOP/s, in %."""
from portbench import readers, work


def read(run):
    if run.prefill_busy_s <= 0:
        return None
    flops = work.prefill_flops(run.widths, readers.prefilled(run),
                               readers.first_tokens(run))
    return 100.0 * flops / (run.prefill_busy_s * work.PEAK_FLOPS)
