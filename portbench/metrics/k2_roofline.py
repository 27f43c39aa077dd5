"""Kernel 2 (paged decode attention): the bound time of the attention of
the tokens decoded in the window (each token's live K/V, query and
output once) over the device time of kernel 2's launches in it."""
from portbench import readers, work

KERNELS = r"\bdecode_kernel\b"


def read(run):
    flops, byts = work.k2_work(run.widths, readers.decode_contexts(run))
    return readers.roofline(run, flops, byts, KERNELS)
