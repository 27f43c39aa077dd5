"""Kernel 1 (paged prefill attention): the bound time of the attention
that the prompt tokens prefilled in the window need (causal FLOPs; Q
and O once; each request's live K/V once a chunk of its prompt) over
the device time of kernel 1's launches in the window (its tensor-core
body, its f32 body and its split combine)."""
from portbench import readers, work

KERNELS = r"prefill_tc_kernel|prefill_tc::combine_kernel|\bprefill_kernel\b"


def read(run):
    flops, byts = work.k1_work(run.widths, readers.prefilled(run),
                               run.chunk)
    return readers.roofline(run, flops, byts, KERNELS)
