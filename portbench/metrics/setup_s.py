"""Seconds from the process's start to the window's opening: CUDA
start-up, weights, the cluster's pools and the warm-up (a checkout's
first run also builds the kernels)."""


def read(run):
    return run.setup_s
