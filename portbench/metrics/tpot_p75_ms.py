"""75th percentile over the window's requests of two or more output
tokens of (finish - first token) / (tokens - 1), in ms; a failed
request counts as missing."""
from portbench import readers


def read(run):
    return readers.percentile([
        1e3 * (r.finish - r.first) / (r.n_tokens - 1) if r.finished
        else readers.INF for r in run.requests if r.n_out >= 2], 75)
