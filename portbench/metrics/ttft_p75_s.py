"""75th percentile over every request due in the window of the seconds
from the instant it was due to its first token; a failed request counts
as missing.  The highest percentile with ten or more requests beyond it
in a window of 46."""
from portbench import readers


def read(run):
    return readers.percentile([r.first - r.due if r.finished
                               else readers.INF for r in run.requests], 75)
