"""Mean over every request due in the window of the seconds from the
instant it was due to its last token (the paper's average JCT); None
when a request failed."""


def read(run):
    if not run.requests or not all(r.finished for r in run.requests):
        return None
    return sum(r.finish - r.due for r in run.requests) / len(run.requests)
