"""dispatch_ms.train: host milliseconds from entering a train step to its
return, before the harness synchronises; the mean over the window's calls
(host clock)."""
from benchmark import readers


def read(run):
    return readers.dispatch_ms(run)
