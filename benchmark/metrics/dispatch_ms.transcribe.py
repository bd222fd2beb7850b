"""dispatch_ms.transcribe: host milliseconds from entering a greedy generate
call to its return, before the harness synchronises; the mean over the
window's calls (host clock)."""
from benchmark import readers


def read(run):
    return readers.dispatch_ms(run)
