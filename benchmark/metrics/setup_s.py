"""setup_s: seconds from the process start to the first timed call: imports,
the kernel build or its cache hit, weights and inputs on the card, warm-up
(host clock)."""
from benchmark import readers


def read(run):
    return readers.setup_s(run)
