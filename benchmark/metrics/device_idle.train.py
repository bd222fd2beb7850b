"""device_idle.train: 1 minus the union of kernel, copy and fill intervals over
the traced window, in percent."""
from benchmark import readers


def read(run):
    return readers.device_idle(run)
