"""kernel_roofline.transcribe: over the traced calls, the summed bounds of the
operations the port's kernel families carried out (benchmark/kernels/) over
those kernels' summed device time, in percent."""
from benchmark import readers


def read(run):
    return readers.kernel_roofline(run)
