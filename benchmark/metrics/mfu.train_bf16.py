"""mfu.train_bf16: the model FLOPs of the window's calls (benchmark/flops.py) over
the window's seconds and the peak of the cell's compute dtype (bf16 989, f32
495 TFLOP/s), in percent."""
from benchmark import readers


def read(run):
    return readers.mfu(run)
