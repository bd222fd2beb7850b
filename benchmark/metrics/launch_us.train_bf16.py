"""launch_us.train_bf16: the mean host us of one port kernel launch in the
traced calls: the self time of every launch.<symbol> span
(CudaKernel.launch) over their count (host clock)."""
from benchmark import spans


def read(run):
    return spans.launch_us(run)
