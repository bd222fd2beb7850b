"""peak_mem_gib.train_bf16: torch.cuda.max_memory_allocated() over the window, reset
after set-up, in GiB."""
from benchmark import readers


def read(run):
    return readers.peak_mem_gib(run)
