"""backward_ms.train: host ms a traced train step spends in the backward of its
micro-batches (the span train_step.backward, around torch.autograd.grad),
the mean over the traced steps (host clock)."""
from benchmark import spans


def read(run):
    return spans.per_call_ms(run, "train_step.backward")
