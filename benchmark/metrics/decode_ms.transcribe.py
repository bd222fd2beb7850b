"""decode_ms.transcribe: host ms a traced greedy generate call spends in its
decode loop (the span generate.decode), the mean over the traced calls
(host clock)."""
from benchmark import spans


def read(run):
    return spans.per_call_ms(run, "generate.decode")
