"""encode_ms.transcribe: host ms a traced greedy generate call spends in its
speech encoder and its text encoder (the spans generate.encode_speech and
generate.text_encode), the mean over the traced calls (host clock)."""
from benchmark import spans


def read(run):
    return spans.per_call_ms(run, "generate.encode_speech",
                             "generate.text_encode")
