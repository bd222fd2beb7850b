"""train_audio_s_per_s: valid audio seconds trained over the whole window (host
clock)."""
from benchmark import readers


def read(run):
    return readers.audio_s_per_s(run)
