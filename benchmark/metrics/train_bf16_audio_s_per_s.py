"""train_bf16_audio_s_per_s: valid audio seconds trained over the whole window
(host clock), in the bf16 training cells, whose host-paced steps spread
wider than the f32 step."""
from benchmark import readers


def read(run):
    return readers.audio_s_per_s(run)
