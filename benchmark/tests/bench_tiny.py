"""Tiny configurations and mixes of the benchmark's tests: the port's
tiny-speech and tiny-bart-bytes presets with SpecAugment, LayerDrop and the
fused extractor on, post-LN or pre-LN."""

import dataclasses
import json

MIXES = {
    "generate": {"entry": "generate", "batch": 4, "padded_seconds": 0.4,
                 "valid_seconds": [0.2, 0.4], "pool": 2, "amplitude": 0.1,
                 "max_length": 8, "min_length": 8, "dtype": "float32"},
    "train_step": {"entry": "train_step", "batch": 4, "padded_seconds": 0.4,
                   "valid_seconds": [0.2, 0.4], "pool": 4, "amplitude": 0.1,
                   "label_positions": 12, "label_lengths": [6, 12],
                   "recipe": {"learning_rate": 1e-3, "warmup_steps": 2,
                              "max_grad_norm": 10.0, "bf16": False}},
}


def config(preln=False):
    """(the port's SpeechMixConfig, the configuration file's dict)."""
    from speechmix_tpu_torch import config as c
    e = dataclasses.replace(
        c.SPEECH_ENCODER_PRESETS["tiny-speech"], apply_spec_augment=True,
        layerdrop=0.3, extractor_impl="fused", mask_time_prob=0.2,
        mask_time_length=3)
    if preln:
        e = dataclasses.replace(e, do_stable_layer_norm=True,
                                feat_extract_norm="layer", conv_bias=True)
    cfg = c.SpeechMixConfig(encoder=e,
                            decoder=c.SEQ2SEQ_PRESETS["tiny-bart-bytes"],
                            down_scale=2)
    return cfg, {"speechmix": json.loads(cfg.to_json())}
