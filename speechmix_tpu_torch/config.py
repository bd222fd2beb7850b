"""Configuration dataclasses of the PyTorch port.

A copy of ``speechmix_tpu.config``: the same classes, field names, defaults
and presets, so a configuration means the same model in both packages.  The
port keeps its own copy and imports nothing from the JAX package.  A local
HF checkpoint directory (one with a config.json) given in place of a preset
name derives its architecture through ``convert.config_from_hf``.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class SpeechEncoderConfig:
    """wav2vec2-family speech encoder (also covers HuBERT / UniSpeechSAT).

    The three reference encoder families (hf_model.py:210-215 picks
    Wav2Vec2Model / HubertModel / UniSpeechSatModel by name substring) share one
    computational graph; they differ only in checkpoint weights and a couple of
    normalization switches captured here.
    """

    name: str = "wav2vec2-base"
    # conv feature extractor (raw waveform -> ~50 Hz frames)
    conv_dims: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernels: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_strides: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    # "group": GroupNorm after first conv only (wav2vec2-base, hubert-base)
    # "layer": LayerNorm after every conv (wav2vec2-large / robust)
    feat_extract_norm: str = "group"
    # transformer encoder
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    activation: str = "gelu"
    layer_norm_eps: float = 1e-5
    # True for -large models: pre-LN transformer ("stable layer norm")
    do_stable_layer_norm: bool = False
    # positional conv embedding
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    # training-time dropout at the HF placements (wav2vec2-base checkpoint
    # defaults; applied only when a dropout_rng is threaded into the forward)
    dropout: float = 0.1             # hidden_dropout: post-attn/post-FFN/embed
    attention_dropout: float = 0.1   # on attention probabilities
    activation_dropout: float = 0.1  # inside the FFN, after the activation
    feat_proj_dropout: float = 0.1   # after the feature projection
    # SpecAugment (training only, applied after the feature projection like
    # HF Wav2Vec2Model._mask_hidden_states): HF wav2vec2 / hubert configs
    # default apply_spec_augment=True, so the reference TRAINS with it on
    # every pretrained checkpoint.  Time-mask spans replace frames with
    # masked_spec_embed; feature-mask spans zero channels across ALL frames.
    # Span starts are sampled WITHOUT replacement with one shared rounding
    # epsilon per call — HF _compute_mask_indices semantics, distribution-
    # pinned in tests/test_hf_parity.py.  Tiny test presets turn it off.
    apply_spec_augment: bool = True
    mask_time_prob: float = 0.05
    mask_time_length: int = 10
    mask_time_min_masks: int = 2
    mask_feature_prob: float = 0.0   # checkpoints like wav2vec2-large-robust
    mask_feature_length: int = 10    # train with this > 0
    mask_feature_min_masks: int = 0
    # LayerDrop (training only): HF Wav2Vec2Config defaults layerdrop=0.1 —
    # the reference trains with stochastic layer skipping.  Implemented as
    # a select (the skipped layer is still computed under jit — no FLOP
    # saving on TPU static graphs, but the REGULARIZATION semantics match).
    layerdrop: float = 0.1
    # rematerialize transformer layers in the backward pass (jax.checkpoint):
    # trades ~30% extra FLOPs for O(layers) less activation HBM
    remat: bool = False
    # conv extractor lowering: "auto" resolves to "conv" (XLA lax.conv — the
    # measured optimum on TPU; patch-matmul was 3.6x slower and reverted,
    # see PERF.md and speech_encoder.extract_features)
    extractor_impl: str = "auto"  # "auto"|"conv"|"patches"|"pairs"|"taps"|"fused"

    @property
    def feature_dim(self) -> int:
        return self.conv_dims[-1]

    def feature_lengths(self, sample_lengths):
        """Waveform sample count -> conv feature frame count (per conv layer:
        L = floor((L - kernel) / stride) + 1), matching HF's
        _get_feat_extract_output_lengths."""
        l = sample_lengths
        for k, s in zip(self.conv_kernels, self.conv_strides):
            l = (l - k) // s + 1
        return l

    def aligned_samples(self, n: int, multiple: int = 8) -> int:
        """Smallest padded sample count >= n whose FRAME count is a multiple
        of `multiple`.  Odd/misaligned frame counts force sublane padding in
        every transformer-layer op: measured ~6% encoder time at B=128
        (frames 799 vs 800 — PERF.md).  The pad is masked, so outputs for
        the real samples are unchanged."""
        stride = 1
        for s in self.conv_strides:
            stride *= s
        frames = int(self.feature_lengths(n))
        target = -(-max(frames, 1) // multiple) * multiple
        n = n + (target - frames) * stride
        assert int(self.feature_lengths(n)) == target
        return n


@dataclass(frozen=True)
class Seq2SeqConfig:
    """BART/T5-family seq2seq LM config.

    `arch` selects the graph: "bart" (learned positions, post-LN,
    layernorm-embedding) or "t5" (relative position bias, RMSNorm, no biases).
    """

    name: str = "bart-base"
    arch: str = "bart"  # "bart" | "t5"
    vocab_size: int = 50265
    hidden_size: int = 768
    encoder_layers: int = 6
    decoder_layers: int = 6
    num_heads: int = 12
    head_dim: Optional[int] = None  # t5 d_kv; default hidden/heads
    ffn_dim: int = 3072
    activation: str = "gelu"  # bart: gelu; t5 v1.0: relu; t5 v1.1: gated-gelu
    max_positions: int = 1024  # bart learned position table size (pre-offset)
    layer_norm_eps: float = 1e-5
    # training-time dropout (facebook/bart-base checkpoint sets all three to
    # 0.1; T5 uses one dropout_rate for every site).  Applied only when a
    # dropout_rng is threaded into the forward.
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.1
    scale_embedding: bool = False
    tie_word_embeddings: bool = True
    # token ids
    pad_token_id: int = 1
    bos_token_id: int = 0
    eos_token_id: int = 2
    decoder_start_token_id: int = 2
    # t5 relative attention
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    # generation default (reference uses decoder_model.config.max_length,
    # train.py:23)
    max_length: int = 128
    # rematerialize enc/dec layers in the backward pass (jax.checkpoint)
    remat: bool = False

    @property
    def kv_dim(self) -> int:
        return (self.head_dim or self.hidden_size // self.num_heads) * self.num_heads

    @property
    def per_head_dim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads


@dataclass(frozen=True)
class SpeechMixConfig:
    """Composite config for the fused speech->text model.

    Mirrors the reference constructor surface
    (model.py:57-62 / hf_model.py:188-204):
      share_layer_ratio  - truncate the TOP int(L*ratio) speech encoder layers
      down_scale         - power-of-two temporal down-scaling via stride-2 convs
      weighted_sum       - learned softmax combination of encoder layer states
      weighted_sum_convention - "hf" uses num_layers+1 weights (embedding output
        included, hf_model.py:269-270); "s3prl" uses num_layers (model.py:100)
      fixed_parameters / fixed_except - substring-based freezing policy
        (model.py:104-113)
      variant            - eed | ed | fixed | adapter | self | gan
    """

    encoder: SpeechEncoderConfig = field(default_factory=SpeechEncoderConfig)
    decoder: Seq2SeqConfig = field(default_factory=Seq2SeqConfig)
    variant: str = "eed"
    share_layer_ratio: float = 0.0
    down_scale: int = 8
    weighted_sum: bool = False
    weighted_sum_convention: str = "hf"  # "hf" (L+1) | "s3prl" (L)
    fixed_parameters: bool = False
    fixed_except: Tuple[str, ...] = (
        "layer_norm",
        "encoder_attn",
        "enc_to_dec_proj",
        "length_adapter",
        "layernorm_embedding",
        "attention",
        "encoder",
    )
    # adapter variant
    adapter_bottleneck_ratio: float = 0.5
    # self-distillation variant loss weights (reference uses 1/1/1,
    # model.py:261)
    self_ce_weight: float = 1.0
    self_kld_weight: float = 1.0
    self_mse_weight: float = 1.0
    # gan variant
    gan_discriminator_update_every: int = 1000  # model.py:280 des_update
    # numerics
    dtype: str = "float32"  # compute dtype: "float32" | "bfloat16"

    def __post_init__(self):
        if self.down_scale >= 1 and (self.down_scale & (self.down_scale - 1)) != 0:
            raise ValueError(f"down_scale must be a power of two, got {self.down_scale}")
        if self.variant not in ("eed", "ed", "fixed", "adapter", "self", "gan"):
            raise ValueError(f"unknown variant: {self.variant}")
        if self.weighted_sum_convention not in ("hf", "s3prl"):
            raise ValueError(
                f"unknown weighted_sum_convention: {self.weighted_sum_convention}")

    @property
    def num_speech_encoder_layers(self) -> int:
        """Speech encoder depth after share_layer_ratio truncation
        (model.py:77-81: remove int(L*ratio) from the top)."""
        n = self.encoder.num_layers
        if self.share_layer_ratio != 0:
            n -= int(n * self.share_layer_ratio)
        return n

    @property
    def num_weighted_sum(self) -> int:
        n = self.num_speech_encoder_layers
        return n + 1 if self.weighted_sum_convention == "hf" else n

    @property
    def downloop(self) -> int:
        return int(math.log2(self.down_scale)) if self.down_scale > 1 else 0

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "SpeechMixConfig":
        d = json.loads(text)
        d["encoder"] = SpeechEncoderConfig(**{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in d["encoder"].items()
        })
        d["decoder"] = Seq2SeqConfig(**d["decoder"])
        for k in ("fixed_except",):
            if k in d and isinstance(d[k], list):
                d[k] = tuple(d[k])
        return cls(**d)


# ---------------------------------------------------------------------------
# Presets — the model families the reference supports by name
# (hf_model.py:210-215; README.md recipe uses wav2vec2 + facebook/bart-base).
# ---------------------------------------------------------------------------

def _w2v2_base(name):
    return SpeechEncoderConfig(name=name)


def _w2v2_large(name):
    return SpeechEncoderConfig(
        name=name,
        hidden_size=1024, num_layers=24, num_heads=16, ffn_dim=4096,
        feat_extract_norm="layer", conv_bias=True, do_stable_layer_norm=True,
    )


SPEECH_ENCODER_PRESETS = {
    "wav2vec2": _w2v2_base("wav2vec2"),
    "wav2vec2-base": _w2v2_base("wav2vec2-base"),
    "facebook/wav2vec2-base-960h": _w2v2_base("facebook/wav2vec2-base-960h"),
    "wav2vec2-large": _w2v2_large("wav2vec2-large"),
    "facebook/wav2vec2-large-960h-lv60": _w2v2_large(
        "facebook/wav2vec2-large-960h-lv60"),
    "hubert": _w2v2_base("hubert"),
    "hubert-base": _w2v2_base("hubert-base"),
    "facebook/hubert-base-ls960": _w2v2_base("facebook/hubert-base-ls960"),
    "hubert-large": dataclasses.replace(_w2v2_large("hubert-large"),
                                        feat_extract_norm="layer"),
    "unispeech-sat": _w2v2_base("unispeech-sat"),
    "microsoft/unispeech-sat-base": _w2v2_base("microsoft/unispeech-sat-base"),
    # tiny config for tests (fast init, same graph)
    "tiny-speech": SpeechEncoderConfig(
        name="tiny-speech",
        conv_dims=(32, 32, 32), conv_kernels=(10, 3, 3), conv_strides=(5, 2, 2),
        hidden_size=64, num_layers=4, num_heads=4, ffn_dim=128,
        pos_conv_kernel=16, pos_conv_groups=4,
        # our own test preset (no HF counterpart): keep training forward
        # deterministic apart from dropout
        apply_spec_augment=False, layerdrop=0.0,
    ),
}

BART_BASE = Seq2SeqConfig(name="bart-base")
BART_LARGE = Seq2SeqConfig(
    name="bart-large", hidden_size=1024, encoder_layers=12, decoder_layers=12,
    num_heads=16, ffn_dim=4096)
T5_SMALL = Seq2SeqConfig(
    name="t5-small", arch="t5", vocab_size=32128, hidden_size=512,
    encoder_layers=6, decoder_layers=6, num_heads=8, head_dim=64, ffn_dim=2048,
    activation="relu", layer_norm_eps=1e-6, pad_token_id=0, eos_token_id=1,
    bos_token_id=0, decoder_start_token_id=0, scale_embedding=False)
BYT5_SMALL = Seq2SeqConfig(
    name="byt5-small", arch="t5", vocab_size=384, hidden_size=1472,
    encoder_layers=12, decoder_layers=4, num_heads=6, head_dim=64,
    ffn_dim=3584, activation="gelu_gated", layer_norm_eps=1e-6,
    pad_token_id=0, eos_token_id=1, bos_token_id=0, decoder_start_token_id=0,
    tie_word_embeddings=False)

SEQ2SEQ_PRESETS = {
    "bart-base": BART_BASE,
    "facebook/bart-base": dataclasses.replace(BART_BASE, name="facebook/bart-base"),
    "bart-large": BART_LARGE,
    "facebook/bart-large": dataclasses.replace(BART_LARGE, name="facebook/bart-large"),
    "t5-small": T5_SMALL,
    "byt5-small": BYT5_SMALL,
    # byte-vocab BART for offline tests: works with speechmix_tpu's built-in
    # byte tokenizer, no hub access needed
    "tiny-bart-bytes": Seq2SeqConfig(
        name="tiny-bart-bytes", vocab_size=384, hidden_size=64,
        encoder_layers=2, decoder_layers=2, num_heads=4, ffn_dim=128,
        max_positions=512, max_length=32),
    "tiny-t5-bytes": Seq2SeqConfig(
        name="tiny-t5-bytes", arch="t5", vocab_size=384, hidden_size=64,
        encoder_layers=2, decoder_layers=2, num_heads=4, head_dim=16,
        ffn_dim=128, activation="relu", layer_norm_eps=1e-6, pad_token_id=0,
        eos_token_id=1, bos_token_id=0, decoder_start_token_id=0,
        max_length=32),
}


def _maybe_config_from_dir(name):
    """The configuration of a local HF checkpoint directory (one holding a
    config.json) through convert.config_from_hf, else None."""
    import os
    p = str(name)
    if os.path.isdir(p) and os.path.exists(os.path.join(p, "config.json")):
        from . import convert
        return convert.config_from_hf(p)
    return None


def speech_encoder_config(name_or_cfg) -> SpeechEncoderConfig:
    if isinstance(name_or_cfg, SpeechEncoderConfig):
        return name_or_cfg
    if name_or_cfg in SPEECH_ENCODER_PRESETS:
        return SPEECH_ENCODER_PRESETS[name_or_cfg]
    derived = _maybe_config_from_dir(name_or_cfg)
    if derived is not None:
        if not isinstance(derived, SpeechEncoderConfig):
            raise ValueError(
                f"{name_or_cfg} holds a non-speech-encoder config "
                f"({type(derived).__name__})")
        return derived
    lowered = str(name_or_cfg).lower()
    # name-substring dispatch, mirroring hf_model.py:210-215
    if "large" in lowered or "lv60" in lowered:
        return _w2v2_large(str(name_or_cfg))
    return _w2v2_base(str(name_or_cfg))


def seq2seq_config(name_or_cfg) -> Seq2SeqConfig:
    if isinstance(name_or_cfg, Seq2SeqConfig):
        return name_or_cfg
    if name_or_cfg in SEQ2SEQ_PRESETS:
        return SEQ2SEQ_PRESETS[name_or_cfg]
    derived = _maybe_config_from_dir(name_or_cfg)
    if derived is not None:
        if not isinstance(derived, Seq2SeqConfig):
            raise ValueError(
                f"{name_or_cfg} holds a non-seq2seq config "
                f"({type(derived).__name__})")
        return derived
    lowered = str(name_or_cfg).lower()
    if "byt5" in lowered:
        return dataclasses.replace(BYT5_SMALL, name=str(name_or_cfg))
    if "t5" in lowered:
        return dataclasses.replace(T5_SMALL, name=str(name_or_cfg))
    if "bart-large" in lowered or "large" in lowered:
        return dataclasses.replace(BART_LARGE, name=str(name_or_cfg))
    return dataclasses.replace(BART_BASE, name=str(name_or_cfg))
