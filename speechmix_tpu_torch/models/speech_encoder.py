"""wav2vec2-family speech encoder (port of
``speechmix_tpu.models.speech_encoder``), deterministic.

Conv feature extractor (optionally with kernel K6 for its stride-2 layers)
-> feature projection -> masked positional conv -> post-LN transformer
layers.  Layers are a list of parameter dicts (the JAX package stacks them
on a leading axis for ``lax.scan``).  Every step is differentiable, through
PyTorch autograd or the kernels' own backward functions, so the same code
serves and trains.  The stochastic parts of training (SpecAugment,
LayerDrop, dropout) and the pre-LN ("stable layer norm") form are not
ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import SpeechEncoderConfig
from ..ops import layers
from ..ops.attention import attention
from ..ops.kernels.conv_extractor import fused_conv_stack
from ..ops.masking import length_mask
from .init import conv_params, dense_params, layer_norm_params


def truncate_layers(params, num_keep: int):
    """share_layer_ratio: keep only the bottom num_keep transformer layers."""
    out = dict(params)
    out["layers"] = list(params["layers"][:num_keep])
    return out


def _check_supported(cfg: SpeechEncoderConfig):
    if cfg.do_stable_layer_norm:
        raise NotImplementedError(
            "pre-LN (do_stable_layer_norm) speech encoders are not ported yet")


_XLA_ONLY_IMPLS = ("patches", "pairs", "taps")


def _fused_extractor_ok(cfg: SpeechEncoderConfig) -> bool:
    """Geometry gate of the fused extractor kernel (K6): layers 1.. must be
    stride-2, k in {2, 3}, at one channel width (every wav2vec2 preset)."""
    return (len(cfg.conv_dims) >= 2
            and all(s == 2 for s in cfg.conv_strides[1:])
            and all(k in (2, 3) for k in cfg.conv_kernels[1:])
            and len(set(cfg.conv_dims)) == 1)


def extract_features(params, cfg: SpeechEncoderConfig, waveform,
                     lengths=None, dtype=torch.float32):
    """(B, T_samples) -> (B, T_frames, feature_dim).  `lengths` (valid
    sample counts) gates the group-norm statistics; VALID convolutions never
    let padding reach valid frames otherwise.

    cfg.extractor_impl: "conv" (and "auto") runs every layer as a library
    convolution; "fused" runs layer 0 (and its group norm) that way and
    layers 1.. through kernel K6 (conv + bias [+ LayerNorm] + GELU in one
    pass), where the geometry allows it (_fused_extractor_ok), else "conv".
    The JAX package's XLA reformulations ("patches", "pairs", "taps") have no
    counterpart here."""
    impl = cfg.extractor_impl
    if impl in _XLA_ONLY_IMPLS:
        raise NotImplementedError(f"extractor_impl={impl!r} is an XLA "
                                  "reformulation and is not ported")
    if impl not in ("auto", "conv", "fused"):
        raise ValueError(f"unknown extractor_impl {impl!r}")
    fused = impl == "fused" and _fused_extractor_ok(cfg)
    conv_layers = params["feature_extractor"]["layers"]
    x = waveform.to(dtype)[..., None]
    l = lengths
    for i, layer in enumerate(conv_layers[:1] if fused else conv_layers):
        x = layers.conv1d(layer["conv"], x, cfg.conv_strides[i], dtype)
        group = cfg.feat_extract_norm == "group" and i == 0
        mask = None
        if l is not None:
            l = (l - cfg.conv_kernels[i]) // cfg.conv_strides[i] + 1
            if "norm" in layer and group:
                mask = length_mask(l, x.shape[1])
        if "norm" in layer:
            if group:
                x = layers.group_norm_per_channel(layer["norm"], x,
                                                  cfg.layer_norm_eps,
                                                  mask=mask)
            else:
                x = layers.layer_norm(layer["norm"], x, cfg.layer_norm_eps)
        x = F.gelu(x)
    if fused:
        # the library conv leaves (B, T, C) as a view of (B, C, T)
        x = fused_conv_stack(x.contiguous(), conv_layers[1:],
                             cfg.feat_extract_norm == "layer",
                             cfg.layer_norm_eps)
    return x


def _encoder_layer(layer_params, x, kv_mask, cfg, dtype):
    """Post-LN layer: attention, then out-projection + residual + LN (K2),
    then FFN + residual + LN (K3)."""
    attn, _ = attention(layer_params["attention"], x, kv_mask=kv_mask,
                        num_heads=cfg.num_heads, dtype=dtype, out_proj=False)
    x = layers.dense_residual_ln_apply(
        layer_params["attention"]["out_proj"],
        layer_params["attention_layer_norm"], attn, x, dtype,
        cfg.layer_norm_eps)
    return layers.ffn_residual_ln_apply(
        layer_params["ffn_in"], layer_params["ffn_out"],
        layer_params["final_layer_norm"], x, cfg.activation, dtype,
        cfg.layer_norm_eps)


def speech_encoder_apply(params, cfg: SpeechEncoderConfig, waveform,
                         lengths=None, output_hidden_states=False,
                         dtype=torch.float32):
    """waveform: (B, T_samples) zero-padded; lengths: (B,) sample counts or
    None for full length.  Returns dict(last_hidden_state (B, T, H),
    frame_lengths (B,), frame_mask (B, T)[, hidden_states (L+1, B, T, H)
    with the embedding output first])."""
    _check_supported(cfg)
    b, t_samples = waveform.shape
    if lengths is None:
        lengths = torch.full((b,), t_samples, dtype=torch.long,
                             device=waveform.device)
    feats = extract_features(params, cfg, waveform, lengths, dtype)
    frame_lengths = cfg.feature_lengths(lengths)
    frame_mask = length_mask(frame_lengths, feats.shape[1])

    fp = params["feature_projection"]
    h = layers.layer_norm(fp["layer_norm"], feats, cfg.layer_norm_eps)
    h = layers.dense(fp["projection"], h, dtype)
    # zero padded frames before the pos-conv so padding can't leak in
    h = h * frame_mask[..., None].to(h.dtype)
    pos = layers.conv1d_same_grouped(params["pos_conv"], h,
                                     cfg.pos_conv_groups, dtype)
    h = h + F.gelu(pos)
    h = layers.layer_norm(params["encoder_layer_norm"], h, cfg.layer_norm_eps)

    hidden = [h] if output_hidden_states else None
    for layer_params in params["layers"]:
        h = _encoder_layer(layer_params, h, frame_mask, cfg, dtype)
        if hidden is not None:
            hidden.append(h)
    out = {"last_hidden_state": h, "frame_lengths": frame_lengths,
           "frame_mask": frame_mask}
    if hidden is not None:
        out["hidden_states"] = torch.stack(hidden)
    return out


def init_speech_encoder(cfg: SpeechEncoderConfig, generator, device,
                        dtype=torch.float32):
    """Random parameters with the JAX package's structure (normal(0, 0.02)
    dense kernels, scaled-normal convs, unit LayerNorms, zero biases),
    drawn from `generator`; matrices in `dtype`, vectors in float32."""
    _check_supported(cfg)

    conv_layers = []
    in_ch = 1
    for i, (dim, kern) in enumerate(zip(cfg.conv_dims, cfg.conv_kernels)):
        layer = {"conv": conv_params(generator, device, dtype, in_ch, dim,
                                     kern, cfg.conv_bias)}
        if (cfg.feat_extract_norm == "group" and i == 0) or \
                cfg.feat_extract_norm == "layer":
            layer["norm"] = layer_norm_params(dim, device)
        conv_layers.append(layer)
        in_ch = dim
    h = cfg.hidden_size

    def attn():
        return {name: dense_params(generator, device, dtype, h, h)
                for name in ("q_proj", "k_proj", "v_proj", "out_proj")}

    return {
        "feature_extractor": {"layers": conv_layers},
        "feature_projection": {
            "layer_norm": layer_norm_params(cfg.feature_dim, device),
            "projection": dense_params(generator, device, dtype,
                                       cfg.feature_dim, h),
        },
        "pos_conv": conv_params(generator, device, dtype,
                                h // cfg.pos_conv_groups, h,
                                cfg.pos_conv_kernel, True),
        "encoder_layer_norm": layer_norm_params(h, device),
        "layers": [{
            "attention": attn(),
            "attention_layer_norm": layer_norm_params(h, device),
            "ffn_in": dense_params(generator, device, dtype, h, cfg.ffn_dim),
            "ffn_out": dense_params(generator, device, dtype, cfg.ffn_dim, h),
            "final_layer_norm": layer_norm_params(h, device),
        } for _ in range(cfg.num_layers)],
    }
