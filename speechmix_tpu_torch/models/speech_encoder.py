"""wav2vec2-family speech encoder (port of
``speechmix_tpu.models.speech_encoder``).

Conv feature extractor (optionally with kernel K6 for its stride-2 layers)
-> feature projection -> [SpecAugment] -> masked positional conv -> post-LN
transformer layers, or pre-LN ones ("stable layer norm", the -large
presets) with the encoder LayerNorm after them [with LayerDrop].  Layers are a list of parameter dicts
(the JAX package stacks them on a leading axis for ``lax.scan``).  Every
step is differentiable, through PyTorch autograd or the kernels' own
backward functions, so the same code serves and trains.

With a ``dropout_rng`` (a DropoutKey) the forward trains as HF's
Wav2Vec2Model does: dropout at the feature projection, after the positional
embedding and at each layer's four sites (attention probabilities, the
attention output, the activation, the FFN output), SpecAugment time (and
feature) masking, and LayerDrop.  SpecAugment's span sampler is a pure
function of its uniform draws, which come from a ``torch.Generator`` seeded
from the site key; LayerDrop draws its decisions on the host from its key
and skips a dropped layer (HF's skip_the_layer; the JAX package selects the
layer's input instead, with the same result and gradient), so a step knows
its kernel launches without reading the device.

Under a mesh (``parallel.mesh``): the dropout masks of a data rank's rows
are its own (the data index folded into their keys); LayerDrop's decisions
and SpecAugment's spans are drawn for the global batch, the same on every
rank (a rank that skipped a layer another runs would leave it waiting in a
collective).  With tensor parallelism each layer's heads and FFN columns
are split over the model group.  With sequence parallelism the extractor,
the projection and the positional conv run on the whole sequence in every
seq rank; the time axis (padded to a multiple of n_seq) is then split, the
layers run on this rank's slice (self-attention round the seq ring, masks
folded with the seq index), and the slices are gathered after the last
layer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import SpeechEncoderConfig
from ..ops import layers
from ..ops.attention import attention
from ..ops.kernels.conv_extractor import fused_conv_stack
from ..ops.kernels.dropout import STREAM_OUT, check_key, split_or_none
from ..ops.masking import length_mask
from ..ops.ring_attention import pad_time
from ..parallel import collectives
from ..parallel import mesh as mesh_lib
from ..utils import profiling
from .init import conv_params, dense_params, layer_norm_params


def truncate_layers(params, num_keep: int):
    """share_layer_ratio: keep only the bottom num_keep transformer layers."""
    out = dict(params)
    out["layers"] = list(params["layers"][:num_keep])
    return out


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


def _host_generator(key):
    """A CPU torch.Generator seeded from a DropoutKey: its draws are the
    same on every machine."""
    return torch.Generator().manual_seed(key.seed & ((1 << 63) - 1))


def mask_span_draws(key, batch, size, device):
    """The uniform draws of one compute_mask_spans call: a shared rounding
    eps () and the (batch, size) start scores, from `key`."""
    gen = _host_generator(key)
    eps = torch.rand((), generator=gen)
    u = torch.rand((batch, size), generator=gen)
    return eps.to(device), u.to(device)


def compute_mask_spans(eps, u, lengths, prob, mask_len, min_masks):
    """SpecAugment span sampler with HF's semantics
    (modeling_wav2vec2._compute_mask_indices), as a pure function of its
    draws, the JAX package's ``compute_mask_spans`` after its two draws:

      * num = floor(prob * L / mask_len + eps) per row of valid length L,
        then max(num, min_masks), capped at size // mask_len and at
        max(L - (mask_len - 1), 0);
      * the span starts are the num largest scores of u among the valid
        starts [0, L - mask_len]: a uniform sample without replacement.

    eps: () uniform; u: (B, size) uniform; lengths: (B,).  Returns (B, size)
    bool, True = masked."""
    b, size = u.shape
    lengths = lengths.long()
    num = torch.floor(prob * lengths.float() / mask_len + eps).long()
    num = torch.clamp(num, min=min_masks)
    num = torch.where(num * mask_len > size, size // mask_len, num)
    room = torch.clamp(lengths - (mask_len - 1), min=0)
    num = torch.minimum(num, room)
    # a bound on the spans of a row, known on the host: a full-length row
    # with eps -> 1, under HF's caps
    s_max = max(int(prob * size / mask_len) + 1, min_masks)
    s_max = min(s_max, size // mask_len, max(size - (mask_len - 1), 0))
    if s_max <= 0:
        return torch.zeros((b, size), dtype=torch.bool, device=u.device)
    pos = torch.arange(size, device=u.device)
    valid = pos[None, :] < room[:, None]
    starts = torch.topk(torch.where(valid, u, -1.0), s_max, dim=-1).indices
    active = torch.arange(s_max, device=u.device)[None, :] < num[:, None]
    t = pos[None, None, :]
    span = ((t >= starts[..., None]) & (t < (starts + mask_len)[..., None])
            & active[..., None])
    return span.any(dim=1)


def compute_time_mask(eps, u, lengths, prob, mask_len, min_masks):
    """SpecAugment time mask (True = replace with masked_spec_embed)."""
    return compute_mask_spans(eps, u, lengths, prob, mask_len, min_masks)


def layerdrop_skips(key, n_layers, rate):
    """LayerDrop's decisions, drawn on the host: layer i is skipped iff its
    uniform draw from `key` is below `rate`."""
    if rate <= 0.0:
        return [False] * n_layers
    u = torch.rand(n_layers, generator=_host_generator(key))
    return [v < rate for v in u.tolist()]


def _encoder_layer(layer_params, x, kv_mask, cfg, dtype, dropout_rng=None,
                   ring_mesh=None):
    """Post-LN layer: attention, then out-projection + residual + LN (K2),
    then FFN + residual + LN (K3); with a dropout_rng their dropout twins
    K14, K11 and K12 at HF Wav2Vec2EncoderLayer's placements.  Pre-LN
    (``do_stable_layer_norm``): LN, attention and its out-projection,
    residual; then LN, FFN (K9, or K13 with dropout), residual, the
    dropout sites of HF's Wav2Vec2EncoderLayerStableLayerNorm.  ring_mesh:
    x is this seq rank's time slice (sequence parallelism)."""
    k_attn, k_h1, k_ffn = split_or_none(dropout_rng, 3)
    ffn_tp = mesh_lib.tp_split(cfg.ffn_dim) > 1
    if cfg.do_stable_layer_norm:
        h = layers.layer_norm(layer_params["attention_layer_norm"], x,
                              cfg.layer_norm_eps)
        attn, _ = attention(layer_params["attention"], h, kv_mask=kv_mask,
                            num_heads=cfg.num_heads, dtype=dtype,
                            dropout_rate=cfg.attention_dropout,
                            dropout_rng=k_attn, ring_mesh=ring_mesh)
        x = x + layers.dropout(attn, cfg.dropout, k_h1, STREAM_OUT)
        h = layers.layer_norm(layer_params["final_layer_norm"], x,
                              cfg.layer_norm_eps)
        h = layers.ffn_apply(layer_params["ffn_in"], layer_params["ffn_out"],
                             h, cfg.activation, dtype, k_ffn,
                             cfg.activation_dropout, tp=ffn_tp)
        return x + layers.dropout(h, cfg.dropout, k_ffn, STREAM_OUT)
    attn, _ = attention(layer_params["attention"], x, kv_mask=kv_mask,
                        num_heads=cfg.num_heads, dtype=dtype, out_proj=False,
                        dropout_rate=cfg.attention_dropout,
                        dropout_rng=k_attn, ring_mesh=ring_mesh)
    x = layers.dense_residual_ln_apply(
        layer_params["attention"]["out_proj"],
        layer_params["attention_layer_norm"], attn, x, dtype,
        cfg.layer_norm_eps, key=k_h1, dropout_rate=cfg.dropout,
        row_parallel=mesh_lib.tp_split(cfg.num_heads) > 1)
    return layers.ffn_residual_ln_apply(
        layer_params["ffn_in"], layer_params["ffn_out"],
        layer_params["final_layer_norm"], x, cfg.activation, dtype,
        cfg.layer_norm_eps, key=k_ffn, act_dropout=cfg.activation_dropout,
        out_dropout=cfg.dropout, tp=ffn_tp)


def speech_encoder_apply(params, cfg: SpeechEncoderConfig, waveform,
                         lengths=None, output_hidden_states=False,
                         dtype=torch.float32, dropout_rng=None):
    """waveform: (B, T_samples) zero-padded; lengths: (B,) sample counts or
    None for full length; dropout_rng: a DropoutKey for training mode, None
    for the deterministic forward.  Returns dict(last_hidden_state
    (B, T, H), frame_lengths (B,), frame_mask (B, T), layers_skipped (the
    indices LayerDrop skipped)[, hidden_states (L+1, B, T, H) with the
    embedding output first; a skipped layer repeats its input; pre-LN: the
    last entry is the state after the encoder LayerNorm, as HF's
    Wav2Vec2EncoderStableLayerNorm appends it])."""
    check_key(dropout_rng)
    b, t_samples = waveform.shape
    if lengths is None:
        lengths = torch.full((b,), t_samples, dtype=torch.long,
                             device=waveform.device)
    feats = extract_features(params, cfg, waveform, lengths, dtype)
    frame_lengths = cfg.feature_lengths(lengths)
    frame_mask = length_mask(frame_lengths, feats.shape[1])

    k_proj, k_pos, k_layers, k_spec = split_or_none(dropout_rng, 4)
    own = lambda key, *axes: mesh_lib.fold_key(key, mesh_lib.DATA_AXIS, *axes)
    k_proj, k_pos = own(k_proj), own(k_pos)

    fp = params["feature_projection"]
    h = layers.layer_norm(fp["layer_norm"], feats, cfg.layer_norm_eps)
    h = layers.dense(fp["projection"], h, dtype)
    h = layers.dropout(h, cfg.feat_proj_dropout, k_proj)
    if k_spec is not None and cfg.apply_spec_augment:
        h = _spec_augment(params, cfg, h, frame_lengths, k_spec)
    # zero padded frames before the pos-conv so padding can't leak in
    h = h * frame_mask[..., None].to(h.dtype)
    pos = layers.conv1d_same_grouped(params["pos_conv"], h,
                                     cfg.pos_conv_groups, dtype)
    h = h + F.gelu(pos)
    if not cfg.do_stable_layer_norm:
        h = layers.layer_norm(params["encoder_layer_norm"], h,
                              cfg.layer_norm_eps)
    h = layers.dropout(h, cfg.dropout, k_pos)

    n_layers = len(params["layers"])
    layer_keys, skips = [None] * n_layers, [False] * n_layers
    seq = mesh_lib.active_seq_mesh()
    if k_layers is not None:
        k_layers, k_drop = k_layers.split(2)
        layer_keys = [own(k, mesh_lib.SEQ_AXIS)
                      for k in k_layers.split(n_layers)]
        skips = layerdrop_skips(k_drop, n_layers, cfg.layerdrop)
    hidden = [h] if output_hidden_states else None
    t_full, kv_mask = h.shape[1], frame_mask
    if seq is not None:
        h = collectives.split_time(pad_time(h, seq.n_seq), seq)
        size = h.shape[1]
        kv_mask = pad_time(frame_mask, seq.n_seq).narrow(
            1, seq.seq_rank * size, size)

    def whole(x):
        if seq is None:
            return x
        return collectives.gather_time(x, seq)[:, :t_full]
    for layer_params, key, skip in zip(params["layers"], layer_keys, skips):
        if not skip:
            with profiling.annotate("speech_encoder.layer"):
                h = layers.remat(cfg.remat, _encoder_layer, layer_params, h,
                                 kv_mask, cfg, dtype, key, seq)
        if hidden is not None:
            hidden.append(whole(h))
    h = hidden[-1] if hidden is not None else whole(h)
    if cfg.do_stable_layer_norm:
        h = layers.layer_norm(params["encoder_layer_norm"], h,
                              cfg.layer_norm_eps)
        if hidden is not None:
            hidden[-1] = h
    out = {"last_hidden_state": h, "frame_lengths": frame_lengths,
           "frame_mask": frame_mask,
           "layers_skipped": [i for i, skip in enumerate(skips) if skip]}
    if hidden is not None:
        out["hidden_states"] = torch.stack(hidden)
    return out


def _spec_augment(params, cfg, h, frame_lengths, key):
    """HF's SpecAugment between the feature projection and the positional
    conv: time spans replaced by masked_spec_embed (when the tree has it),
    channel spans zeroed across all frames."""
    b, t_frames, hdim = h.shape
    k_time, k_feat = key.split(2)
    # the draws of the global batch, this data rank's rows of them
    m = mesh_lib.active_mesh()
    rows = slice(None) if m is None else slice(m.data_rank * b,
                                                (m.data_rank + 1) * b)
    n_rows = mesh_lib.data_global_rows(b)

    def draws(k, size):
        eps, u = mask_span_draws(k, n_rows, size, h.device)
        return eps, u[rows]
    if cfg.mask_time_prob > 0 and "masked_spec_embed" in params:
        tmask = compute_time_mask(
            *draws(k_time, t_frames), frame_lengths,
            cfg.mask_time_prob, cfg.mask_time_length,
            cfg.mask_time_min_masks)
        h = torch.where(tmask[..., None],
                        params["masked_spec_embed"].to(h.dtype), h)
    if cfg.mask_feature_prob > 0:
        fmask = compute_mask_spans(
            *draws(k_feat, hdim),
            torch.full((b,), hdim, device=h.device), cfg.mask_feature_prob,
            cfg.mask_feature_length, cfg.mask_feature_min_masks)
        h = torch.where(fmask[:, None, :], torch.zeros((), dtype=h.dtype,
                                                       device=h.device), h)
    return h


def init_speech_encoder(cfg: SpeechEncoderConfig, generator, device,
                        dtype=torch.float32):
    """Random parameters with the JAX package's structure (normal(0, 0.02)
    dense kernels, scaled-normal convs, unit LayerNorms, zero biases,
    masked_spec_embed uniform in [0, 1) as HF's), drawn from `generator`;
    matrices in `dtype`, vectors in float32.  masked_spec_embed comes first
    in the tree, where HF registers it."""

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

    params = {
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
    # drawn last, so the other parameters of a seed are those it gave
    # before the tree carried this vector
    embed = torch.rand(h, generator=generator,
                       device=generator.device).to(device)
    return {"masked_spec_embed": embed, **params}
