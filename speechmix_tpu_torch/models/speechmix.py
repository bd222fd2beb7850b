"""SpeechMix fusion (port of ``speechmix_tpu.models.speechmix``): the bridge
``encode_speech`` that serving and training share, and the training forward
``speechmix_forward`` of every variant (eed, fixed, ed, adapter, self and
gan), deterministic or, with a ``dropout_rng`` (a DropoutKey), with
dropout, SpecAugment and LayerDrop at HF's placements.

speech encoder -> [learned softmax weighted sum over layer states]
               -> stride-2 conv length adapters (log2(down_scale) of them)
               -> Linear enc->dec projection -> frame mask
               -> [text prompt prefix] -> inputs_embeds of the text encoder.
"""

from __future__ import annotations

import math

import torch

from ..config import SpeechMixConfig
from ..ops import layers
from ..ops.kernels.dropout import check_key, split_or_none
from ..ops.masking import downscale_lengths, length_mask
from ..parallel import mesh as mesh_lib
from . import seq2seq
from . import speech_encoder as se
from .init import conv_params, dense_params


def encode_speech(params, cfg: SpeechMixConfig, input_values, lengths=None,
                  prompt_ids=None, dtype=torch.float32, dropout_rng=None,
                  details=None):
    """Waveform -> fused inputs_embeds for the text encoder.
    input_values: (B, T_samples) zero-padded; lengths: (B,) sample counts;
    prompt_ids: optional (P,) or (B, P) token ids embedded and put before
    the speech embeddings; dropout_rng: the speech encoder's training key.
    A `details` dict receives "layers_skipped" (LayerDrop's skipped layer
    indices) and the JAX package's model details: "weighted_sum" (the
    softmaxed layer weights, when the config has them),
    "shape_before_length_adapter", "shape_before_enc_dec_projector" and
    "shape_after_enc_dec_projector".  Returns (inputs_embeds (B, P+T',
    H_nlp), mask (B, P+T'))."""
    enc_out = se.speech_encoder_apply(
        params["speech_encoder"], cfg.encoder, input_values, lengths,
        output_hidden_states=cfg.weighted_sum, dtype=dtype,
        dropout_rng=dropout_rng)
    if details is not None:
        details["layers_skipped"] = enc_out["layers_skipped"]
    h = enc_out["last_hidden_state"]
    if cfg.weighted_sum:
        stacked = enc_out["hidden_states"]  # (L+1, B, T, H)
        if cfg.weighted_sum_convention == "s3prl":
            stacked = stacked[1:]  # s3prl omits the embedding output
        norm_w = torch.softmax(params["weights_sum"].float(), dim=0)
        if details is not None:
            details["weighted_sum"] = norm_w
        h = torch.einsum("l,lbth->bth", norm_w.to(h.dtype), stacked)
    shapes = {"shape_before_length_adapter": tuple(h.shape)}
    for conv in params["length_adapter"]:
        h = layers.conv1d(conv, h, stride=2, dtype=dtype)
    shapes["shape_before_enc_dec_projector"] = tuple(h.shape)
    h = layers.dense(params["enc_to_dec_proj"], h, dtype)
    shapes["shape_after_enc_dec_projector"] = tuple(h.shape)
    if details is not None:
        details.update(shapes)
    frame_lengths = downscale_lengths(enc_out["frame_lengths"], cfg.downloop)
    mask = length_mask(frame_lengths, h.shape[1])
    h = h * mask[..., None].to(h.dtype)
    if prompt_ids is not None:
        if prompt_ids.ndim == 1:
            prompt_ids = prompt_ids[None].expand(h.shape[0], -1)
        prompt = seq2seq.embed_tokens(params["nlp"], cfg.decoder, prompt_ids,
                                      dtype)
        h = torch.cat([prompt, h], dim=1)
        mask = torch.cat([torch.ones(prompt_ids.shape, dtype=torch.bool,
                                     device=mask.device), mask], dim=1)
    return h, mask


def gan_decoder_mask(decoder_input_ids, pad_token_id):
    """Valid positions of the GAN's decoder Gram features: the ids that are
    not padding, and position 0 always (it holds the start token, which
    equals the pad id in T5's vocabularies)."""
    mask = decoder_input_ids != pad_token_id
    mask[:, 0] = True
    return mask


def _masked_gram(h, mask, hidden):
    """(B, T, H) -> the Gram matrix over the valid positions, flattened to
    (B, H * H) in float32 (the products of h's dtype summed in f32)."""
    hm = (h * mask[..., None].to(h.dtype)).float()
    return torch.einsum("bth,btk->bhk", hm, hm).reshape(h.shape[0],
                                                         hidden * hidden)


def _self_loss(cfg, out, nlp_out):
    """The self variant's CE + KLD + MSE: the speech pass's last text-encoder
    states attention-projected onto the text positions, the MSE over the
    valid text positions only."""
    dcfg = cfg.decoder
    nlp_hidden = nlp_out["encoder_hidden_states"][-1]      # (B, Tt, H)
    speech_hidden = out["encoder_hidden_states"][-1]       # (B, Ts, H)
    attn = torch.einsum("bth,bsh->bts", nlp_hidden.float(),
                        speech_hidden.float()) / math.sqrt(dcfg.hidden_size)
    attn = torch.where(out["encoder_mask"][:, None, :], attn, -1e9)
    attn = torch.softmax(attn, dim=-1)
    projected = torch.einsum("bts,bsh->bth",
                             attn.to(speech_hidden.dtype).float(),
                             speech_hidden.float())
    sq = torch.square(projected - nlp_hidden.float())
    valid = nlp_out["encoder_mask"].float()
    # over the valid positions of the global batch (see
    # layers.cross_entropy_with_ignore)
    mse = ((sq * valid[..., None]).sum()
           / torch.clamp_min(mesh_lib.data_sum(valid.sum()) * sq.shape[-1],
                             1.0))
    kld = layers.kld_batchmean(out["logits"], nlp_out["logits"])
    ce = out["loss"]
    loss = (cfg.self_kld_weight * kld + cfg.self_ce_weight * ce
            + cfg.self_mse_weight * mse)
    return {"loss": loss, "ce_loss": ce, "kld_loss": kld, "mse_loss": mse}


def _gan_loss(params, cfg, out, nlp_out, inputs_embeds, enc_mask,
              decoder_input_ids, dtype):
    """The gan variant's loss: the discriminator's BCE on four masked Gram
    features, the speech path's (the fused embeddings and the decoder's
    last states) labelled 1, the text path's labelled 0."""
    dcfg = cfg.decoder
    h = dcfg.hidden_size
    dec_mask = gan_decoder_mask(decoder_input_ids, dcfg.pad_token_id)
    feats = {
        "voice_enc": (inputs_embeds, enc_mask, 1.0),
        "voice_dec": (out["decoder_hidden_states"][-1], dec_mask, 1.0),
        "nlp_enc": (nlp_out["encoder_hidden_states"][-1],
                    nlp_out["encoder_mask"], 0.0),
        "nlp_dec": (nlp_out["decoder_hidden_states"][-1], dec_mask, 0.0),
    }
    result, total = {}, 0.0
    for name, (states, mask, target) in feats.items():
        gram = _masked_gram(states, mask, h)
        logit = layers.dense(params["discriminator"],
                             gram.to(dtype)).squeeze(-1)
        term = layers.bce_with_logits(logit, torch.full_like(
            logit, target, dtype=torch.float32))
        result[f"{name}_loss"] = term
        total = total + term
    result["loss"] = total
    return result


def speechmix_forward(params, cfg: SpeechMixConfig, input_values,
                      lengths=None, labels=None, decoder_input_ids=None,
                      prompt_ids=None, dtype=torch.float32, dropout_rng=None,
                      text_input_ids=None, text_mask=None,
                      return_model_detail=False):
    """Training / evaluation forward of the embed-fusion variants eed,
    fixed, adapter (adapters after every NLP block), self and gan (speech
    embeddings into the text encoder), and of ed (the decoder cross-attends
    the projected speech states; no text-encoder pass).

    labels: (B, L) with -100 padding; decoder inputs default to the labels
    shifted right, or to one start token when there are no labels either.
    text_input_ids / text_mask: the ground-truth text of the self and gan
    variants' second pass (the mask defaults to ids != pad_token_id; gan
    without text ids takes the labels, -100 as pad).
    dropout_rng: a DropoutKey for training mode, None for the deterministic
    forward; under a mesh the losses are this data rank's share of the
    global batch's (``layers.cross_entropy_with_ignore``).  The JAX
    package splits its rng three ways (speech, NLP, text pass); the port's
    ``split(3)`` keeps the first two keys of its ``split(2)``, so the speech
    and NLP keys are the ones they were before the text pass existed.  Returns dict(logits (B, L, V) float32,
    layers_skipped[, loss, and for self ce_loss, kld_loss, mse_loss, for gan
    voice_enc_loss, voice_dec_loss, nlp_enc_loss, nlp_dec_loss]), with
    return_model_detail also encode_speech's model details."""
    check_key(dropout_rng)
    k_speech, k_nlp, k_text = split_or_none(dropout_rng, 3)
    # the text side's masks are each data rank's own (the speech encoder
    # folds its mask keys itself, leaving LayerDrop and SpecAugment global)
    k_nlp = mesh_lib.fold_key(k_nlp, mesh_lib.DATA_AXIS)
    k_text = mesh_lib.fold_key(k_text, mesh_lib.DATA_AXIS)
    dcfg = cfg.decoder
    if decoder_input_ids is None and labels is not None:
        decoder_input_ids = seq2seq.shift_tokens_right(
            labels, dcfg.pad_token_id, dcfg.decoder_start_token_id)
    elif decoder_input_ids is None:
        decoder_input_ids = torch.full(
            (input_values.shape[0], 1), dcfg.decoder_start_token_id,
            dtype=torch.long, device=input_values.device)
    if text_mask is None and text_input_ids is not None:
        text_mask = text_input_ids != dcfg.pad_token_id
    details = {}
    inputs_embeds, enc_mask = encode_speech(params, cfg, input_values,
                                            lengths, prompt_ids, dtype,
                                            k_speech, details)
    variant = cfg.variant
    if variant == "ed":
        out = seq2seq.decode(params["nlp"], dcfg, decoder_input_ids,
                             encoder_mask=enc_mask, dtype=dtype,
                             enc_hidden=inputs_embeds, dropout_rng=k_nlp)
        if labels is not None:
            out["loss"] = layers.cross_entropy_with_ignore(out["logits"],
                                                           labels)
    else:
        out = seq2seq.seq2seq_apply(
            params["nlp"], dcfg, inputs_embeds=inputs_embeds,
            attention_mask=enc_mask, decoder_input_ids=decoder_input_ids,
            labels=labels if variant != "gan" else None, dtype=dtype,
            dropout_rng=k_nlp,
            output_hidden_states=variant in ("self", "gan"),
            adapters=params["adapters"] if variant == "adapter" else None)
    result = {"logits": out["logits"],
              "layers_skipped": details.pop("layers_skipped")}
    if return_model_detail:
        result.update(details)
    if labels is None:
        return result
    if variant == "self":
        nlp_out = seq2seq.seq2seq_apply(
            params["nlp"], dcfg, input_ids=text_input_ids,
            attention_mask=text_mask, decoder_input_ids=decoder_input_ids,
            labels=labels, dtype=dtype, dropout_rng=k_text,
            output_hidden_states=True)
        result.update(_self_loss(cfg, out, nlp_out))
    elif variant == "gan":
        text_ids = (text_input_ids if text_input_ids is not None else
                    torch.where(labels == -100, dcfg.pad_token_id, labels))
        if text_mask is None:
            text_mask = text_ids != dcfg.pad_token_id
        nlp_out = seq2seq.seq2seq_apply(
            params["nlp"], dcfg, input_ids=text_ids, attention_mask=text_mask,
            decoder_input_ids=decoder_input_ids, dtype=dtype,
            dropout_rng=k_text, output_hidden_states=True)
        result.update(_gan_loss(params, cfg, out, nlp_out, inputs_embeds,
                                enc_mask, decoder_input_ids, dtype))
    else:
        result["loss"] = out["loss"]
    return result


def init_speechmix(cfg: SpeechMixConfig, generator: torch.Generator, device,
                   dtype=torch.float32):
    """Random parameters with the JAX package's structure and shapes, drawn
    from `generator` (not bit-equal to the JAX init).  Matrices are made in
    `dtype`, vectors in float32, as ``convert.params_from_jax`` casts a
    converted tree."""

    enc = se.init_speech_encoder(cfg.encoder, generator, device, dtype)
    enc = se.truncate_layers(enc, cfg.num_speech_encoder_layers)
    h = cfg.encoder.hidden_size
    params = {
        "speech_encoder": enc,
        "nlp": seq2seq.init_seq2seq(cfg.decoder, generator, device, dtype),
        "enc_to_dec_proj": dense_params(generator, device, dtype, h,
                                        cfg.decoder.hidden_size),
        "length_adapter": [conv_params(generator, device, dtype, h, h, 2)
                           for _ in range(cfg.downloop)],
    }
    if cfg.weighted_sum:
        params["weights_sum"] = torch.zeros(cfg.num_weighted_sum,
                                            dtype=torch.float32,
                                            device=device)
    if cfg.variant == "adapter":
        params["adapters"] = seq2seq.init_seq2seq_adapters(
            cfg.decoder, generator, device, dtype,
            cfg.adapter_bottleneck_ratio)
    if cfg.variant == "gan":
        params["discriminator"] = dense_params(
            generator, device, dtype, cfg.decoder.hidden_size ** 2, 1)
    return params
