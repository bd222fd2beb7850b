"""SpeechMix fusion (port of ``speechmix_tpu.models.speechmix``): the bridge
``encode_speech`` that serving and training share, and the training forward
``speechmix_forward`` of the variants eed, fixed and ed, deterministic or,
with a ``dropout_rng`` (a DropoutKey), with dropout, SpecAugment and
LayerDrop at HF's placements.

speech encoder -> [learned softmax weighted sum over layer states]
               -> stride-2 conv length adapters (log2(down_scale) of them)
               -> Linear enc->dec projection -> frame mask
               -> [text prompt prefix] -> inputs_embeds of the text encoder.
"""

from __future__ import annotations

import torch

from ..config import SpeechMixConfig
from ..ops import layers
from ..ops.kernels.dropout import check_key, split_or_none
from ..ops.masking import downscale_lengths, length_mask
from . import seq2seq
from . import speech_encoder as se
from .init import conv_params, dense_params


PORTED_VARIANTS = ("eed", "fixed", "ed")


def _check_supported(cfg: SpeechMixConfig):
    if cfg.variant not in PORTED_VARIANTS:
        raise NotImplementedError(f"the {cfg.variant!r} variant is not "
                                  "ported yet")


def encode_speech(params, cfg: SpeechMixConfig, input_values, lengths=None,
                  prompt_ids=None, dtype=torch.float32, dropout_rng=None,
                  details=None):
    """Waveform -> fused inputs_embeds for the text encoder.
    input_values: (B, T_samples) zero-padded; lengths: (B,) sample counts;
    prompt_ids: optional (P,) or (B, P) token ids embedded and put before
    the speech embeddings; dropout_rng: the speech encoder's training key.
    A `details` dict receives "layers_skipped" (LayerDrop's skipped layer
    indices).  Returns (inputs_embeds (B, P+T', H_nlp), mask (B, P+T'))."""
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
        h = torch.einsum("l,lbth->bth", norm_w.to(h.dtype), stacked)
    for conv in params["length_adapter"]:
        h = layers.conv1d(conv, h, stride=2, dtype=dtype)
    h = layers.dense(params["enc_to_dec_proj"], h, dtype)
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


def speechmix_forward(params, cfg: SpeechMixConfig, input_values,
                      lengths=None, labels=None, decoder_input_ids=None,
                      prompt_ids=None, dtype=torch.float32, dropout_rng=None):
    """Training / evaluation forward of the embed-fusion variants eed and
    fixed (speech embeddings into the text encoder) and of ed (the decoder
    cross-attends the projected speech states; no text-encoder pass).

    labels: (B, L) with -100 padding; decoder inputs default to the labels
    shifted right, or to one start token when there are no labels either.
    dropout_rng: a DropoutKey for training mode (split for the speech
    encoder and the NLP model, as the JAX package splits its rng), None for
    the deterministic forward.  Returns dict(logits (B, L, V) float32,
    layers_skipped[, loss])."""
    _check_supported(cfg)
    check_key(dropout_rng)
    k_speech, k_nlp = split_or_none(dropout_rng, 2)
    dcfg = cfg.decoder
    if decoder_input_ids is None and labels is not None:
        decoder_input_ids = seq2seq.shift_tokens_right(
            labels, dcfg.pad_token_id, dcfg.decoder_start_token_id)
    elif decoder_input_ids is None:
        decoder_input_ids = torch.full(
            (input_values.shape[0], 1), dcfg.decoder_start_token_id,
            dtype=torch.long, device=input_values.device)
    details = {}
    inputs_embeds, enc_mask = encode_speech(params, cfg, input_values,
                                            lengths, prompt_ids, dtype,
                                            k_speech, details)
    if cfg.variant == "ed":
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
            labels=labels, dtype=dtype, dropout_rng=k_nlp)
    result = {"logits": out["logits"],
              "layers_skipped": details["layers_skipped"]}
    if labels is not None:
        result["loss"] = out["loss"]
    return result


def init_speechmix(cfg: SpeechMixConfig, generator: torch.Generator, device,
                   dtype=torch.float32):
    """Random parameters with the JAX package's structure and shapes, drawn
    from `generator` (not bit-equal to the JAX init).  Matrices are made in
    `dtype`, vectors in float32, as ``convert.params_from_jax`` casts a
    converted tree."""
    _check_supported(cfg)

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
    return params
