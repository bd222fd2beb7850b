"""Reference-compatible high-level API (port of ``speechmix_tpu.api``).

The constructor / forward / generate surface of the reference's twelve
model classes, as the JAX package has them:

    from speechmix_tpu_torch import SpeechMixEED
    spm = SpeechMixEED("wav2vec2-base", "facebook/bart-base", down_scale=2,
                       dtype="bfloat16")            # on the card
    out = spm([waveform], labels=labels)            # {"logits", "loss", ...}
    tokens = spm.generate([waveform], max_length=100)

Differences from the JAX package's classes:
  * ``device`` (default: the card; without CUDA the constructor raises
    unless ``device="cpu"``).  Every call runs there.
  * ``use_flash`` is accepted for the signature's sake only: the port runs
    its hand-written kernels whenever the tensors are on the card.
  * the matrices of ``self.params`` are held in the compute dtype (bf16
    for ``dtype="bfloat16"``, as the port serves; the JAX package casts its
    float32 matrices to it at every use, to the same values); vectors stay
    float32.  Files are float32 either way.
  * there are no jit caches; ``forward`` runs without autograd.
  * ``list_grad`` / ``list_no_grad`` name each layer's tensors
    ("nlp/decoder/layers/3/fc1/kernel"), where the JAX package's stacked
    tree has one path for all layers.

``save_pretrained`` writes config.json, weights.npz (the JAX package's
archive: its key strings and layout) and, for variant kwargs,
model_kwargs.json, so a directory either package writes loads in the other.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from . import convert
from . import generation as gen_lib
from .config import (SpeechMixConfig, seq2seq_config,
                     speech_encoder_config)
from .data.tokenizer import load_tokenizer
from .models import speechmix as smx
from .ops.kernels._cuda import resolve_device
from .training import freezing
from .training.checkpoint import load_pytree_npz, save_pytree_npz
from .utils.platform import torch_dtype

_DEFAULT_FIXED_EXCEPT = ("layer_norm", "encoder_attn", "enc_to_dec_proj",
                         "length_adapter", "layernorm_embedding", "attention",
                         "encoder")


def _prepare_audio(input_values, max_len=None, bucket_samples=16000,
                   encoder_cfg=None, device="cpu"):
    """A list of 1-D waveforms (the reference's convention) or a 2-D array
    -> (batch (B, T) float32, lengths (B,) int32) on `device`.  A list's
    batch length is rounded up to a 1-second bucket, so similar calls see
    the same shapes; with encoder_cfg it is then frame-aligned."""
    def align(t):
        return (encoder_cfg.aligned_samples(t) if encoder_cfg is not None
                else t)
    if isinstance(input_values, (list, tuple)):
        arrays = [np.asarray(x, np.float32).reshape(-1) for x in input_values]
        lengths = np.array([len(a) for a in arrays], np.int32)
        t = max_len or int(lengths.max())
        t = max(bucket_samples,
                int(np.ceil(t / bucket_samples) * bucket_samples))
        batch = np.zeros((len(arrays), align(t)), np.float32)
        for i, a in enumerate(arrays):
            batch[i, : min(len(a), t)] = a[:t]
        lengths = np.minimum(lengths, t)
    else:
        batch = np.asarray(input_values, np.float32)
        if batch.ndim == 1:
            batch = batch[None]
        lengths = np.full((batch.shape[0],), batch.shape[1], np.int32)
        t_pad = align(batch.shape[1])
        if t_pad != batch.shape[1]:
            batch = np.pad(batch, ((0, 0), (0, t_pad - batch.shape[1])))
    return (torch.from_numpy(np.ascontiguousarray(batch)).to(device),
            torch.from_numpy(lengths).to(device))


class _SpeechMixBase:
    """Shared machinery of all variants."""

    variant = "eed"
    weighted_sum_convention = "hf"

    def __init__(self, speech_model_config, nlp_model_config,
                 share_layer_ratio=0, down_scale=8, weighted_sum=False,
                 fixed_parameters=False, fixed_except=_DEFAULT_FIXED_EXCEPT,
                 seed=0, dtype="float32", device=None, **kwargs):
        enc_cfg = speech_encoder_config(speech_model_config)
        dec_cfg = seq2seq_config(nlp_model_config)
        config = SpeechMixConfig(
            encoder=enc_cfg, decoder=dec_cfg, variant=self.variant,
            share_layer_ratio=share_layer_ratio, down_scale=down_scale,
            weighted_sum=weighted_sum,
            weighted_sum_convention=self.weighted_sum_convention,
            fixed_parameters=fixed_parameters,
            fixed_except=tuple(fixed_except), dtype=dtype)
        self._setup(config, kwargs, device, seed,
                    nlp_model_config if isinstance(nlp_model_config, str)
                    else dec_cfg.name)

    def _setup(self, config, variant_kwargs, device, seed, tokenizer_name):
        self.config = config
        self.device = resolve_device(device)
        self.tokenizer = load_tokenizer(tokenizer_name,
                                        decoder_config=config.decoder)
        gen = (torch.Generator(device=self.device) if self.device.type ==
               "cuda" else torch.Generator())
        self.params = smx.init_speechmix(config, gen.manual_seed(seed),
                                         self.device, self._dtype)
        self._variant_kwargs = variant_kwargs
        self._refresh_grad_lists(**{
            k: v for k, v in variant_kwargs.items()
            if k in ("fixed_speech", "fixed_nlp")})

    # -- bookkeeping parity (the reference's model.py:115-127) --------------
    def _refresh_grad_lists(self, fixed_speech=False, fixed_nlp=True):
        mask = freezing.variant_trainable_mask(
            self.params, self.config, fixed_speech=fixed_speech,
            fixed_nlp=fixed_nlp)
        self.trainable_mask = mask
        self.list_grad, self.list_no_grad = freezing.count_trainable(
            self.params, mask)

    @property
    def speech_encoder_layer(self) -> int:
        return self.config.num_speech_encoder_layers

    @property
    def nlp_encoder_layer(self) -> int:
        return self.config.decoder.encoder_layers

    @property
    def weights_sum(self):
        return self.params.get("weights_sum")

    @property
    def _dtype(self):
        return torch_dtype(self.config.dtype)

    def _prompt(self, text):
        if text is None:
            return None
        ids = self.tokenizer.encode(text, add_special_tokens=False)
        return torch.tensor(ids, dtype=torch.long, device=self.device)

    def _tensor(self, x):
        return (None if x is None else
                torch.as_tensor(np.asarray(x)).to(self.device))

    # -- forward ------------------------------------------------------------
    @torch.no_grad()
    def forward(self, input_values, labels=None, decoder_input_ids=None,
                text_input_ids=None, input_text_prompt=None,
                decoder_text_prompt=None, return_model_detail=False,
                use_flash=None):
        """The deterministic forward: {"logits" (B, L, V) float32,
        "predictions" (their argmax)[, "loss" and the variant's loss terms
        with labels][, the model details]}.  use_flash: ignored (see the
        module docstring)."""
        batch, lengths = _prepare_audio(input_values,
                                        encoder_cfg=self.config.encoder,
                                        device=self.device)
        out = smx.speechmix_forward(
            self.params, self.config, batch, lengths=lengths,
            labels=self._tensor(labels),
            decoder_input_ids=self._tensor(decoder_input_ids),
            text_input_ids=self._tensor(text_input_ids),
            prompt_ids=self._prompt(input_text_prompt or decoder_text_prompt),
            return_model_detail=return_model_detail, dtype=self._dtype)
        out.pop("layers_skipped")
        out["predictions"] = out["logits"].argmax(-1)
        return out

    __call__ = forward

    # -- generation ---------------------------------------------------------
    def generate(self, input_values, decoder_text_prompt=None,
                 max_length=None, num_beams=1, length_penalty=1.0,
                 early_stopping=False, use_flash=None, kv_int8=False,
                 do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
                 seed=0, min_length=0, repetition_penalty=1.0,
                 no_repeat_ngram_size=0, forced_bos_token_id=None,
                 forced_eos_token_id=None, bad_words_ids=None,
                 suppress_tokens=None, begin_suppress_tokens=None,
                 num_return_sequences=1, output_scores=False,
                 return_dict_in_generate=False, num_beam_groups=1,
                 diversity_penalty=0.0, max_new_tokens=None, typical_p=1.0,
                 encoder_no_repeat_ngram_size=0, encoder_input_ids=None,
                 prefix_allowed_tokens_fn=None, force_words_ids=None):
        """generation.generate on this model's parameters with the JAX
        package's keywords (HF's generate() surface: see there).  Returns
        the tokens (B * num_return_sequences, max_length); with
        output_scores or return_dict_in_generate a dict {"sequences"[,
        "scores" (greedy / sampling: (max_length, B, V)) or
        "sequences_scores" (beam modes)]}.  max_new_tokens counts generated
        tokens, as max_length does; seed seeds the sampling draws (used
        only with do_sample).  use_flash: ignored."""
        if max_new_tokens is not None:
            max_length = max_new_tokens
        batch, lengths = _prepare_audio(input_values,
                                        encoder_cfg=self.config.encoder,
                                        device=self.device)
        enc_ids = self._tensor(encoder_input_ids)
        if enc_ids is not None and enc_ids.ndim == 1:
            enc_ids = enc_ids[None]
        out = gen_lib.generate(
            self.params, self.config, batch, lengths,
            prompt_ids=self._prompt(decoder_text_prompt),
            max_length=max_length, num_beams=num_beams,
            length_penalty=length_penalty, early_stopping=early_stopping,
            dtype=self._dtype, kv_int8=kv_int8, do_sample=do_sample,
            temperature=temperature, top_k=top_k, top_p=top_p,
            typical_p=typical_p, rng=seed if do_sample else None,
            min_length=min_length, repetition_penalty=repetition_penalty,
            no_repeat_ngram_size=no_repeat_ngram_size,
            forced_bos_token_id=forced_bos_token_id,
            forced_eos_token_id=forced_eos_token_id,
            bad_words_ids=bad_words_ids, suppress_tokens=suppress_tokens,
            begin_suppress_tokens=begin_suppress_tokens,
            num_return_sequences=num_return_sequences,
            output_scores=output_scores, num_beam_groups=num_beam_groups,
            diversity_penalty=diversity_penalty,
            encoder_no_repeat_ngram_size=encoder_no_repeat_ngram_size,
            encoder_input_ids=enc_ids,
            prefix_allowed_tokens_fn=prefix_allowed_tokens_fn,
            force_words_ids=force_words_ids, device=self.device)
        if output_scores or return_dict_in_generate:
            d = {"sequences": out[0]}
            if output_scores:
                d["sequences_scores" if num_beams > 1 else "scores"] = out[2]
            return d
        return out[0]

    # -- persistence --------------------------------------------------------
    def save_weights(self, path: str):
        """The parameters as the JAX package's npz archive (float32, its key
        strings and layout)."""
        save_pytree_npz(path, convert.params_to_jax_paths(self.params))

    def load_weights(self, path: str):
        """Parameters from an npz archive that either package wrote, into
        this model's tensors."""
        convert.params_from_jax_paths(load_pytree_npz(path), self.params,
                                      source=f"checkpoint {path}")

    def save_pretrained(self, directory: str):
        """config.json + weights.npz (+ model_kwargs.json when the variant
        was built with extra kwargs such as fixed_speech / fixed_nlp, which
        shape the trainable mask)."""
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "config.json"), "w") as f:
            f.write(self.config.to_json())
        if self._variant_kwargs:
            with open(os.path.join(directory, "model_kwargs.json"),
                      "w") as f:
                json.dump(self._variant_kwargs, f)
        self.save_weights(os.path.join(directory, "weights.npz"))

    @classmethod
    def from_pretrained(cls, directory: str, device=None):
        """A model saved with save_pretrained by either package, with its
        variant kwargs (so the trainable mask round-trips too)."""
        with open(os.path.join(directory, "config.json")) as f:
            cfg = SpeechMixConfig.from_json(f.read())
        kwargs = {}
        kw_path = os.path.join(directory, "model_kwargs.json")
        if os.path.exists(kw_path):
            with open(kw_path) as f:
                kwargs = json.load(f)
        self = cls.__new__(cls)
        self._setup(cfg, kwargs, device, 0, cfg.decoder.name)
        self.load_weights(os.path.join(directory, "weights.npz"))
        return self

    @classmethod
    def from_reference_checkpoint(cls, checkpoint_dir: str,
                                  share_layer_ratio=0, down_scale=8,
                                  weighted_sum=False, tokenizer_path=None,
                                  **kwargs):
        """A model from a reference fused checkpoint directory (the
        `voidful/speechmix_eed_fixed` layout: a composite config.json beside
        pytorch_model.bin or model.safetensors).  The architecture comes
        from config.json (convert.config_from_hf); the fusion
        hyperparameters are not stored there, so pass the recipe's
        share_layer_ratio / down_scale.  The tokenizer loads from
        tokenizer_path or the checkpoint directory when either holds one.
        kwargs (dtype, device, ...) go to the constructor."""
        derived = convert.config_from_hf(checkpoint_dir)
        if not isinstance(derived, tuple):
            raise ValueError(
                f"{checkpoint_dir} holds a single-model config "
                f"({type(derived).__name__}); from_reference_checkpoint "
                f"needs the fused composite layout — use "
                f"load_hf_checkpoint for separate backbone checkpoints")
        enc_cfg, dec_cfg = derived
        self = cls(enc_cfg, dec_cfg, share_layer_ratio=share_layer_ratio,
                   down_scale=down_scale, weighted_sum=weighted_sum,
                   **kwargs)
        tok_src = str(tokenizer_path or checkpoint_dir)
        if os.path.exists(os.path.join(tok_src, "tokenizer.json")) or \
                os.path.exists(os.path.join(tok_src, "tokenizer_config.json")):
            self.tokenizer = load_tokenizer(tok_src, decoder_config=dec_cfg)
        self.params = convert.load_speechmix(checkpoint_dir, self.config,
                                             self._dtype, self.device)
        self._refresh_grad_lists()
        return self

    def export_reference_state_dict(self, path: str = None):
        """The parameters as a reference-format torch state dict
        (convert.export_speechmix: numpy arrays under the reference's key
        names), which the reference HFSpeechMixEED loads; with `path` also
        saved there with torch.save."""
        sd = convert.export_speechmix(self.params, self.config)
        if path:
            torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
        return sd

    def load_hf_checkpoint(self, speech_path=None, nlp_path=None):
        """Pretrained backbones from local HF checkpoints (convert's
        loaders), the speech encoder at this model's depth."""
        if speech_path:
            self.params["speech_encoder"] = convert.load_speech_encoder(
                speech_path, self.config.encoder,
                num_layers=self.config.num_speech_encoder_layers,
                dtype=self._dtype, device=self.device)
        if nlp_path:
            self.params["nlp"] = convert.load_seq2seq(
                nlp_path, self.config.decoder, dtype=self._dtype,
                device=self.device)


class SpeechMixEED(_SpeechMixBase):
    """Core embed-fusion model (the reference's model.py:57-177); s3prl
    weighted-sum convention (L weights)."""
    variant = "eed"
    weighted_sum_convention = "s3prl"


class HFSpeechMixEED(_SpeechMixBase):
    """Embed fusion, HF weighted-sum convention (L + 1 weights, the
    embedding output included)."""
    variant = "eed"
    weighted_sum_convention = "hf"


class SpeechMixED(_SpeechMixBase):
    """Cross-attention fusion (model.py:26-54): the decoder attends the
    projected speech states; no text-encoder pass.  down_scale defaults to
    1, as in the reference."""
    variant = "ed"
    weighted_sum_convention = "s3prl"

    def __init__(self, speech_model_config, nlp_model_config,
                 fixed_parameters=False, fixed_except=_DEFAULT_FIXED_EXCEPT,
                 **kwargs):
        kwargs.setdefault("down_scale", 1)
        super().__init__(speech_model_config, nlp_model_config,
                         fixed_parameters=fixed_parameters,
                         fixed_except=fixed_except, **kwargs)


class HFSpeechMixED(SpeechMixED):
    weighted_sum_convention = "hf"


class SpeechMixFixed(_SpeechMixBase):
    """Frozen speech and / or NLP backbones (model.py:180-193), by the
    fixed_speech / fixed_nlp kwargs."""
    variant = "fixed"
    weighted_sum_convention = "s3prl"


class HFSpeechMixFixed(SpeechMixFixed):
    weighted_sum_convention = "hf"


class SpeechMixAdapter(_SpeechMixBase):
    """Frozen NLP layer stacks with per-layer bottleneck adapters
    (model.py:196-222)."""
    variant = "adapter"
    weighted_sum_convention = "s3prl"


class HFSpeechMixAdapter(SpeechMixAdapter):
    weighted_sum_convention = "hf"


class SpeechMixSelf(_SpeechMixBase):
    """Self-distillation: CE + KLD + MSE against the frozen NLP model on
    the ground-truth text (model.py:225-266)."""
    variant = "self"
    weighted_sum_convention = "s3prl"


class HFSpeechMixSelf(SpeechMixSelf):
    weighted_sum_convention = "hf"


class SpeechMixGAN(_SpeechMixBase):
    """Adversarial feature matching on hidden-state Gram matrices
    (model.py:269-349)."""
    variant = "gan"
    weighted_sum_convention = "s3prl"


class HFSpeechMixGAN(SpeechMixGAN):
    weighted_sum_convention = "hf"
