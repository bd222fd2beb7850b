"""Greedy generation (port of ``speechmix_tpu.generation``, greedy path).

The speech encoder and the text encoder run once; cross-attention K/V are
precomputed per layer; the decode loop runs a fixed ``max_length`` steps,
with padding after each row's EOS.  The loop never reads a value back to
the host, so the card is not held up by the Python loop's checks.

Beams, sampling and the HF logits processors are not ported yet:
``generate`` raises NotImplementedError when asked for any of them.
"""

from __future__ import annotations

import torch

from .config import SpeechMixConfig
from .models import seq2seq
from .models import speechmix as smx

# generate() keyword arguments of the JAX package that select a path this
# port does not have yet, with the value that leaves them off
_NOT_PORTED = {
    "length_penalty": 1.0, "early_stop": False, "early_stopping": False,
    "kv_int8": False, "do_sample": False, "temperature": 1.0, "top_k": 0,
    "top_p": 1.0, "typical_p": 1.0, "rng": None, "min_length": 0,
    "repetition_penalty": 1.0, "no_repeat_ngram_size": 0,
    "forced_bos_token_id": None, "forced_eos_token_id": None,
    "bad_words_ids": None, "suppress_tokens": None,
    "begin_suppress_tokens": None, "num_return_sequences": 1,
    "output_scores": False, "num_beam_groups": 1, "diversity_penalty": 0.0,
    "encoder_no_repeat_ngram_size": 0, "encoder_input_ids": None,
    "prefix_allowed_tokens_fn": None, "force_words_ids": None,
}


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the card.  Raises if the card
    is asked for and CUDA is not available: the port never moves to the CPU
    on its own."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return device


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return torch.as_tensor(tree).to(device)


@torch.no_grad()
def greedy_decode(params, dcfg, enc_hidden, enc_mask, max_length,
                  dtype=torch.float32):
    """Greedy decode against a text-encoder output.  Returns (tokens
    (B, max_length) with pad_token_id after EOS — the EOS itself included —,
    lengths (B,))."""
    b = enc_hidden.shape[0]
    device = enc_hidden.device
    cache = seq2seq.init_decoder_cache(params, dcfg, enc_hidden, b,
                                       max_length, dtype)
    tok = torch.full((b, 1), dcfg.decoder_start_token_id, dtype=torch.long,
                     device=device)
    finished = torch.zeros(b, dtype=torch.bool, device=device)
    pad = torch.full((b,), dcfg.pad_token_id, dtype=torch.long, device=device)
    steps = []
    for _ in range(max_length):
        out = seq2seq.decode(params, dcfg, tok, enc_mask, cache, dtype)
        cache = out["cache"]
        next_tok = torch.argmax(out["logits"][:, -1, :], dim=-1)
        next_tok = torch.where(finished, pad, next_tok)
        finished = finished | (next_tok == dcfg.eos_token_id)
        steps.append(next_tok)
        tok = next_tok[:, None]
    tokens = torch.stack(steps, dim=1)
    lengths = (tokens != dcfg.pad_token_id).sum(dim=1)
    return tokens, lengths


@torch.no_grad()
def generate(params, cfg: SpeechMixConfig, input_values, lengths=None,
             prompt_ids=None, max_length=None, num_beams=1,
             dtype=torch.float32, device=None, max_new_tokens=None,
             **kwargs):
    """Waveform -> fused embeddings -> text encoder (once) -> cached greedy
    decode.  input_values: (B, T_samples) zero-padded waveform; lengths:
    (B,) valid sample counts.  Runs on `device` (default: the card); params
    and inputs are moved there.  Returns (tokens (B, max_length),
    lengths (B,)).  max_new_tokens, when given, takes precedence over
    max_length (HF precedence)."""
    if num_beams != 1:
        raise NotImplementedError("beam search is not ported yet")
    for name, value in kwargs.items():
        if name not in _NOT_PORTED:
            raise TypeError(f"generate() got an unexpected keyword {name!r}")
        off = _NOT_PORTED[name]
        if not (value is off or (off is not None and value == off)):
            raise NotImplementedError(f"generate({name}=...) is not ported "
                                      "yet")
    smx._check_supported(cfg)
    device = resolve_device(device)
    if max_new_tokens is not None:
        max_length = max_new_tokens
    max_length = max_length or cfg.decoder.max_length
    params = _to_device(params, device)
    input_values = torch.as_tensor(input_values).to(device)
    if lengths is not None:
        lengths = torch.as_tensor(lengths).to(device)
    if prompt_ids is not None:
        prompt_ids = torch.as_tensor(prompt_ids).to(device)
    inputs_embeds, enc_mask = smx.encode_speech(
        params, cfg, input_values, lengths, prompt_ids, dtype)
    enc = seq2seq.encode(params["nlp"], cfg.decoder,
                         inputs_embeds=inputs_embeds,
                         attention_mask=enc_mask, dtype=dtype)
    return greedy_decode(params["nlp"], cfg.decoder,
                         enc["last_hidden_state"], enc_mask, max_length,
                         dtype)
