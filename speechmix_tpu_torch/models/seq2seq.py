"""BART-family seq2seq LM (port of ``speechmix_tpu.models.seq2seq``).

The text encoder (``encode``), the decoder (``decode``: cached single steps
over ``precompute_cross_kv`` / ``init_decoder_cache`` for generation, or the
uncached teacher-forcing pass for training) and the training forward
``seq2seq_apply``.  With a ``dropout_rng`` (a DropoutKey; uncached passes
only) they train with dropout at HF BART's placements: the embeddings, the
attention probabilities, each attention output and the FFN's activation and
output.  Layers are lists of parameter dicts.  With ``adapters`` (the
``adapter`` variant's bottleneck adapters, lists per side) the encoder and
the decoder replace each block's output by its adapter's.  T5 is not ported
yet.

Cache layout: self K/V (L, B, capacity, H, D), written in place by each
step; cross K/V (L, B_enc, T_enc, H, D), in the compute dtype or, with
``kv_int8``, as int8 codes with float32 scales (L, B_enc, T_enc, H).  (The
JAX package stores cross K/V batch-minor, (L, T_enc, H, D, B), for the
TPU's sake.)  B may be a multiple of B_enc: beam search keeps one cross K/V
per input and the beams of an input, contiguous in the batch, share it.

Single-token cached steps run kernel K4 (``ops.kernels.decode_attention``)
for self- and cross-attention.  The uncached decoder's causal self-attention
runs K1 / K7; its cross-attention carries the encoder's padding mask as a bias
and takes the plain path.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..config import Seq2SeqConfig
from ..ops import layers
from ..ops.attention import KVCache, attention, cache_position_bias
from ..ops.kernels.dropout import check_key, split_or_none
from ..ops.masking import combine_masks_to_bias
from ..ops.kernels.decode_attention import (decode_attention,
                                            decode_attention_plain)
from .init import dense_params, embedding_params, layer_norm_params


def _check_supported(cfg: Seq2SeqConfig):
    if cfg.arch != "bart":
        raise NotImplementedError(f"{cfg.arch!r} seq2seq models are not "
                                  "ported yet; only BART is")
    if cfg.activation == "gelu_gated":
        raise NotImplementedError("gated-GELU FFNs are not ported yet")


def shift_tokens_right(input_ids, pad_token_id, decoder_start_token_id):
    """labels -> decoder_input_ids: shift right, put the start token first,
    map any -100 to pad."""
    shifted = torch.empty_like(input_ids)
    shifted[:, 1:] = input_ids[:, :-1]
    shifted[:, 0] = decoder_start_token_id
    return torch.where(shifted == -100, pad_token_id, shifted)


class DecoderCache(NamedTuple):
    self_kv: KVCache          # key/value: (L, B, capacity, H, D)
    cross_k: torch.Tensor     # (L, B_enc, T_enc, H, D); int8 with scales
    cross_v: torch.Tensor
    cross_k_scale: Optional[torch.Tensor] = None   # (L, B_enc, T_enc, H) f32
    cross_v_scale: Optional[torch.Tensor] = None


def embed_tokens(params, cfg: Seq2SeqConfig, input_ids, dtype=torch.float32):
    x = layers.embed(params["shared"], input_ids, dtype)
    if cfg.scale_embedding:
        x = x * cfg.hidden_size ** 0.5
    return x


def _ffn_block(block, cfg, x, dtype, key):
    """The post-LN FFN block with its two dropout sites."""
    return layers.ffn_residual_ln_apply(
        block["fc1"], block["fc2"], block["final_layer_norm"], x,
        cfg.activation, dtype, cfg.layer_norm_eps, key=key,
        act_dropout=cfg.activation_dropout, out_dropout=cfg.dropout)


def _encoder_block(block, cfg, x, kv_mask, dtype, dropout_rng=None):
    k_attn, k_h1, k_ffn = split_or_none(dropout_rng, 3)
    a, _ = attention(block["self_attn"], x, kv_mask=kv_mask,
                     num_heads=cfg.num_heads, head_dim=cfg.per_head_dim,
                     dtype=dtype, out_proj=False,
                     dropout_rate=cfg.attention_dropout, dropout_rng=k_attn)
    x = layers.dense_residual_ln_apply(
        block["self_attn"]["out_proj"], block["self_attn_layer_norm"], a, x,
        dtype, cfg.layer_norm_eps, key=k_h1, dropout_rate=cfg.dropout)
    return _ffn_block(block, cfg, x, dtype, k_ffn)


def _layer_keys(key, n_layers):
    return [None] * n_layers if key is None else key.split(n_layers)


def init_adapter(generator, device, dtype, dim, bottleneck):
    """Bottleneck adapter: LayerNorm -> dense (dim -> bottleneck) -> ReLU ->
    dense (bottleneck -> dim)."""
    return {"layer_norm": layer_norm_params(dim, device),
            "down": dense_params(generator, device, dtype, dim, bottleneck),
            "up": dense_params(generator, device, dtype, bottleneck, dim)}


def apply_adapter(adapter, x, dtype=torch.float32):
    """The adapter's output, which replaces the block's (no residual), in
    plain PyTorch as the JAX package computes it outside any kernel."""
    h = layers.layer_norm(adapter["layer_norm"], x)
    h = torch.relu(layers.dense(adapter["down"], h, dtype))
    return layers.dense(adapter["up"], h, dtype)


def init_seq2seq_adapters(cfg: Seq2SeqConfig, generator, device,
                          dtype=torch.float32, bottleneck_ratio=0.5):
    """One adapter per text-encoder and per decoder layer:
    {"encoder": [...], "decoder": [...]} (the JAX package stacks each
    side)."""
    bottleneck = int(cfg.hidden_size * bottleneck_ratio)
    return {side: [init_adapter(generator, device, dtype, cfg.hidden_size,
                                bottleneck) for _ in range(n)]
            for side, n in (("encoder", cfg.encoder_layers),
                            ("decoder", cfg.decoder_layers))}


def _side_adapters(adapters, side, n_layers):
    return [None] * n_layers if adapters is None else adapters[side]


def encode(params, cfg: Seq2SeqConfig, input_ids=None, inputs_embeds=None,
           attention_mask=None, output_hidden_states=False,
           dtype=torch.float32, dropout_rng=None, adapters=None):
    """Text encoder over token ids or precomputed embeddings (the SpeechMix
    fusion feeds speech-derived `inputs_embeds`); `adapters` replace each
    block's output by its adapter's.  Returns dict(last_hidden_state,
    mask[, hidden_states (L+1, B, T, H)])."""
    _check_supported(cfg)
    check_key(dropout_rng)
    k_emb, k_layers = split_or_none(dropout_rng, 2)
    enc = params["encoder"]
    if inputs_embeds is None:
        inputs_embeds = embed_tokens(params, cfg, input_ids, dtype)
    b, t, _ = inputs_embeds.shape
    device = inputs_embeds.device
    if attention_mask is None:
        attention_mask = torch.ones((b, t), dtype=torch.bool, device=device)
    pos = layers.embed(enc["embed_positions"],
                       torch.arange(t, device=device) + 2, dtype)
    x = layers.layer_norm(enc["layernorm_embedding"], inputs_embeds + pos,
                          cfg.layer_norm_eps)
    x = layers.dropout(x, cfg.dropout, k_emb)
    hidden = [x] if output_hidden_states else None
    n_layers = len(enc["layers"])
    for block, key, adapter in zip(
            enc["layers"], _layer_keys(k_layers, n_layers),
            _side_adapters(adapters, "encoder", n_layers)):
        x = _encoder_block(block, cfg, x, attention_mask, dtype, key)
        if adapter is not None:
            x = apply_adapter(adapter, x, dtype)
        if hidden is not None:
            hidden.append(x)
    out = {"last_hidden_state": x, "mask": attention_mask}
    if hidden is not None:
        out["hidden_states"] = torch.stack(hidden)
    return out


def _quantize_kv(x):
    """Per-(batch, token, head) symmetric int8 over the head dim.
    x: (B, T, H, D) -> (codes int8, scale float32 (B, T, H))."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    codes = torch.round(xf / scale[..., None]).clamp(-127, 127)
    return codes.to(torch.int8), scale


def precompute_cross_kv(params, cfg: Seq2SeqConfig, enc_hidden,
                        dtype=torch.float32, kv_int8=False):
    """Per-layer cross-attention K and V of the encoder output, once per
    sequence: two (L, B, T_enc, H, D) tensors, or with kv_int8 four: int8
    codes of K and V and their float32 scales (L, B, T_enc, H)."""
    b, t, _ = enc_hidden.shape
    outs = []
    for block in params["decoder"]["layers"]:
        ea = block["encoder_attn"]
        k = layers.dense(ea["k_proj"], enc_hidden, dtype).reshape(
            b, t, cfg.num_heads, cfg.per_head_dim)
        v = layers.dense(ea["v_proj"], enc_hidden, dtype).reshape(
            b, t, cfg.num_heads, cfg.per_head_dim)
        if kv_int8:
            kq, ks = _quantize_kv(k)
            vq, vs = _quantize_kv(v)
            outs.append((kq, vq, ks, vs))
        else:
            outs.append((k, v))
    return tuple(torch.stack(part) for part in zip(*outs))


def init_decoder_cache(params, cfg: Seq2SeqConfig, enc_hidden, batch,
                       capacity, dtype=torch.float32,
                       kv_int8=False) -> DecoderCache:
    """Cross K/V of `enc_hidden` and an empty self-attention cache of `batch`
    rows (a multiple of enc_hidden's rows: see the module docstring)."""
    _check_supported(cfg)
    cross = precompute_cross_kv(params, cfg, enc_hidden, dtype, kv_int8)
    shape = (cfg.decoder_layers, batch, capacity, cfg.num_heads,
             cfg.per_head_dim)
    device = enc_hidden.device
    self_kv = KVCache(torch.zeros(shape, dtype=dtype, device=device),
                      torch.zeros(shape, dtype=dtype, device=device), 0)
    return DecoderCache(self_kv, *cross)


def _cross_attention(attn_params, cfg, x_q, k, v, kv_mask, dtype,
                     k_scale=None, v_scale=None):
    """Cross-attention over precomputed K/V (B_enc, T_enc, H, D), float or
    int8 codes with (B_enc, T_enc, H) scales; returns the concatenated heads
    (the caller owns the out-projection).  A query batch that is a multiple
    of B_enc shares each K/V row among that many contiguous queries (beam
    search); kv_mask is then the untiled (B_enc, T_enc) encoder mask.  A
    single-token step runs K4; a longer chunk takes the plain version."""
    d = cfg.per_head_dim
    scale = 1.0 / math.sqrt(d)
    q = layers.dense(attn_params["q_proj"], x_q, dtype)
    bq, q_len = q.shape[:2]
    q = q.reshape(bq, q_len, cfg.num_heads, d)
    bkv, t_enc = k.shape[:2]
    if bq != bkv:
        if bq % bkv or q_len != 1:
            raise ValueError(f"cross-KV batch {bkv} incompatible with query "
                             f"batch {bq} x q_len {q_len}")
        if kv_mask is not None and kv_mask.shape[0] not in (1, bkv):
            raise ValueError(f"encoder mask batch {kv_mask.shape[0]} != KV "
                             f"batch {bkv}; pass the UNTILED encoder mask "
                             "with a shared-KV cache")
    if kv_mask is None:
        kv_mask = torch.ones((bkv, t_enc), dtype=torch.bool, device=q.device)
    kv_mask = kv_mask.expand(bkv, t_enc).contiguous()
    kwargs = dict(scale=scale, num_heads=cfg.num_heads, k_scale=k_scale,
                  v_scale=v_scale)
    # K4 is the single-token step; a longer chunk is q_len such queries on
    # the same K/V, which the plain formula takes in one pass
    attend = decode_attention if q_len == 1 else decode_attention_plain
    out = attend(q, k, v, kv_mask, **kwargs)
    return out.reshape(bq, q_len, cfg.num_heads * d)


def _decoder_block(block, cfg, x, self_bias, self_kv_mask, layer_cache,
                   cross_k, cross_v, cross_kv_mask, dtype, cross_k_scale=None,
                   cross_v_scale=None, self_causal=False, enc_hidden=None,
                   cross_bias=None, dropout_rng=None):
    """One post-LN decoder block.  Cached: cross-attention over the
    precomputed cross_k / cross_v.  Uncached (layer_cache None): causal
    self-attention and cross-attention over enc_hidden under cross_bias,
    with dropout at HF's placements when dropout_rng is given."""
    k_sattn, k_h1, k_cattn, k_h2, k_ffn = split_or_none(dropout_rng, 5)
    a, new_cache = attention(block["self_attn"], x, bias=self_bias,
                             kv_mask=self_kv_mask, causal=self_causal,
                             num_heads=cfg.num_heads,
                             head_dim=cfg.per_head_dim, cache=layer_cache,
                             dtype=dtype, out_proj=False,
                             dropout_rate=cfg.attention_dropout,
                             dropout_rng=k_sattn)
    x = layers.dense_residual_ln_apply(
        block["self_attn"]["out_proj"], block["self_attn_layer_norm"], a, x,
        dtype, cfg.layer_norm_eps, key=k_h1, dropout_rate=cfg.dropout)
    if enc_hidden is not None:
        a, _ = attention(block["encoder_attn"], x, x_kv=enc_hidden,
                         bias=cross_bias, num_heads=cfg.num_heads,
                         head_dim=cfg.per_head_dim, dtype=dtype,
                         out_proj=False, dropout_rate=cfg.attention_dropout,
                         dropout_rng=k_cattn)
    else:
        a = _cross_attention(block["encoder_attn"], cfg, x, cross_k, cross_v,
                             cross_kv_mask, dtype, cross_k_scale,
                             cross_v_scale)
    x = layers.dense_residual_ln_apply(
        block["encoder_attn"]["out_proj"], block["encoder_attn_layer_norm"],
        a, x, dtype, cfg.layer_norm_eps, key=k_h2, dropout_rate=cfg.dropout)
    return _ffn_block(block, cfg, x, dtype, k_ffn), new_cache


def tied_head_operand(params, cfg: Seq2SeqConfig, dtype=torch.float32):
    """The tied LM head's (V, H) operand for decode(): the embedding rounded
    to `dtype`, and off the card upcast to float32 (torch.mm's out_dtype,
    bfloat16 operands to a float32 result, is a CUDA product), so that a
    generate call rounds and casts the table once and not at every step.
    None for an untied head."""
    if not cfg.tie_word_embeddings:
        return None
    w = params["shared"]["embedding"].to(dtype)
    if w.device.type != "cuda":
        w = w.float()
    return w


def _tied_logits(x, w):
    """x @ w^T in float32, not rounded to x's dtype: the operands as given
    (x in the compute dtype, w the embedding rounded to it or that rounding
    upcast), their products exact and the sums in f32, as the JAX package's
    jnp.dot(h, w.T, preferred_element_type=jnp.float32)."""
    if w.dtype == torch.float32:
        return F.linear(x.float(), w)
    if x.device.type == "cuda" and not (torch.is_grad_enabled() and (
            x.requires_grad or w.requires_grad)):
        y = torch.mm(x.reshape(-1, x.shape[-1]), w.t(),
                     out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[0])
    return F.linear(x.float(), w.float())


def decode(params, cfg: Seq2SeqConfig, decoder_input_ids, encoder_mask=None,
           cache: Optional[DecoderCache] = None, dtype=torch.float32,
           enc_hidden=None, decoder_mask=None, dropout_rng=None,
           lm_head=None, adapters=None, output_hidden_states=False):
    """Decoder forward.

    With a cache: incremental step; decoder_input_ids (B, q_len) continue at
    position cache.self_kv.index, and the new self K/V are written into the
    cache in place.  Without one: the full teacher-forcing pass over
    enc_hidden (B, T_enc, H) for training, differentiable, causal over
    q_len, with decoder_mask (B, q_len) as the self-attention key mask, and
    with dropout when dropout_rng is given (a cached step ignores it: it is
    inference).  lm_head: the tied head's operand from tied_head_operand
    (None: made here).  adapters: each block's output is replaced by its
    adapter's, in both passes.  Returns dict(logits (B, q_len, V) float32,
    cache (None when uncached)[, hidden_states (L+1, B, q_len, H): the
    embedding output, then each block's])."""
    _check_supported(cfg)
    check_key(dropout_rng)
    if cache is None and enc_hidden is None:
        raise ValueError("decode() needs a cache or enc_hidden")
    k_emb, k_layers = split_or_none(
        None if cache is not None else dropout_rng, 2)
    dec = params["decoder"]
    b, q_len = decoder_input_ids.shape
    device = decoder_input_ids.device
    offset = cache.self_kv.index if cache is not None else 0
    x = embed_tokens(params, cfg, decoder_input_ids, dtype)
    pos = layers.embed(dec["embed_positions"],
                       offset + torch.arange(q_len, device=device) + 2, dtype)
    x = layers.layer_norm(dec["layernorm_embedding"], x + pos,
                          cfg.layer_norm_eps)
    x = layers.dropout(x, cfg.dropout, k_emb)
    hidden = [x] if output_hidden_states else None
    n_layers = len(dec["layers"])
    dec_adapters = _side_adapters(adapters, "decoder", n_layers)

    if cache is None:
        # a structured key mask with causal=True keeps K1 / K7 reachable; the
        # encoder's padding mask reaches the cross-attention as a bias
        self_kv_mask = (decoder_mask if decoder_mask is not None else
                        torch.ones((b, q_len), dtype=torch.bool,
                                   device=device))
        cross_bias = (None if encoder_mask is None
                      else combine_masks_to_bias(kv_mask=encoder_mask))
        for block, key, adapter in zip(dec["layers"],
                                       _layer_keys(k_layers, n_layers),
                                       dec_adapters):
            x, _ = _decoder_block(block, cfg, x, None, self_kv_mask, None,
                                  None, None, None, dtype, self_causal=True,
                                  enc_hidden=enc_hidden,
                                  cross_bias=cross_bias, dropout_rng=key)
            if adapter is not None:
                x = apply_adapter(adapter, x, dtype)
            if hidden is not None:
                hidden.append(x)
        new_cache = None
    else:
        capacity = cache.self_kv.key.shape[2]
        self_bias, self_kv_mask = None, None
        if q_len == 1:
            # a single-token step only has to exclude the unfilled slots
            self_kv_mask = (torch.arange(capacity, device=device)[None, :]
                            <= offset).expand(b, capacity).contiguous()
        else:
            self_bias = cache_position_bias(capacity, offset, q_len,
                                            device=device)
        int8_kv = cache.cross_k_scale is not None
        for i, (block, adapter) in enumerate(zip(dec["layers"],
                                                 dec_adapters)):
            layer_cache = KVCache(cache.self_kv.key[i],
                                  cache.self_kv.value[i], offset)
            x, _ = _decoder_block(
                block, cfg, x, self_bias, self_kv_mask, layer_cache,
                cache.cross_k[i], cache.cross_v[i], encoder_mask, dtype,
                cache.cross_k_scale[i] if int8_kv else None,
                cache.cross_v_scale[i] if int8_kv else None)
            if adapter is not None:
                x = apply_adapter(adapter, x, dtype)
            if hidden is not None:
                hidden.append(x)
        new_cache = cache._replace(self_kv=cache.self_kv._replace(
            index=offset + q_len))

    if cfg.tie_word_embeddings:
        if lm_head is None:
            lm_head = params["shared"]["embedding"].to(dtype)
        logits = _tied_logits(x, lm_head)
    else:
        logits = layers.dense(params["lm_head"], x, dtype).float()
    logits = logits + params["final_logits_bias"].float()
    out = {"logits": logits, "cache": new_cache}
    if hidden is not None:
        out["hidden_states"] = torch.stack(hidden)
    return out


def seq2seq_apply(params, cfg: Seq2SeqConfig, input_ids=None,
                  inputs_embeds=None, attention_mask=None,
                  decoder_input_ids=None, decoder_mask=None, labels=None,
                  dtype=torch.float32, dropout_rng=None, encoder_outputs=None,
                  output_hidden_states=False, adapters=None):
    """Full training / evaluation forward: text encoder (skipped when
    `encoder_outputs`, a dict of encode(), is given), teacher-forced
    decoder, and the mean cross-entropy over labels != -100 when labels
    (B, L) are given (decoder inputs then default to the labels shifted
    right); dropout_rng (a DropoutKey) trains with dropout; adapters as in
    encode() and decode().  Returns dict(logits, encoder_last_hidden_state,
    encoder_mask[, encoder_hidden_states, decoder_hidden_states][, loss])."""
    check_key(dropout_rng)
    k_enc, k_dec = split_or_none(dropout_rng, 2)
    if decoder_input_ids is None and labels is not None:
        decoder_input_ids = shift_tokens_right(
            labels, cfg.pad_token_id, cfg.decoder_start_token_id)
    enc = encoder_outputs
    if enc is None:
        enc = encode(params, cfg, input_ids=input_ids,
                     inputs_embeds=inputs_embeds,
                     attention_mask=attention_mask,
                     output_hidden_states=output_hidden_states, dtype=dtype,
                     dropout_rng=k_enc, adapters=adapters)
    dec_out = decode(params, cfg, decoder_input_ids,
                     encoder_mask=enc["mask"], dtype=dtype,
                     enc_hidden=enc["last_hidden_state"],
                     decoder_mask=decoder_mask, dropout_rng=k_dec,
                     adapters=adapters,
                     output_hidden_states=output_hidden_states)
    out = {"logits": dec_out["logits"],
           "encoder_last_hidden_state": enc["last_hidden_state"],
           "encoder_mask": enc["mask"]}
    if output_hidden_states:
        out["encoder_hidden_states"] = enc["hidden_states"]
        out["decoder_hidden_states"] = dec_out["hidden_states"]
    if labels is not None:
        out["loss"] = layers.cross_entropy_with_ignore(dec_out["logits"],
                                                       labels)
    return out


def init_seq2seq(cfg: Seq2SeqConfig, generator, device, dtype=torch.float32):
    """Random BART parameters with the JAX package's structure, drawn from
    `generator`; matrices in `dtype`, vectors in float32."""
    _check_supported(cfg)

    h, inner = cfg.hidden_size, cfg.kv_dim

    def attn():
        p = {name: dense_params(generator, device, dtype, h, inner)
             for name in ("q_proj", "k_proj", "v_proj")}
        p["out_proj"] = dense_params(generator, device, dtype, inner, h)
        return p

    def block(is_decoder):
        p = {"self_attn": attn(),
             "self_attn_layer_norm": layer_norm_params(h, device),
             "final_layer_norm": layer_norm_params(h, device)}
        if is_decoder:
            p["encoder_attn"] = attn()
            p["encoder_attn_layer_norm"] = layer_norm_params(h, device)
        p["fc1"] = dense_params(generator, device, dtype, h, cfg.ffn_dim)
        p["fc2"] = dense_params(generator, device, dtype, cfg.ffn_dim, h)
        return p

    def stack(n_layers, is_decoder):
        return {
            "embed_positions": embedding_params(
                generator, device, dtype, cfg.max_positions + 2, h),
            "layernorm_embedding": layer_norm_params(h, device),
            "layers": [block(is_decoder) for _ in range(n_layers)],
        }

    params = {
        "shared": embedding_params(generator, device, dtype,
                                   cfg.vocab_size, h),
        "encoder": stack(cfg.encoder_layers, False),
        "decoder": stack(cfg.decoder_layers, True),
        "final_logits_bias": torch.zeros(cfg.vocab_size, dtype=torch.float32,
                                         device=device),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense_params(generator, device, dtype, h,
                                         cfg.vocab_size, use_bias=False)
    return params
