"""BART / T5-family seq2seq LM (port of ``speechmix_tpu.models.seq2seq``).

The text encoder (``encode``), the decoder (``decode``: cached single steps
over ``precompute_cross_kv`` / ``init_decoder_cache`` for generation, or the
uncached teacher-forcing pass for training) and the training forward
``seq2seq_apply``.  ``cfg.arch`` picks the graph, as in the JAX package:

  bart: learned positions (offset +2), layernorm_embedding, post-LN blocks,
        attention scaled by 1/sqrt(d), tied head + final_logits_bias;
  t5:   relative position buckets (each stack's layer-0 ``rel_bias`` table
        shared by its layers), RMS-norm pre-LN blocks, unscaled attention,
        no biases, a final RMS norm per stack, the tied head on x scaled by
        hidden_size ** -0.5 (or an untied ``lm_head``), and a relu or gated
        GELU FFN.

With a ``dropout_rng`` (a DropoutKey; uncached passes only) they train with
dropout at HF's placements: the embeddings, the attention probabilities,
each attention output and the FFN's activation and output, and for T5 the
output of each stack's final norm.  Layers are lists of parameter dicts.
With ``adapters`` (the ``adapter`` variant's bottleneck adapters, lists per
side) the encoder and the decoder replace each block's output by its
adapter's.

Cache layout: self K/V (L, B, capacity, H, D), written in place by each
step; cross K/V (L, B_enc, T_enc, H, D), in the compute dtype or, with
``kv_int8``, as int8 codes with float32 scales (L, B_enc, T_enc, H).  (The
JAX package stores cross K/V batch-minor, (L, T_enc, H, D, B), for the
TPU's sake.)  B may be a multiple of B_enc: beam search keeps one cross K/V
per input and the beams of an input, contiguous in the batch, share it.
A T5 cache also holds its self-attention bias over the whole capacity, the
causal cache mask plus the decoder's position bias, (1, H, capacity,
capacity) float32, made once; step ``offset`` reads row ``offset``.

Single-token cached steps run kernel K4 (``ops.kernels.decode_attention``)
for the cross-attention, and for BART's self-attention; T5's self-attention
carries the position bias and takes the plain path, as in the JAX package.
BART's uncached causal self-attention and every BART encoder layer run K1 /
K7, and their post-LN epilogues K2 / K3; T5's text stacks carry the position
bias and attend on the plain path, and their relu FFN is the fused K9 / K8
(``layers.ffn_apply``) where the JAX package's gate admits it.  The uncached
cross-attention carries the encoder's padding mask as a bias and takes the
plain path.

Under tensor parallelism (``parallel.mesh.tp_sharding``) a block whose
heads divide by n_model runs this rank's heads (``attention``), its
out-projections row-parallel; an FFN whose width divides runs this rank's
columns of fc1 / fc_gate and rows of fc2; the caches hold the local heads'
K / V and T5's position bias is sliced to them; the tied head and the norms
stay replicated.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..config import Seq2SeqConfig
from ..ops import layers
from ..ops.attention import KVCache, attention, cache_position_bias
from ..ops.kernels.dropout import STREAM_OUT, check_key, split_or_none
from ..ops.masking import combine_masks_to_bias
from ..ops.kernels.decode_attention import (decode_attention,
                                            decode_attention_plain)
from ..parallel import collectives
from ..parallel import mesh as mesh_lib
from .init import (dense_params, embedding_params, layer_norm_params,
                   rms_norm_params)


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
    # T5: the self-attention bias of every step, (1, H, capacity, capacity)
    # float32, row q that of the query at position q
    self_bias: Optional[torch.Tensor] = None


# ----------------------------------------------------------------------------
# T5 relative position bias
# ----------------------------------------------------------------------------

def _t5_relative_bucket(rel_pos, bidirectional, num_buckets, max_distance):
    """T5's bucket of each relative position (key - query), integer tensor
    in, the same shape out: the JAX package's arithmetic, the log term in
    float32 and truncated toward 0."""
    ret = torch.zeros_like(rel_pos)
    n = -rel_pos
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(rel_pos.dtype) * num_buckets
        n = n.abs()
    else:
        n = n.clamp_min(0)
    max_exact = num_buckets // 2
    log_range = torch.log(torch.tensor(max_distance / max_exact,
                                       dtype=torch.float32))
    val_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6) / log_range.to(n.device)
        * (num_buckets - max_exact)).to(torch.int32).to(rel_pos.dtype)
    val_large = val_large.clamp_max(num_buckets - 1)
    return ret + torch.where(n < max_exact, n, val_large)


def t5_position_bias(rel_bias_params, q_len, kv_len, bidirectional, cfg,
                     q_offset=0, device=None):
    """(1, H, q_len, kv_len) float32 additive bias from a stack's layer-0
    relative-attention table (num_buckets, H); query i sits at position
    q_offset + i."""
    table = rel_bias_params["embedding"]
    device = device or table.device
    ctx = torch.arange(q_len, device=device)[:, None] + q_offset
    mem = torch.arange(kv_len, device=device)[None, :]
    buckets = _t5_relative_bucket(mem - ctx, bidirectional,
                                  cfg.relative_attention_num_buckets,
                                  cfg.relative_attention_max_distance)
    return table.float().to(device)[buckets].permute(2, 0, 1)[None]


def embed_tokens(params, cfg: Seq2SeqConfig, input_ids, dtype=torch.float32):
    x = layers.embed(params["shared"], input_ids, dtype)
    if cfg.scale_embedding:
        x = x * cfg.hidden_size ** 0.5
    return x


def _heads_split(cfg) -> bool:
    """Whether the active mesh splits this config's attention heads."""
    return mesh_lib.tp_split(cfg.num_heads) > 1


def _local_heads(cfg) -> int:
    return cfg.num_heads // mesh_lib.tp_split(cfg.num_heads)


def _attn_scale(cfg):
    """The attention scale: 1 for T5 (the 1/sqrt(d) is folded into its
    initialisation), 1/sqrt(d) for BART."""
    return 1.0 if cfg.arch == "t5" else 1.0 / math.sqrt(cfg.per_head_dim)


def _ffn(block, cfg, x, dtype, key):
    """The FFN without its residual: the gated GELU gelu_tanh(x w_gate) *
    (x w1) in plain PyTorch, as the JAX package computes it outside any
    kernel, or the ungated FFN through layers.ffn_apply (K9 / K13 forward,
    K8 backward, where the gate admits it); the activation mask of (key,
    STREAM_ACT)."""
    rate = cfg.activation_dropout
    tp = mesh_lib.tp_split(cfg.ffn_dim) > 1
    if cfg.activation == "gelu_gated":
        if tp:
            x = collectives.copy_to_model(x, mesh_lib.active_tp_mesh())
            key = mesh_lib.fold_key(key, mesh_lib.MODEL_AXIS)
        g = F.gelu(layers.dense(block["fc_gate"], x, dtype),
                   approximate="tanh")
        h = layers.dropout(g * layers.dense(block["fc1"], x, dtype), rate,
                           key)
        return layers.dense(block["fc2"], h, dtype, row_parallel=tp)
    return layers.ffn_apply(block["fc1"], block["fc2"], x, cfg.activation,
                            dtype, key, rate, tp=tp)


def _ffn_block(block, cfg, x, dtype, key):
    """The post-LN FFN block with its two dropout sites: K3 / K12, or for a
    gated FFN LN(x + drop(FFN(x))) in plain PyTorch, as JAX computes it."""
    if cfg.activation == "gelu_gated":
        f = layers.dropout(_ffn(block, cfg, x, dtype, key), cfg.dropout, key,
                           STREAM_OUT)
        return layers.layer_norm(block["final_layer_norm"], x + f,
                                 cfg.layer_norm_eps)
    return layers.ffn_residual_ln_apply(
        block["fc1"], block["fc2"], block["final_layer_norm"], x,
        cfg.activation, dtype, cfg.layer_norm_eps, key=key,
        act_dropout=cfg.activation_dropout, out_dropout=cfg.dropout,
        tp=mesh_lib.tp_split(cfg.ffn_dim) > 1)


def _t5_residual(x, y, cfg, key):
    """x + dropout(y), the mask of (key, STREAM_OUT)."""
    return x + layers.dropout(y, cfg.dropout, key, STREAM_OUT)


def _t5_ffn_residual(block, cfg, x, dtype, key):
    """The pre-LN FFN sub-block: x + drop(FFN(rms_norm(x))), both masks of
    `key` (STREAM_ACT inside, STREAM_OUT on the output), as the post-LN
    block keys its two sites."""
    h = layers.rms_norm(block["final_layer_norm"], x, cfg.layer_norm_eps)
    return _t5_residual(x, _ffn(block, cfg, h, dtype, key), cfg, key)


def _encoder_block(block, cfg, x, kv_mask, dtype, dropout_rng=None,
                   bias=None):
    """One encoder block: BART's post-LN block (K1, K2, K3), or T5's pre-LN
    block, whose self-attention carries the position bias `bias` and so
    takes the plain path."""
    k_attn, k_h1, k_ffn = split_or_none(dropout_rng, 3)
    attn = dict(kv_mask=kv_mask, num_heads=cfg.num_heads,
                head_dim=cfg.per_head_dim, scale=_attn_scale(cfg),
                dtype=dtype, dropout_rate=cfg.attention_dropout,
                dropout_rng=k_attn)
    if cfg.arch == "t5":
        h = layers.rms_norm(block["self_attn_layer_norm"], x,
                            cfg.layer_norm_eps)
        a, _ = attention(block["self_attn"], h, bias=bias, **attn)
        x = _t5_residual(x, a, cfg, k_h1)
        return _t5_ffn_residual(block, cfg, x, dtype, k_ffn)
    a, _ = attention(block["self_attn"], x, out_proj=False, **attn)
    x = layers.dense_residual_ln_apply(
        block["self_attn"]["out_proj"], block["self_attn_layer_norm"], a, x,
        dtype, cfg.layer_norm_eps, key=k_h1, dropout_rate=cfg.dropout,
        row_parallel=_heads_split(cfg))
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


def _final_norm(stack, cfg, x, key, hidden):
    """T5's end of a stack: the final RMS norm and dropout; the last entry
    of `hidden` (if kept) becomes that state, HF T5Stack's convention."""
    x = layers.dropout(layers.rms_norm(stack["final_layer_norm"], x,
                                       cfg.layer_norm_eps), cfg.dropout, key)
    if hidden is not None:
        hidden[-1] = x
    return x


def encode(params, cfg: Seq2SeqConfig, input_ids=None, inputs_embeds=None,
           attention_mask=None, output_hidden_states=False,
           dtype=torch.float32, dropout_rng=None, adapters=None):
    """Text encoder over token ids or precomputed embeddings (the SpeechMix
    fusion feeds speech-derived `inputs_embeds`); `adapters` replace each
    block's output by its adapter's.  Returns dict(last_hidden_state,
    mask[, hidden_states (L+1, B, T, H)]): the embedding output, then each
    block's, for T5 the last one after the final norm and dropout."""
    check_key(dropout_rng)
    k_emb, k_layers, k_final = split_or_none(dropout_rng, 3)
    enc = params["encoder"]
    if inputs_embeds is None:
        inputs_embeds = embed_tokens(params, cfg, input_ids, dtype)
    b, t, _ = inputs_embeds.shape
    device = inputs_embeds.device
    if attention_mask is None:
        attention_mask = torch.ones((b, t), dtype=torch.bool, device=device)
    x, bias = inputs_embeds, None
    if cfg.arch == "t5":
        # the position bias of every layer, computed once
        bias = t5_position_bias(enc["rel_bias"], t, t, True, cfg,
                                device=device)
    else:
        pos = layers.embed(enc["embed_positions"],
                           torch.arange(t, device=device) + 2, dtype)
        x = layers.layer_norm(enc["layernorm_embedding"], x + pos,
                              cfg.layer_norm_eps)
    x = layers.dropout(x, cfg.dropout, k_emb)
    hidden = [x] if output_hidden_states else None
    n_layers = len(enc["layers"])
    for block, key, adapter in zip(
            enc["layers"], _layer_keys(k_layers, n_layers),
            _side_adapters(adapters, "encoder", n_layers)):
        x = layers.remat(cfg.remat, _encoder_block, block, cfg, x,
                         attention_mask, dtype, key, bias)
        if adapter is not None:
            x = apply_adapter(adapter, x, dtype)
        if hidden is not None:
            hidden.append(x)
    if cfg.arch == "t5":
        x = _final_norm(enc, cfg, x, k_final, hidden)
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
    heads = _local_heads(cfg)
    outs = []
    for block in params["decoder"]["layers"]:
        ea = block["encoder_attn"]
        k = layers.dense(ea["k_proj"], enc_hidden, dtype).reshape(
            b, t, heads, cfg.per_head_dim)
        v = layers.dense(ea["v_proj"], enc_hidden, dtype).reshape(
            b, t, heads, cfg.per_head_dim)
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
    rows (a multiple of enc_hidden's rows: see the module docstring); for T5
    also the self-attention bias of every step (the causal cache mask plus
    the decoder's position bias, as the JAX package adds them per step)."""
    cross = precompute_cross_kv(params, cfg, enc_hidden, dtype, kv_int8)
    shape = (cfg.decoder_layers, batch, capacity, _local_heads(cfg),
             cfg.per_head_dim)
    device = enc_hidden.device
    self_kv = KVCache(torch.zeros(shape, dtype=dtype, device=device),
                      torch.zeros(shape, dtype=dtype, device=device), 0)
    self_bias = None
    if cfg.arch == "t5":
        self_bias = (cache_position_bias(capacity, 0, capacity, device=device)
                     + t5_position_bias(params["decoder"]["rel_bias"],
                                        capacity, capacity, False, cfg,
                                        device=device))
    return DecoderCache(self_kv, *cross, self_bias=self_bias)


def _cross_attention(attn_params, cfg, x_q, k, v, kv_mask, dtype,
                     k_scale=None, v_scale=None):
    """Cross-attention over precomputed K/V (B_enc, T_enc, H, D), float or
    int8 codes with (B_enc, T_enc, H) scales; returns the concatenated heads
    (the caller owns the out-projection).  A query batch that is a multiple
    of B_enc shares each K/V row among that many contiguous queries (beam
    search); kv_mask is then the untiled (B_enc, T_enc) encoder mask.  A
    single-token step runs K4; a longer chunk takes the plain version."""
    d = cfg.per_head_dim
    heads = _local_heads(cfg)
    q = layers.dense(attn_params["q_proj"], x_q, dtype)
    bq, q_len = q.shape[:2]
    q = q.reshape(bq, q_len, heads, d)
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
    kwargs = dict(scale=_attn_scale(cfg), num_heads=heads,
                  k_scale=k_scale, v_scale=v_scale)
    # K4 is the single-token step; a longer chunk is q_len such queries on
    # the same K/V, which the plain formula takes in one pass
    attend = decode_attention if q_len == 1 else decode_attention_plain
    out = attend(q, k, v, kv_mask, **kwargs)
    return out.reshape(bq, q_len, heads * d)


def _decoder_block(block, cfg, x, self_bias, self_kv_mask, layer_cache,
                   cross_k, cross_v, cross_kv_mask, dtype, cross_k_scale=None,
                   cross_v_scale=None, self_causal=False, enc_hidden=None,
                   cross_bias=None, dropout_rng=None):
    """One decoder block, BART's post-LN or T5's pre-LN.  Cached:
    cross-attention over the precomputed cross_k / cross_v.  Uncached
    (layer_cache None): causal self-attention and cross-attention over
    enc_hidden under cross_bias, with dropout at HF's placements when
    dropout_rng is given."""
    k_sattn, k_h1, k_cattn, k_h2, k_ffn = split_or_none(dropout_rng, 5)
    attn = dict(num_heads=cfg.num_heads, head_dim=cfg.per_head_dim,
                scale=_attn_scale(cfg), dtype=dtype,
                dropout_rate=cfg.attention_dropout)
    self_attn = dict(bias=self_bias, kv_mask=self_kv_mask,
                     causal=self_causal, cache=layer_cache,
                     dropout_rng=k_sattn, **attn)

    def cross(y):
        """The cross-attention's concatenated heads, before out_proj."""
        if enc_hidden is not None:
            return attention(block["encoder_attn"], y, x_kv=enc_hidden,
                             bias=cross_bias, out_proj=False,
                             dropout_rng=k_cattn, **attn)[0]
        return _cross_attention(block["encoder_attn"], cfg, y, cross_k,
                                cross_v, cross_kv_mask, dtype, cross_k_scale,
                                cross_v_scale)

    if cfg.arch == "t5":  # pre-LN, RMS norms, plain out-projections
        h = layers.rms_norm(block["self_attn_layer_norm"], x,
                            cfg.layer_norm_eps)
        a, new_cache = attention(block["self_attn"], h, **self_attn)
        x = _t5_residual(x, a, cfg, k_h1)
        h = layers.rms_norm(block["encoder_attn_layer_norm"], x,
                            cfg.layer_norm_eps)
        a = layers.dense(block["encoder_attn"]["out_proj"], cross(h), dtype,
                         row_parallel=_heads_split(cfg))
        x = _t5_residual(x, a, cfg, k_h2)
        return _t5_ffn_residual(block, cfg, x, dtype, k_ffn), new_cache
    a, new_cache = attention(block["self_attn"], x, out_proj=False,
                             **self_attn)
    split = _heads_split(cfg)
    x = layers.dense_residual_ln_apply(
        block["self_attn"]["out_proj"], block["self_attn_layer_norm"], a, x,
        dtype, cfg.layer_norm_eps, key=k_h1, dropout_rate=cfg.dropout,
        row_parallel=split)
    x = layers.dense_residual_ln_apply(
        block["encoder_attn"]["out_proj"], block["encoder_attn_layer_norm"],
        cross(x), x, dtype, cfg.layer_norm_eps, key=k_h2,
        dropout_rate=cfg.dropout, row_parallel=split)
    return _ffn_block(block, cfg, x, dtype, k_ffn), new_cache


def tied_head_operand(params, cfg: Seq2SeqConfig, dtype=torch.float32):
    """The tied LM head's (V, H) operand for decode(): the embedding rounded
    to `dtype` (an int8 table: its codes, exact in `dtype`; _lm_logits
    applies the per-row scales to the f32 logits), and off the card upcast
    to float32 (torch.mm's out_dtype, bfloat16 operands to a float32 result,
    is a CUDA product), so that a generate call rounds and casts the table
    once and not at every step.  None for an untied head."""
    if not cfg.tie_word_embeddings:
        return None
    shared = params["shared"]
    w = shared.get("embedding_q", shared.get("embedding")).to(dtype)
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


def _lm_logits(params, cfg: Seq2SeqConfig, x, dtype, lm_head=None):
    """The LM head on the decoder's last states x: (..., V) float32.  Tied:
    x (for T5 first multiplied by hidden_size ** -0.5 in x's dtype, the
    factor rounded to it, as the JAX package's weakly typed product) against
    the embedding, lm_head its operand from tied_head_operand (None: made
    here); untied: the `lm_head` dense in `dtype`.  BART adds its
    final_logits_bias.  An int8 table (``embedding_q``) enters the product
    as its codes in `dtype`, and the f32 logits are multiplied by its
    per-row scales, as the JAX package's int8 head."""
    if cfg.tie_word_embeddings:
        shared = params["shared"]
        if lm_head is None:
            lm_head = shared.get("embedding_q",
                                 shared.get("embedding")).to(dtype)
        if cfg.arch == "t5":
            x = x * torch.tensor(cfg.hidden_size ** -0.5, dtype=x.dtype)
        logits = _tied_logits(x, lm_head)
        if "embedding_q" in shared:
            logits = logits * shared["embedding_scale"].float()
    else:
        logits = layers.dense(params["lm_head"], x, dtype).float()
    if cfg.arch == "bart":
        logits = logits + params["final_logits_bias"].float()
    return logits


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
    embedding output, then each block's, for T5 the last one after the
    final norm and dropout])."""
    check_key(dropout_rng)
    if cache is None and enc_hidden is None:
        raise ValueError("decode() needs a cache or enc_hidden")
    k_emb, k_layers, k_final = split_or_none(
        None if cache is not None else dropout_rng, 3)
    dec = params["decoder"]
    t5 = cfg.arch == "t5"
    b, q_len = decoder_input_ids.shape
    device = decoder_input_ids.device
    offset = cache.self_kv.index if cache is not None else 0
    x = embed_tokens(params, cfg, decoder_input_ids, dtype)
    if not t5:
        pos = layers.embed(dec["embed_positions"],
                           offset + torch.arange(q_len, device=device) + 2,
                           dtype)
        x = layers.layer_norm(dec["layernorm_embedding"], x + pos,
                              cfg.layer_norm_eps)
    x = layers.dropout(x, cfg.dropout, k_emb)
    hidden = [x] if output_hidden_states else None
    n_layers = len(dec["layers"])
    dec_adapters = _side_adapters(adapters, "decoder", n_layers)

    if cache is None:
        # a structured key mask with causal=True keeps K1 / K7 reachable for
        # BART (T5 adds its position bias and attends on the plain path);
        # the encoder's padding mask reaches the cross-attention as a bias
        self_kv_mask = (decoder_mask if decoder_mask is not None else
                        torch.ones((b, q_len), dtype=torch.bool,
                                   device=device))
        self_bias = (t5_position_bias(dec["rel_bias"], q_len, q_len, False,
                                      cfg, device=device) if t5 else None)
        cross_bias = (None if encoder_mask is None
                      else combine_masks_to_bias(kv_mask=encoder_mask))
        for block, key, adapter in zip(dec["layers"],
                                       _layer_keys(k_layers, n_layers),
                                       dec_adapters):
            x, _ = layers.remat(
                cfg.remat, _decoder_block, block, cfg, x, self_bias,
                self_kv_mask, None, None, None, None, dtype,
                self_causal=True, enc_hidden=enc_hidden,
                cross_bias=cross_bias, dropout_rng=key)
            if adapter is not None:
                x = apply_adapter(adapter, x, dtype)
            if hidden is not None:
                hidden.append(x)
        new_cache = None
    else:
        capacity = cache.self_kv.key.shape[2]
        self_bias, self_kv_mask = None, None
        if t5:
            # the causal cache mask plus the position bias, rows of the
            # table init_decoder_cache made: no per-step bias arithmetic
            self_bias = cache.self_bias[:, :, offset:offset + q_len]
        elif q_len == 1:
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

    if t5:
        x = _final_norm(dec, cfg, x, k_final, hidden)
    out = {"logits": _lm_logits(params, cfg, x, dtype, lm_head),
           "cache": new_cache}
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
    """Random BART or T5 parameters with the JAX package's structure, drawn
    from `generator`; matrices in `dtype`, vectors in float32.  T5 has no
    biases, RMS-norm scales in place of the LayerNorms, a ``rel_bias``
    table (num_buckets, H) and a ``final_layer_norm`` per stack, ``fc_gate``
    for the gated GELU, and no positions, ``layernorm_embedding`` or
    ``final_logits_bias``."""
    h, inner = cfg.hidden_size, cfg.kv_dim
    t5 = cfg.arch == "t5"
    bias = not t5
    norm = ((lambda: rms_norm_params(h, device)) if t5
            else (lambda: layer_norm_params(h, device)))

    def dense(din, dout):
        return dense_params(generator, device, dtype, din, dout,
                            use_bias=bias)

    def attn():
        p = {name: dense(h, inner) for name in ("q_proj", "k_proj", "v_proj")}
        p["out_proj"] = dense(inner, h)
        return p

    def block(is_decoder):
        p = {"self_attn": attn(), "self_attn_layer_norm": norm(),
             "final_layer_norm": norm()}
        if is_decoder:
            p["encoder_attn"] = attn()
            p["encoder_attn_layer_norm"] = norm()
        if cfg.activation == "gelu_gated":
            p["fc_gate"] = dense(h, cfg.ffn_dim)
        p["fc1"] = dense(h, cfg.ffn_dim)
        p["fc2"] = dense(cfg.ffn_dim, h)
        return p

    def stack(n_layers, is_decoder):
        if t5:
            top = {"rel_bias": embedding_params(
                generator, device, dtype,
                cfg.relative_attention_num_buckets, cfg.num_heads, std=0.1),
                "final_layer_norm": norm()}
        else:
            top = {"embed_positions": embedding_params(
                generator, device, dtype, cfg.max_positions + 2, h),
                "layernorm_embedding": norm()}
        return {**top, "layers": [block(is_decoder) for _ in range(n_layers)]}

    params = {
        "shared": embedding_params(generator, device, dtype,
                                   cfg.vocab_size, h),
        "encoder": stack(cfg.encoder_layers, False),
        "decoder": stack(cfg.decoder_layers, True),
    }
    if not t5:
        params["final_logits_bias"] = torch.zeros(
            cfg.vocab_size, dtype=torch.float32, device=device)
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense_params(generator, device, dtype, h,
                                         cfg.vocab_size, use_bias=False)
    return params
