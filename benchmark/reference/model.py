"""The plain reference of the SpeechMix model: a wav2vec2-family speech
encoder (post-LN as wav2vec2-base, or pre-LN "stable layer norm" as
XLS-R), a stride-2 length adapter and a projection, then BART (post-LN
encoder and decoder, learned positions at offset 2, tied head plus
final_logits_bias), after the published HF descriptions
(``Wav2Vec2Model``, ``BartForConditionalGeneration``) and SpeechMix's
fusion.  Plain PyTorch in float32; every product goes through a
``Precision`` so that the controls can round its operands.

Training mode (a ``keys.Key``) applies dropout at HF's placements, with
every mask drawn from its site's key (``keys``), SpecAugment's time spans
and LayerDrop's skips (``draws``), and the key chain of each site:

  forward key -> speech, text model, (text pass);
  speech -> projection, positional, layers, SpecAugment; layers -> per
      layer keys, LayerDrop; a layer -> attention, attention output, FFN;
  text model -> encoder, decoder; each -> embedding, layers, final;
      encoder layer -> attention, attention output, FFN; decoder layer ->
      self-attention, its output, cross-attention, its output, FFN.

An FFN's key draws the activation mask on stream 0 and the output mask on
stream 1; an attention output's mask is on stream 1, every other mask on
stream 0.  Mask rows are the leading dimensions of the tensor flattened
(for attention probabilities (b * heads + h) * T_q + q).

Parameters are a nested dict of tensors with the layout of the benchmark's
weights (``benchmark.weights``): dense kernels (in, out), conv kernels
(out, in, k).  ``cfg`` is the configuration file's ``speechmix`` dict.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import draws
from .keys import STREAM_ACT, STREAM_OUT, dropout, mask, split
from .precision import Precision


def _lin(p, x, P):
    y = P.output(P.operand(x) @ P.operand(p["kernel"]))
    return y + p["bias"].float() if "bias" in p else y


def _conv(p, x, stride, P, padding=0, groups=1):
    """x (B, C_in, T) -> (B, C_out, T_out)."""
    y = P.output(F.conv1d(P.operand(x), P.operand(p["kernel"]), None,
                          stride=stride, padding=padding, groups=groups))
    return y + p["bias"].float()[None, :, None] if "bias" in p else y


def _ln(p, x, eps):
    return F.layer_norm(x, (x.shape[-1],), p["scale"].float(),
                        p["bias"].float(), eps)


def _act(name):
    return {"gelu": F.gelu, "relu": F.relu,
            "gelu_new": lambda x: F.gelu(x, approximate="tanh")}[name]


def _lengths_mask(lengths, size):
    pos = torch.arange(size, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def attention(p, xq, xkv, heads, kv_mask, causal, key, rate, P,
              out_proj=True):
    q, k, v = (_lin(p[n], x, P) for n, x in
               (("q_proj", xq), ("k_proj", xkv), ("v_proj", xkv)))
    b, tq, inner = q.shape
    tk = k.shape[1]
    d = inner // heads
    q, k, v = (t.reshape(b, -1, heads, d).transpose(1, 2) for t in (q, k, v))
    s = P.output(P.operand(q) @ P.operand(k).transpose(-1, -2)) / math.sqrt(d)
    allowed = kv_mask[:, None, None, :]
    if causal:
        allowed = allowed & torch.ones((tq, tk), dtype=torch.bool,
                                       device=s.device).tril()
    a = torch.softmax(s.masked_fill(~allowed, float("-inf")), dim=-1)
    if key is not None and rate > 0.0:
        a = a * mask(key, STREAM_ACT, b * heads * tq, tk, rate,
                     a.device).view(b, heads, tq, tk)
    o = P.output(P.operand(a) @ P.operand(v)).transpose(1, 2).reshape(
        b, tq, inner)
    return _lin(p["out_proj"], o, P) if out_proj else o


def _ffn(p_in, p_out, x, act, key, act_rate, P):
    h = dropout(_act(act)(_lin(p_in, x, P)), act_rate, key, STREAM_ACT)
    return _lin(p_out, h, P)


# ---------------------------------------------------------------------------
# speech encoder
# ---------------------------------------------------------------------------

def feature_lengths(e, lengths):
    for k, s in zip(e["conv_kernels"], e["conv_strides"]):
        lengths = (lengths - k) // s + 1
    return lengths


def _extractor(p, e, wav, lengths, P):
    x = wav.float()[:, None, :]
    l = lengths
    eps = e["layer_norm_eps"]
    for i, layer in enumerate(p["feature_extractor"]["layers"]):
        x = _conv(layer["conv"], x, e["conv_strides"][i], P)
        l = (l - e["conv_kernels"][i]) // e["conv_strides"][i] + 1
        if "norm" in layer:
            if e["feat_extract_norm"] == "group" and i == 0:
                # one group per channel, statistics over the valid frames
                valid = _lengths_mask(l, x.shape[-1])[:, None, :].float()
                n = valid.sum(-1, keepdim=True).clamp_min(1.0)
                mean = (x * valid).sum(-1, keepdim=True) / n
                var = (((x - mean) * valid) ** 2).sum(-1, keepdim=True) / n
                x = ((x - mean) * torch.rsqrt(var + eps)
                     * layer["norm"]["scale"].float()[None, :, None]
                     + layer["norm"]["bias"].float()[None, :, None])
            else:
                x = _ln(layer["norm"], x.transpose(1, 2), eps).transpose(1, 2)
        x = F.gelu(x)
    return x.transpose(1, 2)


def _speech_layer(lp, x, kv_mask, e, key, P):
    k_attn, k_h1, k_ffn = split(key, 3)
    eps = e["layer_norm_eps"]
    heads = e["num_heads"]
    if e["do_stable_layer_norm"]:
        h = _ln(lp["attention_layer_norm"], x, eps)
        a = attention(lp["attention"], h, h, heads, kv_mask, False, k_attn,
                      e["attention_dropout"], P)
        x = x + dropout(a, e["dropout"], k_h1, STREAM_OUT)
        h = _ln(lp["final_layer_norm"], x, eps)
        f = _ffn(lp["ffn_in"], lp["ffn_out"], h, e["activation"], k_ffn,
                 e["activation_dropout"], P)
        return x + dropout(f, e["dropout"], k_ffn, STREAM_OUT)
    a = attention(lp["attention"], x, x, heads, kv_mask, False, k_attn,
                  e["attention_dropout"], P, out_proj=False)
    a = _lin(lp["attention"]["out_proj"], a, P)
    x = _ln(lp["attention_layer_norm"],
            x + dropout(a, e["dropout"], k_h1, STREAM_OUT), eps)
    f = _ffn(lp["ffn_in"], lp["ffn_out"], x, e["activation"], k_ffn,
             e["activation_dropout"], P)
    return _ln(lp["final_layer_norm"],
               x + dropout(f, e["dropout"], k_ffn, STREAM_OUT), eps)


def _layer(fn, remat, *args):
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def speech_encoder(p, e, wav, lengths, key, P, remat=False):
    """(B, T, H) states, (B,) frame lengths, the skipped layers."""
    eps = e["layer_norm_eps"]
    feats = _extractor(p, e, wav, lengths, P)
    frames = feature_lengths(e, lengths)
    frame_mask = _lengths_mask(frames, feats.shape[1])
    k_proj, k_pos, k_layers, k_spec = split(key, 4)
    h = _ln(p["feature_projection"]["layer_norm"], feats, eps)
    h = _lin(p["feature_projection"]["projection"], h, P)
    h = dropout(h, e["feat_proj_dropout"], k_proj)
    if k_spec is not None and e["apply_spec_augment"]:
        if e["mask_feature_prob"] > 0:
            raise NotImplementedError("feature masking is not in the "
                                      "reference")
        k_time, _ = k_spec.split(2)
        if e["mask_time_prob"] > 0 and "masked_spec_embed" in p:
            tmask = draws.time_mask(k_time, frames, h.shape[1],
                                    e["mask_time_prob"],
                                    e["mask_time_length"],
                                    e["mask_time_min_masks"])
            h = torch.where(tmask[..., None],
                            p["masked_spec_embed"].float(), h)
    h = h * frame_mask[..., None]
    kpos = e["pos_conv_kernel"]
    pos = _conv(p["pos_conv"], h.transpose(1, 2), 1, P, padding=kpos // 2,
                groups=e["pos_conv_groups"]).transpose(1, 2)
    if kpos % 2 == 0:
        pos = pos[:, :-1]
    h = h + F.gelu(pos)
    if not e["do_stable_layer_norm"]:
        h = _ln(p["encoder_layer_norm"], h, eps)
    h = dropout(h, e["dropout"], k_pos)
    n = len(p["layers"])
    layer_keys, skips = [None] * n, [False] * n
    if k_layers is not None:
        k_layers, k_drop = k_layers.split(2)
        layer_keys = k_layers.split(n)
        skips = draws.layer_skips(k_drop, n, e["layerdrop"])
    for lp, k, skip in zip(p["layers"], layer_keys, skips):
        if not skip:
            h = _layer(lambda x, lp=lp, k=k: _speech_layer(
                lp, x, frame_mask, e, k, P), remat, h)
    if e["do_stable_layer_norm"]:
        h = _ln(p["encoder_layer_norm"], h, eps)
    return h, frames, [i for i, s in enumerate(skips) if s]


def encode_speech(params, cfg, wav, lengths, key, P, remat=False):
    """The text encoder's inputs_embeds (B, T', H_text) and mask, and the
    skipped speech layers."""
    h, frames, skipped = speech_encoder(params["speech_encoder"],
                                        cfg["encoder"], wav, lengths, key, P,
                                        remat)
    x = h.transpose(1, 2)
    for conv in params["length_adapter"]:
        x = _conv(conv, x, 2, P)
        frames = frames // 2
    h = _lin(params["enc_to_dec_proj"], x.transpose(1, 2), P)
    m = _lengths_mask(frames, h.shape[1])
    return h * m[..., None], m, skipped


# ---------------------------------------------------------------------------
# BART
# ---------------------------------------------------------------------------

def _ffn_block(lp, x, d, key, P):
    f = _ffn(lp["fc1"], lp["fc2"], x, d["activation"], key,
             d["activation_dropout"], P)
    return _ln(lp["final_layer_norm"],
               x + dropout(f, d["dropout"], key, STREAM_OUT),
               d["layer_norm_eps"])


def _attn_out(attn_p, ln_p, a, x, d, key, P):
    a = _lin(attn_p["out_proj"], a, P)
    return _ln(ln_p, x + dropout(a, d["dropout"], key, STREAM_OUT),
               d["layer_norm_eps"])


def _encoder_block(lp, x, m, d, key, P):
    k_attn, k_h1, k_ffn = split(key, 3)
    a = attention(lp["self_attn"], x, x, d["num_heads"], m, False, k_attn,
                  d["attention_dropout"], P, out_proj=False)
    x = _attn_out(lp["self_attn"], lp["self_attn_layer_norm"], a, x, d,
                  k_h1, P)
    return _ffn_block(lp, x, d, k_ffn, P)


def _decoder_block(lp, x, enc, enc_mask, d, key, P):
    k_sattn, k_h1, k_cattn, k_h2, k_ffn = split(key, 5)
    ones = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
    a = attention(lp["self_attn"], x, x, d["num_heads"], ones, True, k_sattn,
                  d["attention_dropout"], P, out_proj=False)
    x = _attn_out(lp["self_attn"], lp["self_attn_layer_norm"], a, x, d,
                  k_h1, P)
    c = attention(lp["encoder_attn"], x, enc, d["num_heads"], enc_mask,
                  False, k_cattn, d["attention_dropout"], P, out_proj=False)
    x = _attn_out(lp["encoder_attn"], lp["encoder_attn_layer_norm"], c, x,
                  d, k_h2, P)
    return _ffn_block(lp, x, d, k_ffn, P)


def _embed(stack, x, offset, d, key):
    pos = stack["embed_positions"]["embedding"][
        torch.arange(x.shape[1], device=x.device) + offset + 2].float()
    x = _ln(stack["layernorm_embedding"], x + pos, d["layer_norm_eps"])
    return dropout(x, d["dropout"], key)


def text_encoder(p, d, x, m, key, P, remat=False):
    k_emb, k_layers, _ = split(key, 3)
    enc = p["encoder"]
    x = _embed(enc, x, 0, d, k_emb)
    keys = split(k_layers, len(enc["layers"]))
    for lp, k in zip(enc["layers"], keys):
        x = _layer(lambda x, lp=lp, k=k: _encoder_block(lp, x, m, d, k, P),
                   remat, x)
    return x


def text_decoder(p, d, ids, enc, enc_mask, key, P, remat=False):
    """Teacher-forced decoder over ids (B, L): (B, L, V) float32 logits."""
    k_emb, k_layers, _ = split(key, 3)
    dec = p["decoder"]
    x = p["shared"]["embedding"][ids].float()
    if d["scale_embedding"]:
        x = x * d["hidden_size"] ** 0.5
    x = _embed(dec, x, 0, d, k_emb)
    keys = split(k_layers, len(dec["layers"]))
    for lp, k in zip(dec["layers"], keys):
        x = _layer(lambda x, lp=lp, k=k: _decoder_block(
            lp, x, enc, enc_mask, d, k, P), remat, x)
    logits = P.output(P.operand(x) @ P.operand(p["shared"]["embedding"]).t())
    return logits + p["final_logits_bias"].float()


def shift_right(labels, d):
    ids = torch.empty_like(labels)
    ids[:, 1:] = labels[:, :-1]
    ids[:, 0] = d["decoder_start_token_id"]
    return torch.where(ids == -100, d["pad_token_id"], ids)


def cross_entropy(logits, labels):
    valid = labels != -100
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.where(valid, labels, 0)[..., None]).squeeze(-1)
    return ((logz - gold) * valid).sum() / valid.sum().clamp_min(1)


def forward_loss(params, cfg, wav, lengths, labels, key, P=None,
                 remat=True):
    """The training loss of one batch (mean token cross-entropy) and the
    skipped speech layers."""
    P = P or Precision()
    d = cfg["decoder"]
    k_speech, k_nlp, _ = split(key, 3)
    emb, m, skipped = encode_speech(params, cfg, wav, lengths, k_speech, P,
                                    remat)
    k_enc, k_dec = split(k_nlp, 2)
    enc = text_encoder(params["nlp"], d, emb, m, k_enc, P, remat)
    logits = text_decoder(params["nlp"], d, shift_right(labels, d), enc, m,
                          k_dec, P, remat)
    return cross_entropy(logits, labels), skipped


@torch.no_grad()
def served_logits(params, cfg, wav, lengths, tokens, P=None):
    """The logits (B, L, V) of the full decoder forward over decoder inputs
    [start] + tokens[:, :-1], from the speech and text encoders in
    inference mode: what a greedy decode of L steps reads at each step."""
    P = P or Precision()
    d = cfg["decoder"]
    emb, m, _ = encode_speech(params, cfg, wav, lengths, None, P)
    enc = text_encoder(params["nlp"], d, emb, m, None, P)
    ids = torch.cat([torch.full_like(tokens[:, :1],
                                     d["decoder_start_token_id"]),
                     tokens[:, :-1]], dim=1)
    return text_decoder(params["nlp"], d, ids, enc, m, None, P)
