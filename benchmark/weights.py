"""Random weights of a configuration, made on the device from a seed.

The tree has the layout the port's models read (and the JAX package's
structure): dense kernels (in, out) drawn N(0, 0.02), conv kernels
(out, in, k) drawn N(0, 1 / (in * k)), embeddings N(0, 0.02), biases
N(0, 0.02), LayerNorm scales 1 + N(0, 0.1) and shifts N(0, 0.02),
wav2vec2's masked_spec_embed U[0, 1).  No leaf starts at 0 or 1, so the
check sees every bias add and LayerNorm affine term of the forward (the
recipe's first steps barely move them).  Every normal draw of a tree comes
from one ``torch.randn`` call on the device's generator, cut into the
leaves; the uniform one from one ``torch.rand``.
The same seed gives the same tree.  All leaves are float32 (the master
weights of training and the f32 transcription path).
"""

from __future__ import annotations

import math

import torch


BIAS_STD = 0.02
LN_SCALE_STD = 0.1


def _bias(n):
    return ("normal", (n,), BIAS_STD)


def _dense(h_in, h_out, bias=True):
    p = {"kernel": ("normal", (h_in, h_out), 0.02)}
    if bias:
        p["bias"] = _bias(h_out)
    return p


def _conv(c_in, c_out, k, bias=True):
    p = {"kernel": ("normal", (c_out, c_in, k), math.sqrt(1.0 / (c_in * k)))}
    if bias:
        p["bias"] = _bias(c_out)
    return p


def _ln(h):
    return {"scale": ("normal", (h,), LN_SCALE_STD, 1.0), "bias": _bias(h)}


def speech_spec(e, n_layers):
    convs, c_in = [], 1
    for i, (dim, k) in enumerate(zip(e["conv_dims"], e["conv_kernels"])):
        layer = {"conv": _conv(c_in, dim, k, e["conv_bias"])}
        if (e["feat_extract_norm"] == "group" and i == 0) or \
                e["feat_extract_norm"] == "layer":
            layer["norm"] = _ln(dim)
        convs.append(layer)
        c_in = dim
    h, f = e["hidden_size"], e["ffn_dim"]
    return {
        "masked_spec_embed": ("uniform", (h,)),
        "feature_extractor": {"layers": convs},
        "feature_projection": {"layer_norm": _ln(e["conv_dims"][-1]),
                               "projection": _dense(e["conv_dims"][-1], h)},
        "pos_conv": _conv(h // e["pos_conv_groups"], h, e["pos_conv_kernel"]),
        "encoder_layer_norm": _ln(h),
        "layers": [{
            "attention": {n: _dense(h, h) for n in
                          ("q_proj", "k_proj", "v_proj", "out_proj")},
            "attention_layer_norm": _ln(h),
            "ffn_in": _dense(h, f),
            "ffn_out": _dense(f, h),
            "final_layer_norm": _ln(h),
        } for _ in range(n_layers)],
    }


def bart_spec(d):
    h, f = d["hidden_size"], d["ffn_dim"]

    def attn():
        return {n: _dense(h, h) for n in ("q_proj", "k_proj", "v_proj",
                                          "out_proj")}

    def block(decoder):
        p = {"self_attn": attn(), "self_attn_layer_norm": _ln(h),
             "final_layer_norm": _ln(h)}
        if decoder:
            p["encoder_attn"] = attn()
            p["encoder_attn_layer_norm"] = _ln(h)
        p["fc1"] = _dense(h, f)
        p["fc2"] = _dense(f, h)
        return p

    def stack(n, decoder):
        return {"embed_positions": {"embedding": (
                    "normal", (d["max_positions"] + 2, h), 0.02)},
                "layernorm_embedding": _ln(h),
                "layers": [block(decoder) for _ in range(n)]}

    return {"shared": {"embedding": ("normal", (d["vocab_size"], h), 0.02)},
            "encoder": stack(d["encoder_layers"], False),
            "decoder": stack(d["decoder_layers"], True),
            "final_logits_bias": _bias(d["vocab_size"])}


def spec(cfg):
    """The tree of (init, shape[, std[, mean]]) leaves of a configuration
    dict."""
    e, d = cfg["encoder"], cfg["decoder"]
    if d.get("arch", "bart") != "bart" or not d.get("tie_word_embeddings",
                                                     True):
        raise NotImplementedError("the benchmark's weights cover BART with "
                                  "a tied head")
    h = e["hidden_size"]
    downloop = int(math.log2(cfg["down_scale"])) if cfg["down_scale"] > 1 \
        else 0
    n_layers = e["num_layers"] - int(e["num_layers"] *
                                     cfg.get("share_layer_ratio", 0.0))
    return {"speech_encoder": speech_spec(e, n_layers),
            "nlp": bart_spec(d),
            "enc_to_dec_proj": _dense(h, d["hidden_size"]),
            "length_adapter": [_conv(h, h, 2) for _ in range(downloop)]}


def _leaves(tree, out):
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, list):
        for v in tree:
            _leaves(v, out)
    else:
        out.append(tree)
    return out


def _numel(shape):
    return math.prod(shape)


def make(cfg, seed, device):
    """The weights of `cfg` from `seed` on `device`."""
    tree = spec(cfg)
    leaves = _leaves(tree, [])
    gen = torch.Generator(device=device).manual_seed(seed)
    n_normal = sum(_numel(l[1]) for l in leaves if l[0] == "normal")
    n_uniform = sum(_numel(l[1]) for l in leaves if l[0] == "uniform")
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    offsets = {"normal": 0, "uniform": 0}

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, list):
            return [build(v) for v in t]
        kind, shape = t[0], t[1]
        src = normal if kind == "normal" else uniform
        n = _numel(shape)
        x = src[offsets[kind]:offsets[kind] + n].view(shape)
        offsets[kind] += n
        if kind == "uniform":
            return x.clone()
        return x * t[2] + (t[3] if len(t) > 3 else 0.0)
    out = build(tree)
    del normal, uniform
    return out
