"""The work of one call or step, counted from the configuration and the
batch's shapes: a list of operations, each with its kind, its shapes and
its model FLOPs (the products the mathematics requires, forward only).

Rules of the count:
  - products count 2 per multiply-add; normalisations, activations and
    softmax are not counted;
  - the conv extractor 2 * N_out * k * C_in * C_out per layer;
  - attention over the allowed (query, key) pairs: every query row of the
    batch against its row's valid keys (causal: the keys at or before it),
    2 * pairs * width for the scores and as many for the values;
  - the decode loop's steps through the cache: each step's projections,
    its self-attention over the keys written so far and its
    cross-attention over the valid encoder keys, the head at every step;
  - training is the forward times 3 over the layers LayerDrop keeps (every
    leaf trains); recomputation is not counted.

Each operation also says whether the port's fused path takes it, by the
gates the port states (``ops/layers.py``: a fused block needs at least
1024 rows and widths that are multiples of 128; self-attention without a
cache or bias runs the attention kernel; a cached single-token step runs
the decode-attention kernel; extractor layers 1.. run the fused conv when
the configuration asks for it and the geometry allows), and under which
dropout; ``benchmark/kernels/`` maps the fused ones to device kernels and
to the launches each takes.  That copy of the gates is held to the port's
launch counters: a family whose counted launches differ from the
counters' is left out of ``kernel_roofline`` (``core.roofline``).  An FFN
op says whether its block ends in the residual LayerNorm (``res_ln``) and
whether it is the forward that a fused post-LN block's backward runs again
(``recompute``).
"""

from __future__ import annotations

import math

FUSED_MIN_ROWS = 1024
FUSED_WIDTH = 128


def _fusable(rows, *widths):
    return rows >= FUSED_MIN_ROWS and all(w % FUSED_WIDTH == 0 for w in widths)


def _op(kind, flops, **shape):
    return {"kind": kind, "flops": float(flops), **shape}


def dense(rows, d_in, d_out):
    return _op("dense", 2 * rows * d_in * d_out, rows=rows, d_in=d_in,
               d_out=d_out)


def frame_lengths(e, samples):
    out = []
    for n in samples:
        for k, s in zip(e["conv_kernels"], e["conv_strides"]):
            n = (n - k) // s + 1
        out.append(n)
    return out


def _attention(b, width, tq, keys, causal, fused, train):
    """Self- or cross-attention of b rows: keys[i] valid keys of row i."""
    if causal:
        pairs = b * tq * (tq + 1) // 2
    else:
        pairs = tq * sum(keys)
    return _op("attention", 4 * pairs * width, rows=b, width=width, tq=tq,
               pairs=pairs, fused=fused, backward=train)


def _dropout(rows, cols, on):
    return [_op("dropout_mask", 0, rows=rows, cols=cols)] if on else []


def _dense_ln(n, h, fused, dropout, train):
    """The post-LN attention epilogue LayerNorm(res + drop(x W + b)); its
    backward regenerates the output mask (K10) when fused with dropout."""
    return [_op("dense_ln", 2 * n * h * h, rows=n, d_in=h, d_out=h,
                fused=fused, backward=train)] + \
        _dropout(n, h, dropout and train and fused)


def _post_ln(n, h, f, fused, dropout, train):
    """A post-LN layer's epilogue and FFN block LayerNorm(x + drop(FFN(x)));
    the fused block's backward runs the FFN forward again (no model FLOPs)
    and regenerates its output mask."""
    ops = _dense_ln(n, h, fused, dropout, train)
    ops.append(_op("ffn", 4 * n * h * f, rows=n, h=h, f=f, fused=fused,
                   backward=train, res_ln=True))
    if train and fused:
        ops.append(_op("ffn", 0, rows=n, h=h, f=f, fused=True,
                       backward=False, res_ln=True, recompute=True))
        ops += _dropout(n, h, dropout)
    return ops


def speech_encoder(cfg, b, padded, samples, skipped=(), train=False,
                   dropout=False):
    e = cfg["encoder"]
    ops = []
    t = padded
    c_in = 1
    fused_ok = (e["extractor_impl"] == "fused"
                and all(s == 2 for s in e["conv_strides"][1:])
                and all(k in (2, 3) for k in e["conv_kernels"][1:])
                and len(set(e["conv_dims"])) == 1)
    for i, (c, k, s) in enumerate(zip(e["conv_dims"], e["conv_kernels"],
                                      e["conv_strides"])):
        t_out = (t - k) // s + 1
        fused = fused_ok and i > 0
        ops.append(_op("conv", 2 * b * t_out * k * c_in * c, rows=b,
                       t_in=t, t_out=t_out, c_in=c_in, c_out=c, k=k,
                       fused=fused))
        t, c_in = t_out, c
    frames = frame_lengths(e, samples)
    h, f = e["hidden_size"], e["ffn_dim"]
    n = b * t
    ops.append(dense(n, c_in, h))
    ops += _dropout(n, h, dropout)
    g = e["pos_conv_groups"]
    ops.append(_op("conv", 2 * b * t * e["pos_conv_kernel"] * (h // g) * h,
                   rows=b, t_in=t, t_out=t, c_in=h // g, c_out=h,
                   k=e["pos_conv_kernel"], fused=False))
    ops += _dropout(n, h, dropout)
    fusable = _fusable(n, h, f)
    for i in range(e["num_layers"]):
        if i in skipped:
            continue
        ops += [dense(n, h, h) for _ in range(3)]
        ops.append(_attention(b, h, t, frames, False, True, train))
        if e["do_stable_layer_norm"]:
            ops.append(dense(n, h, h))
            ops += _dropout(n, h, dropout)
            ops.append(_op("ffn", 4 * n * h * f, rows=n, h=h, f=f,
                           fused=fusable, backward=train, res_ln=False))
            ops += _dropout(n, h, dropout)
        else:
            ops += _post_ln(n, h, f, fusable, dropout, train)
    # length adapter (k = 2, stride 2) and the projection
    down = int(math.log2(cfg["down_scale"])) if cfg["down_scale"] > 1 else 0
    for _ in range(down):
        t_out = (t - 2) // 2 + 1
        ops.append(_op("conv", 2 * b * t_out * 2 * h * h, rows=b, t_in=t,
                       t_out=t_out, c_in=h, c_out=h, k=2, fused=False))
        t = t_out
        frames = [x // 2 for x in frames]
    ops.append(dense(b * t, h, cfg["decoder"]["hidden_size"]))
    return ops, t, frames


def text_encoder(d, b, t, frames, train=False, dropout=False):
    h, f = d["hidden_size"], d["ffn_dim"]
    n = b * t
    ops = _dropout(n, h, dropout)
    fusable = _fusable(n, h, f)
    for _ in range(d["encoder_layers"]):
        ops += [dense(n, h, h) for _ in range(3)]
        ops.append(_attention(b, h, t, frames, False, True, train))
        ops += _post_ln(n, h, f, fusable, dropout, train)
    return ops


def teacher_forced_decoder(d, b, length, t_enc, frames, dropout=False):
    h, f, heads, v = (d["hidden_size"], d["ffn_dim"], d["num_heads"],
                      d["vocab_size"])
    n = b * length
    ops = _dropout(n, h, dropout)
    fusable = _fusable(n, h, f)
    for _ in range(d["decoder_layers"]):
        ops += [dense(n, h, h) for _ in range(3)]
        ops.append(_attention(b, h, length, [length] * b, True, True, True))
        ops += _dense_ln(n, h, fusable, dropout, True)
        ops += [dense(n, h, h), dense(b * t_enc, h, h), dense(b * t_enc, h, h)]
        ops.append(_attention(b, h, length, frames, False, False, True))
        ops += _dropout(b * heads * length, t_enc, dropout)
        ops += _post_ln(n, h, f, fusable, dropout, True)
    ops.append(dense(n, h, v))
    return ops


def cached_decode(d, b, steps, t_enc, frames):
    h, f, v = d["hidden_size"], d["ffn_dim"], d["vocab_size"]
    ops = []
    for _ in range(d["decoder_layers"]):
        ops += [dense(b * t_enc, h, h), dense(b * t_enc, h, h)]
    fusable = _fusable(b, h, f)
    for step in range(steps):
        for _ in range(d["decoder_layers"]):
            ops += [dense(b, h, h) for _ in range(3)]
            ops.append(_op("decode_attention", 4 * b * (step + 1) * h,
                           rows=b, width=h, keys=b * (step + 1)))
            ops.append(_op("dense_ln", 2 * b * h * h, rows=b, d_in=h,
                           d_out=h, fused=fusable, backward=False))
            ops.append(dense(b, h, h))
            ops.append(_op("decode_attention", 4 * sum(frames) * h, rows=b,
                           width=h, keys=sum(frames)))
            ops.append(_op("dense_ln", 2 * b * h * h, rows=b, d_in=h,
                           d_out=h, fused=fusable, backward=False))
            ops.append(_op("ffn", 4 * b * h * f, rows=b, h=h, f=f,
                           fused=fusable, backward=False, res_ln=True))
        ops.append(dense(b, h, v))
    return ops


def generate_ops(cfg, b, padded, samples, max_length):
    ops, t, frames = speech_encoder(cfg, b, padded, samples)
    d = cfg["decoder"]
    ops += text_encoder(d, b, t, frames)
    ops += cached_decode(d, b, max_length, t, frames)
    return ops


def train_ops(cfg, b, padded, samples, label_positions, skipped, dropout):
    ops, t, frames = speech_encoder(cfg, b, padded, samples, skipped, True,
                                    dropout)
    d = cfg["decoder"]
    ops += text_encoder(d, b, t, frames, True, dropout)
    ops += teacher_forced_decoder(d, b, label_positions, t, frames, dropout)
    return ops


def model_flops(ops, train):
    """The model FLOPs of a call (forward) or a step (forward x 3)."""
    return sum(op["flops"] for op in ops) * (3.0 if train else 1.0)
