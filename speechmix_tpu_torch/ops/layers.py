"""Core neural-net ops of the port (counterpart of ``speechmix_tpu.ops.layers``).

Plain functions over parameter dicts of tensors.  Dense kernels keep the JAX
layout ``(in, out)``; conv kernels are stored in PyTorch's ``(out, in, k)``
layout (``convert.params_from_jax`` maps them).  The compute dtype is the
caller's; normalisation statistics are f32.

``ffn_residual_ln_apply`` and ``dense_residual_ln_apply`` send blocks of at
least ``FUSED_MIN_ROWS`` rows to the fused kernels K3 and K2
(``ops.kernels.ffn``), as the JAX package sends them to its TPU kernels;
smaller blocks (the cached decode steps, rows == B) take the plain chain.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .kernels import ffn as ffn_kernels

FUSED_MIN_ROWS = 1024  # the JAX row gate: cached decode steps stay plain


def dense(params, x, dtype=None):
    dtype = dtype or x.dtype
    y = x.to(dtype) @ params["kernel"].to(dtype)
    if "bias" in params:
        y = y + params["bias"].to(dtype)
    return y


def embed(params, ids, dtype=torch.float32):
    return params["embedding"][ids].to(dtype)


def layer_norm(params, x, eps=1e-5):
    y = F.layer_norm(x.float(), (x.shape[-1],), params["scale"].float(),
                     params["bias"].float(), eps)
    return y.to(x.dtype)


def group_norm_per_channel(params, x, eps=1e-5, mask=None):
    """GroupNorm with one group per channel over (B, T, C): statistics over
    T per (batch, channel), from the valid frames only when `mask` (B, T)
    is given; var = E[x^2] - E[x]^2 as in the JAX package."""
    xf = x.float()
    if mask is None:
        n = torch.tensor(float(x.shape[1]), device=x.device)
        s1 = xf.sum(1, keepdim=True)
        s2 = (xf * xf).sum(1, keepdim=True)
    else:
        m = mask[..., None]
        n = m.float().sum(1, keepdim=True).clamp_min(1.0)
        xm = torch.where(m, xf, 0.0)
        s1 = xm.sum(1, keepdim=True)
        s2 = (xm * xm).sum(1, keepdim=True)
    mean = s1 / n
    var = (s2 / n - mean * mean).clamp_min(0.0)
    scale = torch.rsqrt(var + eps) * params["scale"].float()
    shift = params["bias"].float() - mean * scale
    return (xf * scale + shift).to(x.dtype)


ACTIVATIONS = {
    "gelu": F.gelu,
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
}


def activation(name: str):
    return ACTIVATIONS[name]


def _rows(x):
    return math.prod(x.shape[:-1])


def _bias_or_zeros(params, size, device):
    b = params.get("bias")
    if b is None:
        return torch.zeros(size, dtype=torch.float32, device=device)
    return b.float().contiguous()


def ffn_residual_ln_apply(p1, p2, p_ln, x, act_name, dtype, eps=1e-5):
    """Post-LN FFN block: LayerNorm(x + act(x @ W1 + b1) @ W2 + b2).  Blocks
    of >= FUSED_MIN_ROWS rows run as one fused kernel (K3)."""
    if _rows(x) >= FUSED_MIN_ROWS:
        lead, h = x.shape[:-1], x.shape[-1]
        x2 = x.to(dtype).reshape(-1, h).contiguous()
        w1 = p1["kernel"].to(dtype).contiguous()
        w2 = p2["kernel"].to(dtype).contiguous()
        y = ffn_kernels.ffn_res_ln(
            x2, w1, _bias_or_zeros(p1, w1.shape[1], x.device), w2,
            _bias_or_zeros(p2, w2.shape[1], x.device), x2,
            p_ln["scale"].float().contiguous(),
            p_ln["bias"].float().contiguous(), act_name, eps)
        return y.reshape(*lead, w2.shape[1])
    f = dense(p2, activation(act_name)(dense(p1, x, dtype)), dtype)
    return layer_norm(p_ln, x + f, eps)


def dense_residual_ln_apply(p, p_ln, x, res, dtype, eps=1e-5):
    """Post-LN attention epilogue: LayerNorm(res + x @ W + b).  Blocks of
    >= FUSED_MIN_ROWS rows run as one fused kernel (K2)."""
    if _rows(x) >= FUSED_MIN_ROWS:
        lead, din = x.shape[:-1], x.shape[-1]
        w = p["kernel"].to(dtype).contiguous()
        h = w.shape[1]
        y = ffn_kernels.dense_res_ln(
            x.to(dtype).reshape(-1, din).contiguous(), w,
            _bias_or_zeros(p, h, x.device),
            res.to(dtype).reshape(-1, h).contiguous(),
            p_ln["scale"].float().contiguous(),
            p_ln["bias"].float().contiguous(), eps)
        return y.reshape(*lead, h)
    return layer_norm(p_ln, res + dense(p, x, dtype), eps)


def conv1d(params, x, stride, dtype=None):
    """x: (B, T, C_in) -> (B, T_out, C_out), VALID padding; kernel
    (C_out, C_in, K)."""
    dtype = dtype or x.dtype
    bias = params.get("bias")
    y = F.conv1d(x.to(dtype).transpose(1, 2), params["kernel"].to(dtype),
                 None if bias is None else bias.to(dtype), stride=stride)
    return y.transpose(1, 2)


def conv1d_same_grouped(params, x, groups, dtype=None):
    """The wav2vec2 positional conv: grouped, padded k//2 on both sides, one
    trailing frame removed when k is even.  x: (B, T, C); kernel
    (C_out, C_in/groups, K)."""
    dtype = dtype or x.dtype
    kernel = params["kernel"].to(dtype)
    k = kernel.shape[-1]
    bias = params.get("bias")
    y = F.conv1d(x.to(dtype).transpose(1, 2), kernel,
                 None if bias is None else bias.to(dtype), padding=k // 2,
                 groups=groups).transpose(1, 2)
    if k % 2 == 0:
        y = y[:, :-1, :]
    return y
