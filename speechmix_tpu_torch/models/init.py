"""Random parameter builders shared by the model modules.

Shapes and distributions follow the JAX package's initialisers
(``speechmix_tpu.ops.layers.init_*``); the numbers differ, since they come
from a ``torch.Generator``.  Matrices are made in the caller's dtype,
vectors (biases, LayerNorm parameters) in float32.
"""

from __future__ import annotations

import math

import torch


def normal(generator, device, shape, std, dtype):
    x = torch.randn(shape, generator=generator, device=generator.device)
    return (x * std).to(device=device, dtype=dtype)


def dense_params(generator, device, dtype, in_dim, out_dim, use_bias=True,
                 std=0.02):
    p = {"kernel": normal(generator, device, (in_dim, out_dim), std, dtype)}
    if use_bias:
        p["bias"] = torch.zeros(out_dim, dtype=torch.float32, device=device)
    return p


def conv_params(generator, device, dtype, in_ch, out_ch, kernel,
                use_bias=True):
    """Conv kernel in PyTorch's (out, in, k) layout."""
    std = math.sqrt(1.0 / (in_ch * kernel))
    p = {"kernel": normal(generator, device, (out_ch, in_ch, kernel), std,
                          dtype)}
    if use_bias:
        p["bias"] = torch.zeros(out_ch, dtype=torch.float32, device=device)
    return p


def layer_norm_params(dim, device):
    return {"scale": torch.ones(dim, dtype=torch.float32, device=device),
            "bias": torch.zeros(dim, dtype=torch.float32, device=device)}


def rms_norm_params(dim, device):
    return {"scale": torch.ones(dim, dtype=torch.float32, device=device)}


def embedding_params(generator, device, dtype, vocab, dim, std=0.02):
    return {"embedding": normal(generator, device, (vocab, dim), std, dtype)}
