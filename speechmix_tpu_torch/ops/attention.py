"""Multi-head attention of the port (counterpart of ``speechmix_tpu.ops.attention``).

Attention without a cache or an extra bias (the speech encoder, the text
encoder and the teacher-forced decoder's causal self-attention) runs kernel
K1 (``ops.kernels.attention``) on the (B, T, H*D) projection slabs, and
kernel K7 as its backward.  A cached single-token step with a structured ``kv_mask``
runs kernel K4 (``ops.kernels.decode_attention``) over the whole cache
capacity.  Everything else (a cached multi-token chunk, an additive bias)
takes the plain path ``_attend``, which PyTorch differentiates (the training
cross-attention, whose padding mask arrives as a bias).  The in-place cache
writes happen only with a cache, never on the training path.

Attention-probability dropout (``dropout_rate`` with a ``dropout_rng``
DropoutKey): the kernel path runs K14 forward and K15 backward, the mask
drawn in the kernels; the plain path multiplies its probabilities by the
same mask (K10 on the card), rows (b * H + h) * Tq + q.  The JAX package's
two paths draw different streams; the port's draw one.

Under a mesh (``parallel.mesh``): with tensor parallelism a block whose
heads divide by n_model runs on this rank's heads (q / k / v column-
parallel, the input through ``copy_to_model``, a per-head bias sliced to
the local heads, the probability mask this rank's own) and its out_proj is
row-parallel; the callers pass the global head count.  ``ring_mesh`` (the
speech encoder's time-split layers under sequence parallelism) sends the
non-causal self-attention round the seq ring (``ops.ring_attention``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..parallel import collectives
from ..parallel import mesh as mesh_lib
from . import layers
from .ring_attention import ring_attention
from .kernels.attention import (attention_dropout_trainable,
                                attention_trainable)
from .kernels.dropout import check_key
from .kernels.decode_attention import decode_attention
from .masking import causal_attention_bias, combine_masks_to_bias


class KVCache(NamedTuple):
    """Fixed-capacity K/V buffers + fill index.  key, value:
    (B, capacity, H, D), or (L, B, capacity, H, D) for a decoder stack.
    ``attention`` writes new keys/values into the buffers in place (the JAX
    package returns updated copies; the port saves the copy)."""
    key: torch.Tensor
    value: torch.Tensor
    index: int


def _split_heads(x, num_heads):
    b, t, inner = x.shape
    return x.reshape(b, t, num_heads, inner // num_heads)


def _attend(q, k, v, bias, scale, dropout_rate=0.0, dropout_rng=None):
    """q: (B, Tq, H, D), k/v: (B, Tk, H, D), bias: broadcastable to
    (B, H, Tq, Tk) or None.  f32 scores and softmax; probabilities in q's
    dtype, dropped with the mask of dropout_rng (if any)."""
    dtype = q.dtype
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1).to(dtype)
    probs = layers.dropout(probs, dropout_rate, dropout_rng)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.to(dtype))


def attention(params, x_q, x_kv=None, bias=None, kv_mask=None, causal=False,
              num_heads=None, head_dim=None, scale=None,
              cache: Optional[KVCache] = None, dtype=None, out_proj=True,
              dropout_rate=0.0, dropout_rng=None, ring_mesh=None):
    """General MHA.  x_q: (B, Tq, Dq); x_kv: (B, Tk, Dk) or None for
    self-attention.  kv_mask: (B, Tk) bool key-padding mask, with `causal`;
    bias: extra additive bias (forces the plain path).  cache: new keys and
    values are written at cache.index and attention runs over the whole
    capacity (kv_mask or bias must exclude unfilled slots).
    out_proj=False returns the concatenated heads (the caller fuses the
    out-projection into its residual + LayerNorm epilogue).
    dropout_rate / dropout_rng: probability dropout (training, no cache).
    params: q_proj / k_proj / v_proj / out_proj denses (float or int8), or
    for a self-attention a fused ``qkv_proj`` in place of the first three.
    ring_mesh: the seq mesh of time-split activations (ring attention).
    Returns (out, new_cache)."""
    check_key(dropout_rng)
    if dropout_rng is None or cache is not None:
        dropout_rate = 0.0
    dtype = dtype or x_q.dtype
    if num_heads is None and head_dim is None:
        raise ValueError("attention() needs num_heads or head_dim; the "
                         "inner projection width alone is ambiguous")
    shares = mesh_lib.tp_split(num_heads) if num_heads else 1
    tp = mesh_lib.active_tp_mesh() if shares > 1 else None
    if tp is not None:
        self_attention = x_kv is None
        x_q = collectives.copy_to_model(x_q, tp)
        if not self_attention:
            x_kv = collectives.copy_to_model(x_kv, tp)
        num_heads //= shares
        dropout_rng = mesh_lib.fold_key(dropout_rng, mesh_lib.MODEL_AXIS)
        if bias is not None and bias.shape[1] != 1:
            bias = mesh_lib.local_slice(bias, num_heads, dim=1)
    x_kv = x_q if x_kv is None else x_kv
    fused = params.get("qkv_proj")
    proj = fused if fused is not None else params["q_proj"]
    inner = proj.get("kernel", proj.get("kernel_q")).shape[-1]
    if fused is not None:
        inner //= 3
    num_heads = num_heads or inner // head_dim
    head_dim = head_dim or inner // num_heads
    scale = scale if scale is not None else 1.0 / math.sqrt(head_dim)

    if fused is not None:
        # the pre-concatenated (Din, 3*H*D) kernel of a self-attention
        # (utils/quantize.fuse_qkv_params): one product, each third made
        # contiguous for the kernels, which take (B, T, H*D) slabs
        q, k, v = (part.contiguous() for part in
                   layers.dense(fused, x_q, dtype).chunk(3, dim=-1))
    else:
        q = layers.dense(params["q_proj"], x_q, dtype)
        k = layers.dense(params["k_proj"], x_kv, dtype)
        v = layers.dense(params["v_proj"], x_kv, dtype)

    new_cache = None
    if ring_mesh is not None and cache is None and bias is None \
            and not causal:
        out = ring_attention(
            *(_split_heads(t, num_heads) for t in (q, k, v)), kv_mask,
            scale=scale, mesh=ring_mesh, dropout_rate=dropout_rate,
            dropout_key=dropout_rng if dropout_rate > 0.0 else None)
        out = out.reshape(out.shape[0], out.shape[1], num_heads * head_dim)
    elif cache is None and bias is None and dropout_rate > 0.0:
        out = attention_dropout_trainable(q, k, v, kv_mask, num_heads, scale,
                                          causal, dropout_rng, dropout_rate)
    elif cache is None and bias is None:
        out = attention_trainable(q, k, v, kv_mask, num_heads, scale, causal)
    elif (cache is not None and bias is None and not causal
          and kv_mask is not None and x_q.shape[1] == 1):
        # cached single-token step: one K4 launch over the cache capacity
        index = cache.index
        cache.key[:, index] = _split_heads(k, num_heads)[:, 0]
        cache.value[:, index] = _split_heads(v, num_heads)[:, 0]
        new_cache = KVCache(cache.key, cache.value, index + 1)
        out = decode_attention(_split_heads(q, num_heads), cache.key,
                               cache.value, kv_mask.contiguous(), scale=scale,
                               num_heads=num_heads)
        out = out.reshape(out.shape[0], 1, num_heads * head_dim)
    else:
        q, k, v = (_split_heads(t, num_heads) for t in (q, k, v))
        if cache is not None:
            end = cache.index + x_q.shape[1]
            cache.key[:, cache.index:end] = k.to(cache.key.dtype)
            cache.value[:, cache.index:end] = v.to(cache.value.dtype)
            new_cache = KVCache(cache.key, cache.value, end)
            k, v = cache.key.to(dtype), cache.value.to(dtype)
        total_bias = bias
        if kv_mask is not None or causal:
            b_sz, q_len = x_q.shape[0], x_q.shape[1]
            struct = combine_masks_to_bias(
                q_mask=torch.ones((b_sz, q_len), dtype=torch.bool,
                                  device=x_q.device),
                kv_mask=(kv_mask if kv_mask is not None else torch.ones(
                    (b_sz, k.shape[1]), dtype=torch.bool,
                    device=x_q.device)),
                causal=causal)
            total_bias = struct if total_bias is None else total_bias + struct
        out = _attend(q, k, v, total_bias, scale, dropout_rate, dropout_rng)
        out = out.reshape(out.shape[0], out.shape[1], num_heads * head_dim)
    if out_proj:
        out = layers.dense(params["out_proj"], out, dtype,
                           row_parallel=tp is not None)
    return out, new_cache


def cache_position_bias(cache_capacity, index, q_len, dtype=torch.float32,
                        device=None):
    """Additive bias for cached causal decoding: query i (absolute position
    index+i) may attend cache slots <= index+i; later slots are masked."""
    return causal_attention_bias(q_len, cache_capacity, dtype, offset=index,
                                 device=device)
