"""K4: single-query attention over a K/V buffer (the cached decoder steps).

``decode_attention`` launches ``csrc/decode_attention.cu`` for CUDA tensors
and runs ``decode_attention_plain`` for CPU tensors.  It replaces the TPU
kernels ``speechmix_tpu/ops/pallas/decode_attention.py: decode_attention``
(``_kernel`` for float K/V, ``_kernel_q8`` for int8 codes with scales).

Beyond the TPU contract, the query batch may be a multiple ``kb`` of the K/V
batch: queries ``b * kb .. b * kb + kb - 1`` (the beams of one input) share
K/V row ``b`` and its mask row, so beam search keeps one cross K/V per input.

With a bfloat16 q and 128 < T <= 2048 the kernel splits each (row,
head)'s keys into equal shares held by the blocks of a thread-block cluster
(``split_ranges``, ``row_shares``); ``decode_attention_split_plain`` is that
decomposition in plain PyTorch.  ``decode_attention_serial`` runs the kernel's
one-block-per-(row, head) body, the one of float32 q and of the other
lengths, on bfloat16 at any T, so that the two can be timed side by side.
"""

from __future__ import annotations

import ctypes

import torch

from ..masking import NEG_INF
from ._cuda import CudaKernel, check_aligned, check_cuda_tensor, dtype_code
from .attention import check_head_dim
from .ffn import _ordered_sum
# the cluster body's blocks a (row, head) (csrc/decode_attention.cu): one a
# RANGE_KEYS keys of T, at most MAX_RANKS (the portable cluster size)
RANGE_KEYS, MAX_RANKS = 128, 8

_TAIL = [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 2
KERNEL = CudaKernel("decode_attention.cu", "smx_decode_attention",
                    [ctypes.c_void_p] * 5 + _TAIL)
KERNEL_Q8 = CudaKernel("decode_attention.cu", "smx_decode_attention_q8",
                       [ctypes.c_void_p] * 7 + _TAIL)
KERNEL_SERIAL = CudaKernel("decode_attention.cu",
                           "smx_decode_attention_serial",
                           [ctypes.c_void_p] * 5 + _TAIL)
KERNEL_Q8_SERIAL = CudaKernel("decode_attention.cu",
                              "smx_decode_attention_q8_serial",
                              [ctypes.c_void_p] * 7 + _TAIL)


def _beams_per_row(q, k, any_q_len=False):
    bq, bkv = q.shape[0], k.shape[0]
    if (q.shape[1] != 1 and not any_q_len) or bq % bkv:
        raise ValueError(f"decode_attention needs q (B * kb, 1, H, D) against "
                         f"k (B, T, H, D), got q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)}")
    return bq // bkv


def decode_attention_plain(q, k, v, mask, *, scale, num_heads, k_scale=None,
                           v_scale=None):
    """softmax(q k^T * scale [* k_scale] + mask) [* v_scale] v per head.
    q: (B * kb, q_len, H, D), q_len = 1 being the kernel's function and a
    longer chunk q_len such queries on the same K/V; k, v: (B, T, H, D),
    float or int8 codes; mask: (B, T) bool, True = attend (a masked logit
    gets NEG_INF added); k_scale, v_scale: (B, T, H) float32 for int8 codes.
    f32 scores and softmax; the probabilities (times v_scale) are rounded to
    q's dtype before the value product.  Returns q's shape in q's dtype."""
    kb = _beams_per_row(q, k, any_q_len=True)
    bkv, _, h, d = k.shape
    q_len = q.shape[1]
    qf = q.reshape(bkv, kb * q_len, h, d).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, k.float()) * scale
    if k_scale is not None:
        logits = logits * k_scale.transpose(1, 2)[:, :, None, :]
    bias = torch.where(mask[:, None, None, :], 0.0, NEG_INF)
    probs = torch.softmax(logits + bias, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.transpose(1, 2)[:, :, None, :]
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v.to(q.dtype))
    return out.reshape(bkv * kb, q_len, h, d)


def split_ranges(t, range_keys=RANGE_KEYS):
    """(ranks, length): the cluster body gives a (row, head) `ranks`
    blocks, one a `range_keys` keys of T and at most MAX_RANKS, as few as
    keep a block within 2 range_keys keys; a block holds at most `length`
    = ceil(T / ranks) keys."""
    tiles = -(-t // range_keys)
    per_block = -(-tiles // MAX_RANKS)
    ranks = -(-tiles // per_block)
    return ranks, -(-t // ranks)


def row_shares(extent, ranks):
    """The keys [lo, hi) of each of `ranks` blocks, in rank order: equal
    shares of a row's extent (one past its last attended key, or all its
    keys when it attends none); the last shares may be empty."""
    share = -(-extent // ranks)
    return [(min(r * share, extent), min((r + 1) * share, extent))
            for r in range(ranks)]


def decode_attention_split_plain(q, k, v, mask, *, scale, num_heads,
                                 k_scale=None, v_scale=None,
                                 range_keys=RANGE_KEYS):
    """decode_attention_plain as the cluster body computes it: each row's
    extent cut into the row_shares of split_ranges(T, range_keys)'s ranks;
    each share's maximum m_r and sum of exp(s - m_r); the row's maximum m
    and its sum, the shares' sums times exp(m_r - m) added in rank order;
    probabilities exp(s - m) / sum, times v_scale, rounded to q's dtype;
    each share's f32 partial P . v, added in rank order, in q's dtype.  The
    same function as decode_attention_plain up to the order of the f32
    sums."""
    kb = _beams_per_row(q, k)
    bkv, t, h, d = k.shape
    qf = q.reshape(bkv, kb, h, d).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, k.float()) * scale
    if k_scale is not None:
        logits = logits * k_scale.transpose(1, 2)[:, :, None, :]
    logits = logits + torch.where(mask[:, None, None, :], 0.0, NEG_INF)
    ranks, _ = split_ranges(t, range_keys)
    key = torch.arange(t, device=k.device)
    last = torch.where(mask, key + 1, 0).amax(1)
    owner = torch.full((bkv, t), -1, device=k.device)   # the key's block
    for b, n in enumerate(last.tolist()):
        for r, (lo, hi) in enumerate(row_shares(n or t, ranks)):
            owner[b, lo:hi] = r
    owned = [(owner == r)[:, None, None, :] for r in range(ranks)]
    maxima, sums = [], []
    for own in owned:
        part = logits.masked_fill(~own, float("-inf"))
        m_r = part.amax(-1)                                   # -inf: empty
        finite = torch.where(torch.isinf(m_r), 0.0, m_r)
        maxima.append(m_r)
        sums.append(torch.exp(part - finite[..., None]).sum(-1))
    m = torch.stack(maxima).amax(0)
    total = _ordered_sum([torch.where(m_r > float("-inf"),
                                      l_r * torch.exp(m_r - m), 0.0)
                          for m_r, l_r in zip(maxima, sums)])
    read = (owner >= 0)[:, None, None, :]
    probs = torch.exp(logits.masked_fill(~read, float("-inf"))
                      - m[..., None]) / total[..., None]
    if v_scale is not None:
        probs = probs * v_scale.transpose(1, 2)[:, :, None, :]
    probs = probs.to(q.dtype).float()
    out = _ordered_sum([torch.einsum("bhqk,bkhd->bqhd", probs * own,
                                     v.float()) for own in owned])
    return out.to(q.dtype).reshape(bkv * kb, 1, h, d)


def decode_attention(q, k, v, mask, *, scale, num_heads, k_scale=None,
                     v_scale=None):
    """K4; see decode_attention_plain.  CUDA tensors need a head_dim that
    is a multiple of 8 in [8, 128] (attention.check_head_dim), q in float32
    or bfloat16, contiguous 16-byte aligned q, k, v, and either k, v
    in q's dtype or int8 codes with both float32 scales."""
    if q.device.type == "cpu":
        _beams_per_row(q, k)
        return decode_attention_plain(q, k, v, mask, scale=scale,
                                      num_heads=num_heads, k_scale=k_scale,
                                      v_scale=v_scale)
    return _launch(KERNEL, KERNEL_Q8, q, k, v, mask, scale, num_heads,
                   k_scale, v_scale)


def decode_attention_serial(q, k, v, mask, *, scale, num_heads,
                            k_scale=None, v_scale=None):
    """K4 through its serial body (one block per (row, head)) in either
    dtype, for timing it beside the cluster body; CUDA tensors only, with
    decode_attention's rules."""
    if q.device.type == "cpu":
        raise ValueError("decode_attention_serial takes CUDA tensors")
    return _launch(KERNEL_SERIAL, KERNEL_Q8_SERIAL, q, k, v, mask, scale,
                   num_heads, k_scale, v_scale)


def _launch(kernel, kernel_q8, q, k, v, mask, scale, num_heads, k_scale,
            v_scale):
    kb = _beams_per_row(q, k)
    bkv, t, h, d = k.shape
    if h != num_heads:
        raise ValueError(f"decode_attention needs {num_heads} heads, got k "
                         f"{tuple(k.shape)}")
    check_head_dim("decode_attention", h * d, h)
    int8_kv = k.dtype == torch.int8
    if int8_kv != (k_scale is not None) or int8_kv != (v_scale is not None):
        raise ValueError("decode_attention takes k_scale and v_scale with "
                         "int8 k, v and only with them")
    check_cuda_tensor("q", q, shape=(bkv * kb, 1, h, d))
    code = dtype_code(q.dtype)
    kv_dtype = torch.int8 if int8_kv else q.dtype
    check_cuda_tensor("k", k, kv_dtype, (bkv, t, h, d), q.device)
    check_cuda_tensor("v", v, kv_dtype, (bkv, t, h, d), q.device)
    check_cuda_tensor("mask", mask, torch.bool, (bkv, t), q.device)
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_aligned(name, x, 16)
    out = torch.empty_like(q)
    tail = (bkv, kb, t, h, d, float(scale), code, q.device.index)
    if int8_kv:
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            check_cuda_tensor(name, s, torch.float32, (bkv, t, h), q.device)
        kernel_q8.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         mask.data_ptr(), k_scale.data_ptr(),
                         v_scale.data_ptr(), out.data_ptr(), *tail)
    else:
        kernel.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      mask.data_ptr(), out.data_ptr(), *tail)
    return out
