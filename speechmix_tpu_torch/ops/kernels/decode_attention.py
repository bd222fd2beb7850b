"""K4: single-query attention over a K/V buffer (the cached decoder steps).

``decode_attention`` launches ``csrc/decode_attention.cu`` for CUDA tensors
and runs ``decode_attention_plain`` for CPU tensors.  It replaces the TPU
kernels ``speechmix_tpu/ops/pallas/decode_attention.py: decode_attention``
(``_kernel`` for float K/V, ``_kernel_q8`` for int8 codes with scales).

Beyond the TPU contract, the query batch may be a multiple ``kb`` of the K/V
batch: queries ``b * kb .. b * kb + kb - 1`` (the beams of one input) share
K/V row ``b`` and its mask row, so beam search keeps one cross K/V per input.
"""

from __future__ import annotations

import ctypes

import torch

from ..masking import NEG_INF
from ._cuda import CudaKernel, check_aligned, check_cuda_tensor, dtype_code

HEAD_DIM = 64

_TAIL = [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 2
KERNEL = CudaKernel("decode_attention.cu", "smx_decode_attention",
                    [ctypes.c_void_p] * 5 + _TAIL)
KERNEL_Q8 = CudaKernel("decode_attention.cu", "smx_decode_attention_q8",
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


def decode_attention(q, k, v, mask, *, scale, num_heads, k_scale=None,
                     v_scale=None):
    """K4; see decode_attention_plain.  CUDA tensors need head_dim 64, q in
    float32 or bfloat16, contiguous 16-byte aligned q, k, v, and either k, v
    in q's dtype or int8 codes with both float32 scales."""
    kb = _beams_per_row(q, k)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, mask, scale=scale,
                                      num_heads=num_heads, k_scale=k_scale,
                                      v_scale=v_scale)
    bkv, t, h, d = k.shape
    if h != num_heads or d != HEAD_DIM:
        raise ValueError(f"decode_attention needs {num_heads} heads of "
                         f"head_dim {HEAD_DIM}, got k {tuple(k.shape)}")
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
        KERNEL_Q8.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         mask.data_ptr(), k_scale.data_ptr(),
                         v_scale.data_ptr(), out.data_ptr(), *tail)
    else:
        KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      mask.data_ptr(), out.data_ptr(), *tail)
    return out
