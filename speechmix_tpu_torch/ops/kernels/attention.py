"""K1: masked multi-head attention forward on (B, T, H*D) slabs.

``attention_fwd`` launches ``csrc/attention_fwd.cu`` for CUDA tensors and
runs ``attention_fwd_plain`` (the same function in plain PyTorch) for CPU
tensors.  It replaces the TPU kernel
``speechmix_tpu/ops/pallas/flash_attention_kernel.py:
flash_attention_fused_layout``.
"""

from __future__ import annotations

import ctypes

import torch

from ._cuda import CudaKernel, check_aligned, check_cuda_tensor, dtype_code

# the TPU kernel's excluded-logit value: finite, so a fully masked row
# averages its values instead of producing NaN
NEG_INF = -1e30
HEAD_DIM = 64

KERNEL = CudaKernel(
    "attention_fwd.cu", "smx_attention_fwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 +
    [ctypes.c_float] + [ctypes.c_int] * 3)


def attention_fwd_plain(q, k, v, kv_mask, heads, scale, causal=False):
    """softmax(q k^T * scale + mask) v per (batch, head), f32 scores,
    softmax and products, output in q's dtype.  q: (B, Tq, H*D); k, v:
    (B, Tk, H*D); kv_mask: (B, Tk) bool or None."""
    b, tq, hd = q.shape
    tk = k.shape[1]
    d = hd // heads
    qf = q.float().reshape(b, tq, heads, d)
    kf = k.float().reshape(b, tk, heads, d)
    vf = v.float().reshape(b, tk, heads, d)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask.bool()[:, None, None, :], NEG_INF)
    if causal:
        qi = torch.arange(tq, device=q.device)[:, None]
        kj = torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(kj > qi, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return out.reshape(b, tq, hd).to(q.dtype)


def attention_fwd(q, k, v, kv_mask, heads, scale, causal=False):
    """Masked MHA forward on (B, T, H*D) slabs; see attention_fwd_plain.
    CPU tensors take the plain version; CUDA tensors launch the kernel, which
    requires head_dim 64, float32 or bfloat16, contiguous inputs, and for
    bfloat16 q, k, v 16-byte aligned."""
    if q.device.type == "cpu":
        return attention_fwd_plain(q, k, v, kv_mask, heads, scale, causal)
    b, tq, hd = q.shape
    tk = k.shape[1]
    if hd % heads or hd // heads != HEAD_DIM:
        raise ValueError(f"attention_fwd needs head_dim {HEAD_DIM}, got "
                         f"{hd} / {heads} heads")
    check_cuda_tensor("q", q)
    code = dtype_code(q.dtype)
    check_cuda_tensor("k", k, q.dtype, (b, tk, hd), q.device)
    check_cuda_tensor("v", v, q.dtype, (b, tk, hd), q.device)
    if kv_mask is None:
        kv_mask = torch.ones((b, tk), dtype=torch.bool, device=q.device)
    check_cuda_tensor("kv_mask", kv_mask, torch.bool, (b, tk), q.device)
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_aligned(name, t, 16)
    out = torch.empty_like(q)
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  kv_mask.data_ptr(), out.data_ptr(), b, tq, tk, heads,
                  HEAD_DIM, float(scale), int(bool(causal)), code,
                  q.device.index)
    return out
