"""K1 and K7: masked multi-head attention on (B, T, H*D) slabs, forward and
backward.

``attention_fwd`` launches ``csrc/attention_fwd.cu`` for CUDA tensors and
runs ``attention_fwd_plain`` (the same function in plain PyTorch) for CPU
tensors.  It replaces the TPU kernel
``speechmix_tpu/ops/pallas/flash_attention_kernel.py:
flash_attention_fused_layout``.  ``attention_bwd`` (K7,
``csrc/attention_bwd.cu``; plain version ``attention_bwd_plain``) replaces the
backward kernels of the same file, ``_flash_bwd_fused_layout`` and
``_trainable_bwd``: dq, dk and dv with the probabilities recomputed from the
forward's row log-sum-exp.  ``attention_trainable`` ties the two into one
differentiable function, the counterpart of ``flash_attention_trainable``.
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
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 +
    [ctypes.c_float] + [ctypes.c_int] * 3)
BWD_KERNEL = CudaKernel(
    "attention_bwd.cu", "smx_attention_bwd",
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 +
    [ctypes.c_float] + [ctypes.c_int] * 3)


def _masked_scores(q, k, kv_mask, heads, scale, causal):
    """f32 logits (B, H, Tq, Tk) with excluded entries at NEG_INF."""
    b, tq, hd = q.shape
    tk = k.shape[1]
    d = hd // heads
    qf = q.float().reshape(b, tq, heads, d)
    kf = k.float().reshape(b, tk, heads, d)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask.bool()[:, None, None, :], NEG_INF)
    if causal:
        qi = torch.arange(tq, device=q.device)[:, None]
        kj = torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(kj > qi, NEG_INF)
    return s


def attention_fwd_plain(q, k, v, kv_mask, heads, scale, causal=False,
                        return_lse=False):
    """softmax(q k^T * scale + mask) v per (batch, head), f32 scores,
    softmax and products, output in q's dtype.  q: (B, Tq, H*D); k, v:
    (B, Tk, H*D); kv_mask: (B, Tk) bool or None.  With return_lse also the
    float32 row log-sum-exp of the masked logits, (B, H, Tq)."""
    b, tq, hd = q.shape
    tk = k.shape[1]
    s = _masked_scores(q, k, kv_mask, heads, scale, causal)
    p = torch.softmax(s, dim=-1)
    vf = v.float().reshape(b, tk, heads, hd // heads)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    out = out.reshape(b, tq, hd).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def _check_slabs(what, q, k, v, kv_mask, heads):
    """Shared checks of the K1 / K7 wrappers; returns (mask, dtype code)."""
    b, tq, hd = q.shape
    tk = k.shape[1]
    if hd % heads or hd // heads != HEAD_DIM:
        raise ValueError(f"{what} needs head_dim {HEAD_DIM}, got "
                         f"{hd} / {heads} heads")
    check_cuda_tensor("q", q)
    code = dtype_code(q.dtype)
    check_cuda_tensor("k", k, q.dtype, (b, tk, hd), q.device)
    check_cuda_tensor("v", v, q.dtype, (b, tk, hd), q.device)
    if kv_mask is None:
        kv_mask = torch.ones((b, tk), dtype=torch.bool, device=q.device)
    check_cuda_tensor("kv_mask", kv_mask, torch.bool, (b, tk), q.device)
    return kv_mask, code


def attention_fwd(q, k, v, kv_mask, heads, scale, causal=False,
                  return_lse=False):
    """Masked MHA forward on (B, T, H*D) slabs; see attention_fwd_plain.
    CPU tensors take the plain version; CUDA tensors launch the kernel, which
    requires head_dim 64, float32 or bfloat16, contiguous inputs, and for
    bfloat16 q, k, v 16-byte aligned."""
    if q.device.type == "cpu":
        return attention_fwd_plain(q, k, v, kv_mask, heads, scale, causal,
                                   return_lse)
    b, tq, hd = q.shape
    tk = k.shape[1]
    kv_mask, code = _check_slabs("attention_fwd", q, k, v, kv_mask, heads)
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_aligned(name, t, 16)
    out = torch.empty_like(q)
    lse = (torch.empty((b, heads, tq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  kv_mask.data_ptr(), out.data_ptr(),
                  None if lse is None else lse.data_ptr(), b, tq, tk, heads,
                  HEAD_DIM, float(scale), int(bool(causal)), code,
                  q.device.index)
    return (out, lse) if return_lse else out


def attention_bwd_plain(q, k, v, kv_mask, g, heads, scale, causal=False):
    """(dq, dk, dv) of attention_fwd_plain for d(out) = g, by recomputing the
    probabilities: p = softmax(s) in f32, dv = round(p)^T g,
    ds = round(p * (g v^T - rowsum(g v^T * p))), dq = ds k * scale,
    dk = ds^T q * scale, round() to g's dtype, sums in f32 (the formulas and
    roundings of the TPU package's backward)."""
    b, tq, hd = q.shape
    tk = k.shape[1]
    d = hd // heads
    p = torch.softmax(_masked_scores(q, k, kv_mask, heads, scale, causal),
                      dim=-1)
    qf = q.float().reshape(b, tq, heads, d)
    kf = k.float().reshape(b, tk, heads, d)
    vf = v.float().reshape(b, tk, heads, d)
    gf = g.float().reshape(b, tq, heads, d)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(g.dtype).float(), gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds = ds.to(g.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return (dq.reshape(b, tq, hd).to(q.dtype),
            dk.reshape(b, tk, hd).to(k.dtype),
            dv.reshape(b, tk, hd).to(v.dtype))


def attention_bwd(q, k, v, kv_mask, out, lse, g, heads, scale, causal=False):
    """K7: (dq, dk, dv) for d(out) = g; see attention_bwd_plain.  `out` and
    `lse` are what attention_fwd(..., return_lse=True) returned for the same
    inputs.  CPU tensors take the plain version (which needs neither); CUDA
    tensors launch the kernel, which requires head_dim 64, one dtype
    (float32 or bfloat16), contiguous 16-byte-aligned slabs and a float32
    lse of shape (B, H, Tq)."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, kv_mask, g, heads, scale, causal)
    b, tq, hd = q.shape
    tk = k.shape[1]
    kv_mask, code = _check_slabs("attention_bwd", q, k, v, kv_mask, heads)
    check_cuda_tensor("out", out, q.dtype, (b, tq, hd), q.device)
    check_cuda_tensor("g", g, q.dtype, (b, tq, hd), q.device)
    check_cuda_tensor("lse", lse, torch.float32, (b, heads, tq), q.device)
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out), ("g", g)):
        check_aligned(name, t, 16)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    BWD_KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), g.data_ptr(), kv_mask.data_ptr(),
                      lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                      dk.data_ptr(), dv.data_ptr(), b, tq, tk, heads,
                      HEAD_DIM, float(scale), int(bool(causal)), code,
                      q.device.index)
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """attention_fwd with attention_bwd as its backward."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, heads, scale, causal):
        ctx.heads, ctx.scale, ctx.causal = heads, scale, causal
        if not any(ctx.needs_input_grad[:3]):
            return attention_fwd(q, k, v, kv_mask, heads, scale, causal)
        out, lse = attention_fwd(q, k, v, kv_mask, heads, scale, causal,
                                 return_lse=True)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, kv_mask, out, lse,
                                   g.to(q.dtype).contiguous(), ctx.heads,
                                   ctx.scale, ctx.causal)
        return dq, dk, dv, None, None, None, None


def attention_trainable(q, k, v, kv_mask, heads, scale, causal=False):
    """Differentiable masked MHA on (B, T, H*D) slabs: K1 forward (which
    also writes the row log-sum-exp when a gradient is wanted), K7 backward.
    Nothing of size (Tq, Tk) is kept for the backward."""
    return _Attention.apply(q, k, v, kv_mask, heads, scale, causal)
