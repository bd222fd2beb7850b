"""K2 and K3: a dense or FFN product fused with the post-LN residual +
LayerNorm epilogue.

``dense_res_ln`` (K2, ``csrc/dense_res_ln.cu``) replaces the TPU kernel
``speechmix_tpu/ops/pallas/ffn_kernel.py: dense_res_ln``;
``ffn_res_ln`` (K3, ``csrc/ffn_res_ln.cu``) replaces
``speechmix_tpu/ops/pallas/ffn_kernel.py: ffn_fused_res_ln``.  Each wrapper
launches its kernel for CUDA tensors and runs its plain PyTorch version,
which computes the same function with the kernel's f32 arithmetic, for CPU
tensors.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._cuda import CudaKernel, check_aligned, check_cuda_tensor, dtype_code

ACT_CODES = {"gelu": 0, "gelu_new": 1, "relu": 2, "silu": 3}
MAX_HIDDEN = 1024  # the kernels hold all h columns of a row tile
# widths the bfloat16 tensor-core kernels are instantiated for: the
# flagship's (wav2vec2-base, bart-base) and bart-large's
BF16_HIDDEN = (768, 1024)

DENSE_RES_LN = CudaKernel(
    "dense_res_ln.cu", "smx_dense_res_ln",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_float] +
    [ctypes.c_int] * 2)
FFN_RES_LN = CudaKernel(
    "ffn_res_ln.cu", "smx_ffn_res_ln",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_float] +
    [ctypes.c_int] * 2)


def act_f32(name, x):
    """The FFN activations on f32 values (exact-erf GELU for "gelu")."""
    if name == "gelu":
        return F.gelu(x)
    if name == "gelu_new":
        return F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu(x)
    if name == "silu":
        return F.silu(x)
    raise ValueError(f"unsupported activation {name!r}")


def _res_ln_f32(y, res, g, beta, eps):
    y = y + res.float()
    mu = y.mean(-1, keepdim=True)
    d = y - mu
    var = (d * d).mean(-1, keepdim=True)
    return d * torch.rsqrt(var + eps) * g.float() + beta.float()


def dense_res_ln_plain(x, w, b, res, g, beta, eps=1e-5):
    """LayerNorm(res + x @ w + b) * g + beta with f32 products and
    statistics, output in x's dtype.  x: (N, Din); w: (Din, H); res: (N, H);
    b, g, beta: (H,)."""
    y = x.float() @ w.float() + b.float()
    return _res_ln_f32(y, res, g, beta, eps).to(x.dtype)


def ffn_res_ln_plain(x, w1, b1, w2, b2, res, g, beta, act="gelu", eps=1e-5):
    """LayerNorm(res + act(x @ w1 + b1) @ w2 + b2) * g + beta with f32
    products; the intermediate is rounded to x's dtype before the second
    product, as the kernels do.  x, res: (N, H); w1: (H, F); w2: (F, H)."""
    h = act_f32(act, x.float() @ w1.float() + b1.float())
    h = h.to(x.dtype).float()
    y = h @ w2.float() + b2.float()
    return _res_ln_f32(y, res, g, beta, eps).to(x.dtype)


def _check_vec(name, t, size, device):
    check_cuda_tensor(name, t, torch.float32, (size,), device)


def dense_res_ln(x, w, b, res, g, beta, eps=1e-5):
    """K2; see dense_res_ln_plain.  CUDA tensors need x, w, res in one
    dtype (float32 or bfloat16), b, g, beta float32, H <= 1024; bfloat16
    needs H in BF16_HIDDEN, Din a multiple of 16 up to 1024, and x, w
    32-byte aligned."""
    if x.device.type == "cpu":
        return dense_res_ln_plain(x, w, b, res, g, beta, eps)
    n, din = x.shape
    h = w.shape[1]
    if h > MAX_HIDDEN:
        raise ValueError(f"dense_res_ln supports H <= {MAX_HIDDEN}, got {h}")
    if x.dtype == torch.bfloat16 and (h not in BF16_HIDDEN or din % 16
                                      or din > MAX_HIDDEN):
        raise ValueError(f"dense_res_ln in bfloat16 supports H in "
                         f"{BF16_HIDDEN} and Din a multiple of 16 up to "
                         f"{MAX_HIDDEN}, got Din={din}, H={h}")
    check_cuda_tensor("x", x)
    code = dtype_code(x.dtype)
    check_cuda_tensor("w", w, x.dtype, (din, h), x.device)
    check_cuda_tensor("res", res, x.dtype, (n, h), x.device)
    for name, t in (("b", b), ("g", g), ("beta", beta)):
        _check_vec(name, t, h, x.device)
    if x.dtype == torch.bfloat16:
        check_aligned("x", x, 32)
        check_aligned("w", w, 32)
    out = torch.empty_like(res)
    DENSE_RES_LN.launch(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                        res.data_ptr(), g.data_ptr(), beta.data_ptr(),
                        out.data_ptr(), n, din, h, float(eps), code,
                        x.device.index)
    return out


def ffn_res_ln(x, w1, b1, w2, b2, res, g, beta, act="gelu", eps=1e-5):
    """K3; see ffn_res_ln_plain.  CUDA tensors need x, w1, w2, res in one
    dtype (float32 or bfloat16), b1, b2, g, beta float32, H <= 1024;
    bfloat16 needs H in BF16_HIDDEN, F a multiple of 64, and x, w1, w2
    32-byte aligned."""
    if x.device.type == "cpu":
        return ffn_res_ln_plain(x, w1, b1, w2, b2, res, g, beta, act, eps)
    if act not in ACT_CODES:
        raise ValueError(f"unsupported activation {act!r}")
    n, h = x.shape
    f = w1.shape[1]
    if h > MAX_HIDDEN:
        raise ValueError(f"ffn_res_ln supports H <= {MAX_HIDDEN}, got {h}")
    if x.dtype == torch.bfloat16 and (h not in BF16_HIDDEN or f % 64):
        raise ValueError(f"ffn_res_ln in bfloat16 supports H in {BF16_HIDDEN}"
                         f" and F a multiple of 64, got H={h}, F={f}")
    check_cuda_tensor("x", x)
    code = dtype_code(x.dtype)
    check_cuda_tensor("w1", w1, x.dtype, (h, f), x.device)
    check_cuda_tensor("w2", w2, x.dtype, (f, h), x.device)
    check_cuda_tensor("res", res, x.dtype, (n, h), x.device)
    _check_vec("b1", b1, f, x.device)
    for name, t in (("b2", b2), ("g", g), ("beta", beta)):
        _check_vec(name, t, h, x.device)
    if x.dtype == torch.bfloat16:
        for name, t in (("x", x), ("w1", w1), ("w2", w2)):
            check_aligned(name, t, 32)
    out = torch.empty_like(res)
    FFN_RES_LN.launch(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                      w2.data_ptr(), b2.data_ptr(), res.data_ptr(),
                      g.data_ptr(), beta.data_ptr(), out.data_ptr(), n, h, f,
                      ACT_CODES[act], float(eps), code, x.device.index)
    return out
