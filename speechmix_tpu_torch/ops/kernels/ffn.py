"""K2, K3, K8 and K9: the dense and FFN products of a transformer block,
fused with the post-LN residual + LayerNorm epilogue (K2, K3) or without it
(K9), and the FFN backward (K8); and their dropout twins K11, K12, K13 and
K8 with the activation mask.

``dense_res_ln`` (K2, ``csrc/dense_res_ln.cu``) replaces the TPU kernel
``speechmix_tpu/ops/pallas/ffn_kernel.py: dense_res_ln``;
``ffn_res_ln`` (K3) replaces ``ffn_fused_res_ln`` of that file,
``ffn_fused`` (K9) ``ffn_fused``, and ``ffn_bwd`` (K8, ``csrc/ffn_bwd.cu``)
``ffn_fused_bwd``.  K2 in bfloat16 is one TMA + wgmma kernel whose
thread-block cluster of blocks 256 (or 128) columns wide reduces each
LayerNorm row across its blocks' shared memory (where the cluster would
pass 8 blocks, the down pass to the f32 sum and the row pass below).  K3
and K9 are passes of
``csrc/ffn_fwd.cu``, each a TMA + wgmma kernel or a row pass: ``ffn_up``
forms h = round(act(x @ w1 + b1)) (N, F) once, ``ffn_down`` takes h @ w2 +
b2 to the output (K9) or, with the residual, to an f32 sum z (K3), and
``res_ln_rows`` takes z to LayerNorm(z) * g + beta (K3).  In float32 the
same passes run in their f32 entries (``smx_ffn_up_f32``,
``smx_ffn_down_f32``, ``smx_ffn_down_res_f32``, ``smx_res_ln_rows_f32``),
with f32-accurate products on the tensor cores, three tf32 products each,
on w1^T and w2^T that the wrapper lays out per call; float32 K2 is the f32
down pass to z and the row pass behind one entry of ``ffn_fwd.cu``,
``smx_dense_res_ln_f32``.
K8 in bfloat16 is two entries: ``ffn_bwd_recompute`` forms h, da and da's
column sums per 128-row tile once, ``ffn_bwd_products`` runs dx, dw1 and
dw2 from them as one TMA + wgmma GEMM; K8 in float32 is the same two passes
(``smx_ffn_bwd_recompute_f32`` or its dropout twin, then
``smx_ffn_bwd_products_f32``) with f32-accurate products on the tensor
cores, three tf32 products each.  Each wrapper launches its kernel
for CUDA tensors and runs its plain PyTorch version, which computes the same
function with the kernel's f32 arithmetic, for CPU tensors.

``ffn_res_ln_trainable``, ``dense_res_ln_trainable`` and
``ffn_fused_trainable`` are the differentiable forms, counterparts of the TPU
package's functions of those names: K3's backward recomputes the
pre-LayerNorm sum through K9 and runs K8; K2's is plain matrix products, as
the TPU package has no kernel there (bfloat16 operands with f32 results on
the card, as its ``_dense_bwd_hand``); K9's is K8.  They take the weights as
stored (float32 master weights under bfloat16 compute) and cast inside, so a
weight gradient reaches its parameter in float32, unrounded.

The dropout twins draw their masks in the kernel from the port's generator
(``dropout.py``): the activation mask (stream 0) over (N, F), the output
mask (stream 1) over (N, H), keyed on (row, column).  ``dense_dropout_res_ln``
(K11, ``smx_dense_dropout_res_ln`` of ``dense_res_ln.cu``) replaces
``dense_dropout_res_ln_trainable``'s TPU kernel, ``ffn_dropout_res_ln`` (K12)
``ffn_dropout_res_ln_trainable``'s and ``ffn_dropout`` (K13)
``ffn_dropout_trainable``'s (bfloat16: the up pass with the activation mask,
then the down pass, with the output mask for K12, and for K12 the row pass;
float32: the same passes' f32 entries, and for K11
``smx_dense_dropout_res_ln_f32``); ``ffn_dropout_bwd`` (K8's
dropout recompute entry, or its f32 dropout entries, in ``ffn_bwd.cu``)
regenerates the activation mask in the backward, where the TPU package runs
XLA.  Their plain versions take explicit
masks (``*_plain(..., amask, omask)``), so a test can hand them any mask.
``ffn_dropout_res_ln_trainable``, ``dense_dropout_res_ln_trainable`` and
``ffn_dropout_trainable`` keep the key, not the masks, for the backward: K12's
backward recomputes the FFN through K13, regenerates the (N, H) output mask
with K10, and runs K8 with the activation mask; K11's regenerates its output mask
with K10 and runs plain matrix products.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ._cuda import CudaKernel, check_aligned, check_cuda_tensor, dtype_code
from .dropout import (STREAM_ACT, STREAM_OUT, DropoutKey, dropout_mask,
                      dropout_mask_plain, launch_args)

ACT_CODES = {"gelu": 0, "gelu_new": 1, "relu": 2, "silu": 3}
# the widest H that the f32 entries (the forward passes of K2 / K3 / K9 and
# their twins, K8's two passes) take: the widths the card checks them at
MAX_HIDDEN = 2048
# the bfloat16 forward passes of K3 / K9 / K12 / K13 and K2 / K11, and K8's
# bfloat16 backward, take widths H (and, for the forward, F) that are
# multiples of this (their TMA + wgmma tiles), as the TPU package's gate
# does; K8 takes F a multiple of 64
FWD_WIDTH = 128
# K2 / K11 in bfloat16: a cluster of blocks 256 columns wide (128 where 256
# does not divide H) reduces each LayerNorm row, at most 8 blocks (the
# portable cluster size); wider rows take the down pass to the f32 sum and
# the LayerNorm rows of ffn_fwd.cu
DENSE_MAX_CLUSTER = 8


def dense_fused(h):
    """Whether K2 / K11 in bfloat16 run as the one cluster kernel at width
    h (a multiple of FWD_WIDTH)."""
    block = 2 * FWD_WIDTH if h % (2 * FWD_WIDTH) == 0 else FWD_WIDTH
    return h <= DENSE_MAX_CLUSTER * block


# K2 in bfloat16: the cluster kernel
DENSE_RES_LN = CudaKernel(
    "dense_res_ln.cu", "smx_dense_res_ln",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_float] +
    [ctypes.c_int])
# the dropout twins: the deterministic entry's arguments, then the site key's
# two words and each mask's (threshold, scale) before the device
_KEY = [ctypes.c_uint32, ctypes.c_uint32]
_MASK = [ctypes.c_uint32, ctypes.c_float]
DENSE_DROPOUT_RES_LN = CudaKernel(
    "dense_res_ln.cu", "smx_dense_dropout_res_ln",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_float] + _KEY +
    _MASK + [ctypes.c_int])
# K8 in bfloat16: the recompute pass (h, da and da's column sums per row
# tile, once) and the products (dx, dw1, dw2, db1 from them)
FFN_BWD_RECOMPUTE = CudaKernel(
    "ffn_bwd.cu", "smx_ffn_bwd_recompute",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5)
FFN_DROPOUT_BWD_RECOMPUTE = CudaKernel(
    "ffn_bwd.cu", "smx_ffn_dropout_bwd_recompute",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + _KEY + _MASK +
    [ctypes.c_int])
FFN_BWD_PRODUCTS = CudaKernel(
    "ffn_bwd.cu", "smx_ffn_bwd_products",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6)
# K8 in float32: the same two passes with f32-accurate products on the
# tensor cores (three tf32 products each); the recompute also writes da^T
# and h^T, the products read x^T and g^T (K-major operands)
FFN_BWD_RECOMPUTE_F32 = CudaKernel(
    "ffn_bwd.cu", "smx_ffn_bwd_recompute_f32",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6)
FFN_DROPOUT_BWD_RECOMPUTE_F32 = CudaKernel(
    "ffn_bwd.cu", "smx_ffn_dropout_bwd_recompute_f32",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + _KEY + _MASK +
    [ctypes.c_int])
FFN_BWD_PRODUCTS_F32 = CudaKernel(
    "ffn_bwd.cu", "smx_ffn_bwd_products_f32",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7)
# the bfloat16 forward passes of K3 / K9 (ffn_fwd.cu): up (K13 / K12: with the
# activation mask), down to the output (K9 / K13) or to the f32 sum z before
# the LayerNorm (K3; K12: with the output mask), and the LayerNorm rows
FFN_UP = CudaKernel(
    "ffn_fwd.cu", "smx_ffn_up", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5)
FFN_DROPOUT_UP = CudaKernel(
    "ffn_fwd.cu", "smx_ffn_dropout_up",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + _KEY + _MASK +
    [ctypes.c_int])
FFN_DOWN = CudaKernel(
    "ffn_fwd.cu", "smx_ffn_down", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4)
FFN_DOWN_RES = CudaKernel(
    "ffn_fwd.cu", "smx_ffn_down_res",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4)
FFN_DROPOUT_DOWN_RES = CudaKernel(
    "ffn_fwd.cu", "smx_ffn_dropout_down_res",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + _KEY + _MASK +
    [ctypes.c_int])
RES_LN_ROWS = CudaKernel(
    "ffn_fwd.cu", "smx_res_ln_rows",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float] +
    [ctypes.c_int])
# the same passes in float32 (K3 / K9 / K12 / K13): f32-accurate products on
# the tensor cores (three tf32 products), on w1^T and w2^T; the row pass
# takes the true H beside the row stride of zero-padded rows
FFN_UP_F32 = CudaKernel(
    "ffn_fwd.cu", "smx_ffn_up_f32", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5)
FFN_DROPOUT_UP_F32 = CudaKernel(
    "ffn_fwd.cu", "smx_ffn_dropout_up_f32",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + _KEY + _MASK +
    [ctypes.c_int])
FFN_DOWN_F32 = CudaKernel(
    "ffn_fwd.cu", "smx_ffn_down_f32",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4)
FFN_DOWN_RES_F32 = CudaKernel(
    "ffn_fwd.cu", "smx_ffn_down_res_f32",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4)
FFN_DROPOUT_DOWN_RES_F32 = CudaKernel(
    "ffn_fwd.cu", "smx_ffn_dropout_down_res_f32",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + _KEY + _MASK +
    [ctypes.c_int])
RES_LN_ROWS_F32 = CudaKernel(
    "ffn_fwd.cu", "smx_res_ln_rows_f32",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float] +
    [ctypes.c_int])
# K2 / K11 in float32: the f32 down pass to z on x and w^T, then the f32
# row pass, behind one entry (z a workspace of the wrapper)
DENSE_RES_LN_F32 = CudaKernel(
    "ffn_fwd.cu", "smx_dense_res_ln_f32",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float] +
    [ctypes.c_int])
DENSE_DROPOUT_RES_LN_F32 = CudaKernel(
    "ffn_fwd.cu", "smx_dense_dropout_res_ln_f32",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float] + _KEY +
    _MASK + [ctypes.c_int])
# rows of a recompute tile, each giving one row of da's column sums
ROW_TILE = 128
# K8's weight gradients sum over the rows in at most DW_MAX_SPLITS fixed
# ranges of about this many rows, added in range order; the f32 products,
# three tf32 products to each bf16 one, take shorter ranges, so that the
# f32 gradients' 1024-3200 rows still fill the card with blocks
DW_MAX_SPLITS = 8
DW_ROWS_PER_SPLIT = 3200
DW_ROWS_PER_SPLIT_F32 = 1024
DW_SPLIT_ALIGN = 64   # rows: one stage of the products kernel


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


def _ln_f32(z, g, beta, eps):
    mu = z.mean(-1, keepdim=True)
    d = z - mu
    var = (d * d).mean(-1, keepdim=True)
    return d * torch.rsqrt(var + eps) * g.float() + beta.float()


def _res_ln_f32(y, res, g, beta, eps):
    return _ln_f32(y + res.float(), g, beta, eps)


def dense_res_ln_plain(x, w, b, res, g, beta, eps=1e-5):
    """LayerNorm(res + x @ w + b) * g + beta with f32 products and
    statistics, output in x's dtype.  x: (N, Din); w: (Din, H); res: (N, H);
    b, g, beta: (H,)."""
    return dense_dropout_res_ln_plain(x, w, b, res, g, beta, None, eps)


def dense_dropout_res_ln_plain(x, w, b, res, g, beta, omask, eps=1e-5):
    """LayerNorm(res + (x @ w + b) * omask) * g + beta, as
    dense_res_ln_plain; omask: (N, H) float32 or None (no dropout)."""
    y = x.float() @ w.float() + b.float()
    if omask is not None:
        y = y * omask
    return _res_ln_f32(y, res, g, beta, eps).to(x.dtype)


def dense_res_ln_tiled_plain(x, w, b, res, g, beta, omask=None, eps=1e-5):
    """dense_dropout_res_ln_plain as the bfloat16 kernel reduces its rows:
    z = (x @ w + b) * omask + res in f32, cut into column slices of
    FWD_WIDTH (a block of the cluster holds one or two); the slices' row
    sums, added in slice order and times 1 / H, give the mean, then the
    sums of the squared centred values, likewise, the variance."""
    z = x.float() @ w.float() + b.float()
    if omask is not None:
        z = z * omask
    z = z + res.float()
    inv_h = 1.0 / z.shape[1]

    def row_sum(t):
        total = torch.zeros(t.shape[0], dtype=torch.float32, device=t.device)
        for part in t.split(FWD_WIDTH, dim=1):
            total = total + part.sum(1)
        return total[:, None]

    d = z - row_sum(z) * inv_h
    inv = torch.rsqrt(row_sum(d * d) * inv_h + eps)
    return (d * inv * g.float() + beta.float()).to(x.dtype)


def _hidden(x, w1, b1, act, amask):
    """round(act(x @ w1 + b1) * amask) in f32, round() to x's dtype."""
    h = act_f32(act, x.float() @ w1.float() + b1.float())
    if amask is not None:
        h = h * amask
    return h.to(x.dtype).float()


def ffn_res_ln_plain(x, w1, b1, w2, b2, res, g, beta, act="gelu", eps=1e-5):
    """LayerNorm(res + act(x @ w1 + b1) @ w2 + b2) * g + beta with f32
    products; the intermediate is rounded to x's dtype before the second
    product, as the kernels do.  x, res: (N, H); w1: (H, F); w2: (F, H)."""
    return ffn_dropout_res_ln_plain(x, w1, b1, w2, b2, res, g, beta, None,
                                    None, act, eps)


def ffn_dropout_res_ln_plain(x, w1, b1, w2, b2, res, g, beta, amask, omask,
                             act="gelu", eps=1e-5):
    """LayerNorm(res + (round(act(x @ w1 + b1) * amask) @ w2 + b2) * omask)
    * g + beta, as ffn_res_ln_plain; amask: (N, F), omask: (N, H), float32
    or None."""
    y = _hidden(x, w1, b1, act, amask) @ w2.float() + b2.float()
    if omask is not None:
        y = y * omask
    return _res_ln_f32(y, res, g, beta, eps).to(x.dtype)


def _check_vec(name, t, size, device):
    check_cuda_tensor(name, t, torch.float32, (size,), device)


def dense_res_ln(x, w, b, res, g, beta, eps=1e-5):
    """K2; see dense_res_ln_plain.  CUDA tensors need x, w, res in one
    dtype (float32 or bfloat16), b, g, beta float32; float32 needs H <=
    2048 and runs the f32 down pass to z and the LayerNorm rows (one entry,
    _f32_dense); bfloat16 Din and H multiples of FWD_WIDTH and x, w, res, g,
    beta 16-byte aligned, and runs one kernel where dense_fused(H), else the
    down pass to the f32 sum and the LayerNorm rows."""
    if x.device.type == "cpu":
        return dense_res_ln_plain(x, w, b, res, g, beta, eps)
    n, din = x.shape
    h = w.shape[1]
    _check_dense("dense_res_ln", x, w, b, res, g, beta)
    if x.dtype == torch.float32:
        return _f32_dense(x, w, b, res, g, beta, eps)
    if not dense_fused(h):
        return res_ln_rows(ffn_down(x, w, b, res), g, beta, eps)
    out = torch.empty_like(res)
    DENSE_RES_LN.launch(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                        res.data_ptr(), g.data_ptr(), beta.data_ptr(),
                        out.data_ptr(), n, din, h, float(eps), x.device.index)
    return out


def _check_dense(what, x, w, b, res, g, beta):
    """Shared checks of the K2 / K11 wrappers."""
    n, din = x.shape
    h = w.shape[1]
    bf16 = x.dtype == torch.bfloat16
    if not bf16 and h > MAX_HIDDEN:
        raise ValueError(f"{what} supports H <= {MAX_HIDDEN}, got {h}")
    if bf16 and (h % FWD_WIDTH or din % FWD_WIDTH):
        raise ValueError(f"{what} in bfloat16 supports H and Din multiples "
                         f"of {FWD_WIDTH}, got Din={din}, H={h}")
    check_cuda_tensor("x", x)
    dtype_code(x.dtype)
    check_cuda_tensor("w", w, x.dtype, (din, h), x.device)
    check_cuda_tensor("res", res, x.dtype, (n, h), x.device)
    for name, t in (("b", b), ("g", g), ("beta", beta)):
        _check_vec(name, t, h, x.device)
    if bf16:
        for name, t in (("x", x), ("w", w), ("res", res), ("g", g),
                        ("beta", beta)):
            check_aligned(name, t, 16)


def ffn_res_ln(x, w1, b1, w2, b2, res, g, beta, act="gelu", eps=1e-5):
    """K3; see ffn_res_ln_plain.  CUDA tensors need x, w1, w2, res in one
    dtype (float32 or bfloat16), b1, b2, g, beta float32; float32 needs
    H <= 2048, bfloat16 H and F multiples of FWD_WIDTH and x, w1, w2 16-byte
    aligned.  Both run the up pass, the down pass to the f32 sum and the
    LayerNorm rows (three launches; float32 their f32 entries)."""
    if x.device.type == "cpu":
        return ffn_res_ln_plain(x, w1, b1, w2, b2, res, g, beta, act, eps)
    n, h, _ = _check_ffn("ffn_res_ln", x, w1, b1, w2, act)
    check_cuda_tensor("res", res, x.dtype, (n, h), x.device)
    for name, t in (("b2", b2), ("g", g), ("beta", beta)):
        _check_vec(name, t, h, x.device)
    if x.dtype == torch.float32:
        return _f32_ffn(x, w1, b1, w2, b2, act, res=res, g=g, beta=beta,
                        eps=eps)
    z = ffn_down(ffn_up(x, w1, b1, act), w2, b2, res)
    return res_ln_rows(z, g, beta, eps)


# ------------------------------------------- the float32 forward's passes
def _up4(n):
    return -(-n // 4) * 4


def _padded(t, cols, rows=None):
    """t (a vector or a matrix) with zero columns up to `cols` (and zero
    rows up to `rows`), contiguous and 16-byte aligned for the TMA (a copy
    where it is not so already)."""
    pc = cols - t.shape[-1]
    pr = 0 if rows is None else rows - t.shape[0]
    if pc or pr:
        t = F.pad(t, (0, pc) if t.dim() == 1 else (0, pc, 0, pr))
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _f32_ffn(x, w1, b1, w2, b2, act, key=None, act_rate=0.0, res=None,
             g=None, beta=None, out_rate=0.0, eps=1e-5):
    """K9 / K13 (no res) and K3 / K12 in float32 on the card: the f32 up
    pass h = act(x @ w1 + b1) (N, F) in f32, unrounded (with the
    activation mask of (key, STREAM_ACT) where act_rate > 0), then the f32
    down pass to the output, or with res to the f32 sum z (with the output
    mask of (key, STREAM_OUT) where out_rate > 0) and the f32 row pass.
    The passes read w1^T and w2^T (tf32 products take K-major operands),
    laid out here per call; H and F are padded to multiples of 4 (16-byte
    TMA strides) with zero columns, which change no sum (act(0) = 0), and
    the row pass takes the true H."""
    n, h = x.shape
    f = w1.shape[1]
    hp, fp = _up4(h), _up4(f)
    dev = x.device
    x = _padded(x, hp)
    w1t = _padded(w1, fp, hp).t().contiguous()
    b1 = _padded(b1, fp)
    hid = torch.empty(n, fp, dtype=torch.float32, device=dev)
    ptrs = (x.data_ptr(), w1t.data_ptr(), b1.data_ptr(), hid.data_ptr(), n,
            hp, fp, ACT_CODES[act])
    if key is not None and act_rate > 0.0:
        FFN_DROPOUT_UP_F32.launch(*ptrs, *launch_args(key, act_rate),
                                  dev.index)
    else:
        FFN_UP_F32.launch(*ptrs, dev.index)
    del w1t
    w2t = _padded(w2, hp, fp).t().contiguous()
    b2 = _padded(b2, hp)
    out = torch.empty(n, hp, dtype=torch.float32, device=dev)
    if res is None:
        FFN_DOWN_F32.launch(hid.data_ptr(), w2t.data_ptr(), b2.data_ptr(),
                            out.data_ptr(), n, hp, fp, dev.index)
    else:
        res = _padded(res, hp)
        z = torch.empty_like(out)
        ptrs = (hid.data_ptr(), w2t.data_ptr(), b2.data_ptr(), res.data_ptr(),
                z.data_ptr(), n, hp, fp)
        if key is not None and out_rate > 0.0:
            FFN_DROPOUT_DOWN_RES_F32.launch(*ptrs, *launch_args(key, out_rate),
                                            dev.index)
        else:
            FFN_DOWN_RES_F32.launch(*ptrs, dev.index)
        del hid
        g, beta = _padded(g, hp), _padded(beta, hp)
        RES_LN_ROWS_F32.launch(z.data_ptr(), g.data_ptr(), beta.data_ptr(),
                               out.data_ptr(), n, h, hp, float(eps),
                               dev.index)
    return out if hp == h else out[:, :h].contiguous()


def _f32_dense(x, w, b, res, g, beta, eps, key=None, rate=None):
    """K2 (K11 where `rate` is given: the output mask of (key, STREAM_OUT),
    its entry launched at any rate, as bfloat16's cluster kernel is) in
    float32 on the card: one entry, the f32 down pass z = (x @ w + b) * m +
    res on w^T (laid out here per call), then the f32 row pass; Din and H
    are padded to multiples of 4 with zero columns as in _f32_ffn."""
    n, din = x.shape
    h = w.shape[1]
    dp, hp = _up4(din), _up4(h)
    dev = x.device
    x, wt = _padded(x, dp), _padded(w, hp, dp).t().contiguous()
    b, res, g, beta = (_padded(t, hp) for t in (b, res, g, beta))
    z = torch.empty(n, hp, dtype=torch.float32, device=dev)
    out = torch.empty_like(z)
    ptrs = (x.data_ptr(), wt.data_ptr(), b.data_ptr(), res.data_ptr(),
            g.data_ptr(), beta.data_ptr(), z.data_ptr(), out.data_ptr(), n,
            dp, h, hp, float(eps))
    if rate is None:
        DENSE_RES_LN_F32.launch(*ptrs, dev.index)
    else:
        DENSE_DROPOUT_RES_LN_F32.launch(*ptrs, *launch_args(key, rate),
                                        dev.index)
    return out if hp == h else out[:, :h].contiguous()


# ------------------------------------------- the bf16 forward's passes
def ffn_up_plain(x, w1, b1, act="gelu", amask=None):
    """The up pass: h = round(act(x @ w1 + b1) * amask) (N, F) in x's dtype,
    the product and the activation in f32; amask (N, F) float32 or None."""
    h = act_f32(act, x.float() @ w1.float() + b1.float())
    if amask is not None:
        h = h * amask
    return h.to(x.dtype)


def ffn_down_plain(hid, w2, b2, res=None, omask=None):
    """The down pass: y = (hid @ w2 + b2) * omask in f32; without res
    round(y) in hid's dtype (K9), with res (N, H) the f32 sum z = y + res
    (K3, before its LayerNorm); omask (N, H) float32 or None."""
    y = hid.float() @ w2.float() + b2.float()
    if omask is not None:
        y = y * omask
    if res is None:
        return y.to(hid.dtype)
    return y + res.float()


def res_ln_rows_plain(z, g, beta, eps=1e-5, dtype=torch.bfloat16):
    """The row pass: round(LayerNorm(z) * g + beta) in `dtype`, the mean and
    then the variance of the centred values of each f32 row of z."""
    return _ln_f32(z, g, beta, eps).to(dtype)


def _check_pass(what, a, w, bias):
    """Checks of an up or down pass: a (N, K) and w (K, C) bfloat16 CUDA
    tensors, K and C multiples of FWD_WIDTH, both 16-byte aligned (TMA),
    bias (C,) float32.  Returns (N, K, C)."""
    check_cuda_tensor("a", a)
    _require_bf16(what, a)
    n, k = a.shape
    c = w.shape[1]
    if k % FWD_WIDTH or c % FWD_WIDTH:
        raise ValueError(f"{what} takes widths that are multiples of "
                         f"{FWD_WIDTH}, got {k} and {c}")
    check_cuda_tensor("w", w, a.dtype, (k, c), a.device)
    _check_vec("bias", bias, c, a.device)
    check_aligned("a", a, 16)
    check_aligned("w", w, 16)
    return n, k, c


def ffn_up(x, w1, b1, act="gelu", key=None, rate=0.0):
    """The up pass (with the activation mask of (key, STREAM_ACT) at `rate`
    > 0, K13's and K12's); see ffn_up_plain.  CUDA tensors: bfloat16 x (N,
    H), w1 (H, F), b1 (F,) float32, H and F multiples of FWD_WIDTH."""
    drop = key is not None and rate > 0.0
    if x.device.type == "cpu":
        return ffn_up_plain(x, w1, b1, act, _mask_plain(
            key, STREAM_ACT, x.shape[0], w1.shape[1], rate, x.device)
            if drop else None)
    if act not in ACT_CODES:
        raise ValueError(f"unsupported activation {act!r}")
    n, h, f = _check_pass("ffn_up", x, w1, b1)
    hid = torch.empty(n, f, dtype=x.dtype, device=x.device)
    ptrs = (x.data_ptr(), w1.data_ptr(), b1.data_ptr(), hid.data_ptr(), n, h,
            f, ACT_CODES[act])
    if drop:
        FFN_DROPOUT_UP.launch(*ptrs, *launch_args(key, rate), x.device.index)
    else:
        FFN_UP.launch(*ptrs, x.device.index)
    return hid


def ffn_down(hid, w2, b2, res=None, key=None, rate=0.0):
    """The down pass; see ffn_down_plain.  With res, the f32 sum z (K3), and
    the output mask of (key, STREAM_OUT) at `rate` > 0 (K12's; the mask is
    taken with res only).  CUDA tensors: bfloat16 hid (N, F), w2 (F, H), res
    (N, H), b2 (H,) float32, H and F multiples of FWD_WIDTH."""
    drop = key is not None and rate > 0.0
    if drop and res is None:
        raise ValueError("ffn_down takes the output mask with res only")
    if hid.device.type == "cpu":
        return ffn_down_plain(hid, w2, b2, res, _mask_plain(
            key, STREAM_OUT, hid.shape[0], w2.shape[1], rate, hid.device)
            if drop else None)
    n, f, h = _check_pass("ffn_down", hid, w2, b2)
    if res is None:
        out = torch.empty(n, h, dtype=hid.dtype, device=hid.device)
        FFN_DOWN.launch(hid.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                        out.data_ptr(), n, h, f, hid.device.index)
        return out
    check_cuda_tensor("res", res, hid.dtype, (n, h), hid.device)
    check_aligned("res", res, 16)
    z = torch.empty(n, h, dtype=torch.float32, device=hid.device)
    ptrs = (hid.data_ptr(), w2.data_ptr(), b2.data_ptr(), res.data_ptr(),
            z.data_ptr(), n, h, f)
    if drop:
        FFN_DROPOUT_DOWN_RES.launch(*ptrs, *launch_args(key, rate),
                                    hid.device.index)
    else:
        FFN_DOWN_RES.launch(*ptrs, hid.device.index)
    return z


def res_ln_rows(z, g, beta, eps=1e-5):
    """The row pass to bfloat16; see res_ln_rows_plain.  CUDA tensors: z (N,
    H) float32, H a multiple of 4, g, beta (H,) float32."""
    if z.device.type == "cpu":
        return res_ln_rows_plain(z, g, beta, eps)
    check_cuda_tensor("z", z, torch.float32)
    n, h = z.shape
    if h % 4:
        raise ValueError(f"res_ln_rows takes H a multiple of 4, got {h}")
    for name, t in (("z", z), ("g", g), ("beta", beta)):
        if t is not z:
            _check_vec(name, t, h, z.device)
        check_aligned(name, t, 16)
    out = torch.empty(n, h, dtype=torch.bfloat16, device=z.device)
    RES_LN_ROWS.launch(z.data_ptr(), g.data_ptr(), beta.data_ptr(),
                       out.data_ptr(), n, h, float(eps), z.device.index)
    return out


def dact_f32(name, a):
    """d act(a) / da on f32 values, in the closed forms of the TPU package's
    ``_dact_f32``."""
    if name == "gelu":
        pdf = torch.exp(-0.5 * a * a) * (1.0 / math.sqrt(2.0 * math.pi))
        return 0.5 * (1.0 + torch.erf(a * (1.0 / math.sqrt(2.0)))) + a * pdf
    if name == "gelu_new":
        c = math.sqrt(2.0 / math.pi)
        t = torch.tanh(c * (a + 0.044715 * a * a * a))
        return 0.5 * (1.0 + t) + 0.5 * a * (1.0 - t * t) * c * \
            (1.0 + 3 * 0.044715 * a * a)
    if name == "relu":
        return (a > 0).float()
    if name == "silu":
        s = torch.sigmoid(a)
        return s * (1.0 + a * (1.0 - s))
    raise ValueError(f"unsupported activation {name!r}")


def ln_bwd(grad, y_pre, g, eps):
    """Backward of LayerNorm(y_pre) * g + beta for d(out) = grad: returns
    (dy_pre, dgamma, dbeta), all float32, row-local."""
    grad = grad.float()
    y = y_pre.float()
    d = y - y.mean(-1, keepdim=True)
    inv = torch.rsqrt((d * d).mean(-1, keepdim=True) + eps)
    xhat = d * inv
    dgamma = (grad * xhat).sum(0)
    dbeta = grad.sum(0)
    gg = grad * g.float()
    dy = inv * (gg - gg.mean(-1, keepdim=True) -
                xhat * (gg * xhat).mean(-1, keepdim=True))
    return dy, dgamma, dbeta


def ffn_fused_plain(x, w1, b1, w2, b2, act="gelu"):
    """act(x @ w1 + b1) @ w2 + b2 with f32 products; the intermediate is
    rounded to x's dtype before the second product, the output once."""
    return ffn_dropout_plain(x, w1, b1, w2, b2, None, act)


def ffn_dropout_plain(x, w1, b1, w2, b2, amask, act="gelu"):
    """round(act(x @ w1 + b1) * amask) @ w2 + b2, as ffn_fused_plain;
    amask: (N, F) float32 or None."""
    h = _hidden(x, w1, b1, act, amask)
    return (h @ w2.float() + b2.float()).to(x.dtype)


def _check_ffn(what, x, w1, b1, w2, act, k8=False):
    """Shared checks of the K3 / K8 / K9 wrappers; returns (n, h, f).
    float32: H <= MAX_HIDDEN.  bfloat16: the forward (K3, K9 and their
    twins) takes H and F multiples of FWD_WIDTH and 16-byte aligned
    operands; K8 (`k8`) H a multiple of FWD_WIDTH, F a multiple of 64 and
    32-byte aligned operands."""
    if act not in ACT_CODES:
        raise ValueError(f"unsupported activation {act!r}")
    n, h = x.shape
    f = w1.shape[1]
    bf16 = x.dtype == torch.bfloat16
    if not bf16 and h > MAX_HIDDEN:
        raise ValueError(f"{what} supports H <= {MAX_HIDDEN}, got {h}")
    if bf16 and k8:
        _check_k8_widths(what, h, f)
    if bf16 and not k8 and (h % FWD_WIDTH or f % FWD_WIDTH):
        raise ValueError(f"{what} in bfloat16 supports H and F multiples "
                         f"of {FWD_WIDTH}, got H={h}, F={f}")
    check_cuda_tensor("x", x)
    dtype_code(x.dtype)
    check_cuda_tensor("w1", w1, x.dtype, (h, f), x.device)
    check_cuda_tensor("w2", w2, x.dtype, (f, h), x.device)
    _check_vec("b1", b1, f, x.device)
    if bf16:
        for name, t in (("x", x), ("w1", w1), ("w2", w2)):
            check_aligned(name, t, 32 if k8 else 16)
    return n, h, f


def _check_k8_widths(what, h, f):
    if h % FWD_WIDTH or f % 64:
        raise ValueError(f"{what} in bfloat16 supports H a multiple of "
                         f"{FWD_WIDTH} and F a multiple of 64, got H={h}, "
                         f"F={f}")


def ffn_fused(x, w1, b1, w2, b2, act="gelu"):
    """K9; see ffn_fused_plain.  The same dtype and width rules as
    ffn_res_ln; it runs the up pass and the down pass (two launches;
    float32 their f32 entries)."""
    if x.device.type == "cpu":
        return ffn_fused_plain(x, w1, b1, w2, b2, act)
    _, h, _ = _check_ffn("ffn_fused", x, w1, b1, w2, act)
    _check_vec("b2", b2, h, x.device)
    if x.dtype == torch.float32:
        return _f32_ffn(x, w1, b1, w2, b2, act)
    return ffn_down(ffn_up(x, w1, b1, act), w2, b2)


def _hidden_and_da(x, g, w1, b1, w2, act, amask=None):
    """f32 views of x and g, h = round(act(a) * amask) and da = round(g @
    w2^T * act'(a) * amask) for a = x @ w1 + b1 in f32, round() to x's
    dtype (no amask: no dropout)."""
    xf, gf = x.float(), g.to(x.dtype).float()
    a = xf @ w1.float() + b1.float()
    hid = act_f32(act, a)
    da = gf @ w2.float().t() * dact_f32(act, a)
    if amask is not None:
        hid, da = hid * amask, da * amask
    return xf, gf, hid.to(x.dtype).float(), da.to(x.dtype).float()


def ffn_bwd_dx_plain(x, g, w1, b1, w2, act="gelu", amask=None):
    """dx = da @ w1^T in x's dtype (see ffn_bwd_plain)."""
    _, _, _, da = _hidden_and_da(x, g, w1, b1, w2, act, amask)
    return (da @ w1.float().t()).to(x.dtype)


def ffn_bwd_dw_plain(x, g, w1, b1, w2, act="gelu", amask=None):
    """(dw1, db1, dw2) = (x^T da, sum da, h^T g), float32 (see
    ffn_bwd_plain)."""
    xf, gf, hid, da = _hidden_and_da(x, g, w1, b1, w2, act, amask)
    return xf.t() @ da, da.sum(0), hid.t() @ gf


def ffn_bwd_plain(x, g, w1, b1, w2, act="gelu", amask=None):
    """Backward of y = act(x @ w1 + b1) @ w2 + b2 for dy = g: returns
    (dx, dw1, db1, dw2, db2), dx in x's dtype and the rest float32.  With
    a = x @ w1 + b1 in f32: h = round(act(a)), da = round(g @ w2^T *
    act'(a)), round() to x's dtype; dx = da @ w1^T, dw1 = x^T da,
    dw2 = h^T g, db1 = sum da, db2 = sum g, all sums f32.  With amask
    (N, F), the backward of y = (act(x @ w1 + b1) * amask) @ w2 + b2: h and
    da carry the mask."""
    dw1, db1, dw2 = ffn_bwd_dw_plain(x, g, w1, b1, w2, act, amask)
    return (ffn_bwd_dx_plain(x, g, w1, b1, w2, act, amask), dw1, db1, dw2,
            g.to(x.dtype).float().sum(0))


def dw_split_plan(n, rows_per_split=None):
    """(splits, rows): the fixed row ranges [s * rows, min(n, (s + 1) *
    rows)) over which K8 sums its weight gradients, about rows_per_split
    (default DW_ROWS_PER_SPLIT) rows each, at most DW_MAX_SPLITS of them,
    each a multiple of DW_SPLIT_ALIGN rows long and none empty."""
    rows_per_split = rows_per_split or DW_ROWS_PER_SPLIT
    splits = min(DW_MAX_SPLITS, -(-n // rows_per_split))
    rows = -(-(-(-n // splits)) // DW_SPLIT_ALIGN) * DW_SPLIT_ALIGN
    return -(-n // rows), rows


def ffn_bwd_recompute_plain(x, g, w1, b1, w2, act="gelu", amask=None):
    """K8's recompute pass: (h, da, colsum) with h = round(act(a) * amask),
    da = round(g @ w2^T * act'(a) * amask) in x's dtype, (N, F) each, and
    colsum (ceil(N / ROW_TILE), F) float32, the column sums of da over each
    ROW_TILE-row tile."""
    _, _, hid, da = _hidden_and_da(x, g, w1, b1, w2, act, amask)
    n, f = da.shape
    tiles = -(-n // ROW_TILE)
    pad = da.new_zeros(tiles * ROW_TILE - n, f)
    colsum = torch.cat([da, pad]).view(tiles, ROW_TILE, f).sum(1)
    return hid.to(x.dtype), da.to(x.dtype), colsum


def _ordered_sum(parts):
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def ffn_bwd_products_plain(x, g, w1, hid, da, colsum):
    """K8's products from the recompute's (hid, da, colsum): (dx, dw1, db1,
    dw2) with dx = da @ w1^T in x's dtype, dw1 = x^T da, dw2 = hid^T g, the
    two summed over the row ranges of dw_split_plan in range order, and db1
    the sum of colsum's rows in order, all float32."""
    dx = (da.float() @ w1.float().t()).to(x.dtype)
    splits, rows = dw_split_plan(x.shape[0])
    cuts = [slice(s * rows, (s + 1) * rows) for s in range(splits)]
    dw1 = _ordered_sum([x[c].float().t() @ da[c].float() for c in cuts])
    dw2 = _ordered_sum([hid[c].float().t() @ g[c].float() for c in cuts])
    return dx, dw1, _ordered_sum(list(colsum)), dw2


def _check_ffn_bwd(what, x, g, w1, b1, w2, act):
    if x.dtype == torch.float32 and w1.shape[1] % 16:
        raise ValueError(f"{what} in float32 supports F a multiple of 16, "
                         f"got F={w1.shape[1]}")
    n, h, f = _check_ffn(what, x, w1, b1, w2, act, k8=True)
    check_cuda_tensor("g", g, x.dtype, (n, h), x.device)
    if x.dtype == torch.bfloat16:
        check_aligned("g", g, 32)
    else:   # TMA loads
        for name, t in (("x", x), ("g", g), ("w1", w1), ("w2", w2)):
            check_aligned(name, t, 16)
    return n, h, f


def ffn_bwd_recompute(x, g, w1, b1, w2, act="gelu", key=None, rate=0.0):
    """K8's recompute entry (its dropout twin with the activation mask of
    (key, STREAM_ACT) at `rate` > 0); see ffn_bwd_recompute_plain.  CUDA
    tensors: bfloat16 only, with the rules of ffn_bwd."""
    drop = key is not None and rate > 0.0
    if x.device.type == "cpu":
        return ffn_bwd_recompute_plain(x, g, w1, b1, w2, act, _mask_plain(
            key, STREAM_ACT, x.shape[0], w1.shape[1], rate, x.device)
            if drop else None)
    n, h, f = _check_ffn_bwd("ffn_bwd_recompute", x, g, w1, b1, w2, act)
    _require_bf16("ffn_bwd_recompute", x)
    hid = torch.empty(n, f, dtype=x.dtype, device=x.device)
    da = torch.empty_like(hid)
    colsum = torch.empty(-(-n // ROW_TILE), f, dtype=torch.float32,
                         device=x.device)
    ptrs = (x.data_ptr(), g.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), hid.data_ptr(), da.data_ptr(), colsum.data_ptr(),
            n, h, f, ACT_CODES[act])
    if drop:
        FFN_DROPOUT_BWD_RECOMPUTE.launch(*ptrs, *launch_args(key, rate),
                                         x.device.index)
    else:
        FFN_BWD_RECOMPUTE.launch(*ptrs, x.device.index)
    return hid, da, colsum


def ffn_bwd_products(x, g, w1, hid, da, colsum):
    """K8's products entry; see ffn_bwd_products_plain.  CUDA tensors:
    bfloat16 x, g (N, H), w1 (H, F), hid, da (N, F), colsum float32
    (ceil(N / ROW_TILE), F), with the width rules of ffn_bwd."""
    if x.device.type == "cpu":
        return ffn_bwd_products_plain(x, g, w1, hid, da, colsum)
    check_cuda_tensor("x", x)
    _require_bf16("ffn_bwd_products", x)
    n, h = x.shape
    f = w1.shape[1]
    _check_k8_widths("ffn_bwd_products", h, f)
    for name, t, shape in (("g", g, (n, h)), ("w1", w1, (h, f)),
                           ("hid", hid, (n, f)), ("da", da, (n, f))):
        check_cuda_tensor(name, t, x.dtype, shape, x.device)
    check_cuda_tensor("colsum", colsum, torch.float32,
                      (-(-n // ROW_TILE), f), x.device)
    for name, t in (("x", x), ("g", g), ("w1", w1), ("hid", hid),
                    ("da", da)):
        check_aligned(name, t, 32)
    dx = torch.empty_like(x)
    splits, rows = dw_split_plan(n)
    out = torch.empty(2 * h * f + f, dtype=torch.float32, device=x.device)
    ws = (torch.empty(splits * 2 * h * f, dtype=torch.float32,
                      device=x.device) if splits > 1 else None)
    FFN_BWD_PRODUCTS.launch(x.data_ptr(), g.data_ptr(), w1.data_ptr(),
                            hid.data_ptr(), da.data_ptr(), colsum.data_ptr(),
                            dx.data_ptr(), out.data_ptr(),
                            None if ws is None else ws.data_ptr(), n, h, f,
                            splits, rows, x.device.index)
    return (dx, out[:h * f].view(h, f), out[2 * h * f:],
            out[h * f:2 * h * f].view(f, h))


def _require_bf16(what, x):
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{what} takes bfloat16 CUDA tensors, got {x.dtype}")


def _bf16_bwd(x, g, w1, b1, w2, act, key=None, rate=0.0):
    """K8 in bfloat16 on the card: the recompute pass, then the products
    (dx, dw1, db1, dw2), all of them even where a caller keeps a part."""
    hid, da, colsum = ffn_bwd_recompute(x, g, w1, b1, w2, act, key, rate)
    return ffn_bwd_products(x, g, w1, hid, da, colsum)


def _f32_bwd(x, g, w1, b1, w2, act, key=None, rate=0.0):
    """K8 in float32 on the card: the f32 recompute pass (its dropout twin
    with the activation mask of (key, STREAM_ACT) at `rate` > 0), then the
    f32 products; returns (dx, dw1, db1, dw2).  The layouts the tf32
    products need are made here, per call: w1^T, and x^T and g^T with rows
    `ldt` (N rounded up to 8) apart; an H that is not a multiple of 4 is
    padded with zero columns (zero rows of w1), which change no sum."""
    n, h = x.shape
    f = w1.shape[1]
    hp = -(-h // 4) * 4
    if hp != h:
        pad = (0, hp - h)
        x, g = F.pad(x, pad), F.pad(g, pad)
        w1, w2 = F.pad(w1, (0, 0, 0, hp - h)), F.pad(w2, pad)
    ldt = -(-n // 8) * 8
    dev = x.device

    def transposed(t):
        out = torch.empty(t.shape[1], ldt, dtype=t.dtype, device=dev)
        out[:, :n] = t.t()
        return out
    w1t = w1.t().contiguous()
    da = torch.empty(n, f, dtype=x.dtype, device=dev)
    da_t = torch.empty(f, ldt, dtype=x.dtype, device=dev)
    hid_t = torch.empty_like(da_t)
    colsum = torch.empty(-(-n // ROW_TILE), f, dtype=torch.float32,
                         device=dev)
    ptrs = (x.data_ptr(), g.data_ptr(), w1t.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), da.data_ptr(), da_t.data_ptr(), hid_t.data_ptr(),
            colsum.data_ptr(), n, hp, f, ldt, ACT_CODES[act])
    if key is not None and rate > 0.0:
        FFN_DROPOUT_BWD_RECOMPUTE_F32.launch(*ptrs, *launch_args(key, rate),
                                             dev.index)
    else:
        FFN_BWD_RECOMPUTE_F32.launch(*ptrs, dev.index)
    del w1t
    xt, gt = transposed(x), transposed(g)
    dx = torch.empty(n, hp, dtype=x.dtype, device=dev)
    splits, rows = dw_split_plan(n, DW_ROWS_PER_SPLIT_F32)
    out = torch.empty(2 * hp * f + f, dtype=torch.float32, device=dev)
    ws = (torch.empty(splits * 2 * hp * f, dtype=torch.float32, device=dev)
          if splits > 1 else None)
    FFN_BWD_PRODUCTS_F32.launch(
        xt.data_ptr(), gt.data_ptr(), w1.data_ptr(), hid_t.data_ptr(),
        da.data_ptr(), da_t.data_ptr(), colsum.data_ptr(), dx.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(), n, hp, f, ldt,
        splits, rows, dev.index)
    dw1 = out[:hp * f].view(hp, f)
    dw2 = out[hp * f:2 * hp * f].view(f, hp)
    if hp != h:
        dx, dw1, dw2 = (dx[:, :h].contiguous(), dw1[:h].contiguous(),
                        dw2[:, :h].contiguous())
    return dx, dw1, out[2 * hp * f:], dw2


def _card_bwd(x, g, w1, b1, w2, act, key=None, rate=0.0):
    """K8 on the card in x's dtype: (dx, dw1, db1, dw2), all of them even
    where a caller keeps a part."""
    if x.dtype == torch.bfloat16:
        return _bf16_bwd(x, g, w1, b1, w2, act, key, rate)
    return _f32_bwd(x, g, w1, b1, w2, act, key, rate)


def ffn_bwd_dx(x, g, w1, b1, w2, act="gelu"):
    """K8's input gradient; see ffn_bwd_dx_plain.  CUDA tensors as for
    ffn_bwd."""
    if x.device.type == "cpu":
        return ffn_bwd_dx_plain(x, g, w1, b1, w2, act)
    _check_ffn_bwd("ffn_bwd_dx", x, g, w1, b1, w2, act)
    return _card_bwd(x, g, w1, b1, w2, act)[0]


def ffn_bwd_dw(x, g, w1, b1, w2, act="gelu"):
    """K8's weight gradients; see ffn_bwd_dw_plain.  CUDA tensors as for
    ffn_bwd.  The rows are summed over the fixed ranges of dw_split_plan,
    whose partial sums meet in a float32 workspace and are added in range
    order (no atomics)."""
    if x.device.type == "cpu":
        return ffn_bwd_dw_plain(x, g, w1, b1, w2, act)
    _check_ffn_bwd("ffn_bwd_dw", x, g, w1, b1, w2, act)
    return _card_bwd(x, g, w1, b1, w2, act)[1:]


def ffn_bwd(x, g, w1, b1, w2, act="gelu"):
    """K8; see ffn_bwd_plain.  CUDA tensors need x, g, w1, w2 in one dtype
    (float32 or bfloat16), b1 float32; float32 needs H <= 2048 and F a
    multiple of 16; bfloat16 needs H a multiple of FWD_WIDTH, F a multiple
    of 64 and x, g, w1, w2 32-byte aligned.  Both run the recompute pass and
    the products (two launches; float32 their f32 entries, with
    f32-accurate products on the tensor cores).  db2 = sum g is taken
    outside the kernels, as in the TPU package."""
    if x.device.type == "cpu":
        dx = ffn_bwd_dx_plain(x, g, w1, b1, w2, act)
        dw1, db1, dw2 = ffn_bwd_dw_plain(x, g, w1, b1, w2, act)
    else:
        _check_ffn_bwd("ffn_bwd", x, g, w1, b1, w2, act)
        dx, dw1, db1, dw2 = _card_bwd(x, g, w1, b1, w2, act)
    return dx, dw1, db1, dw2, g.float().sum(0)


def _mask_plain(key, stream, n, cols, rate, device):
    """The plain mask of (key, stream), or None for rate 0."""
    if rate <= 0.0:
        return None
    return dropout_mask_plain(key, stream, n, cols, rate, device)


def dense_dropout_res_ln(x, w, b, res, g, beta, key: DropoutKey, rate,
                         eps=1e-5):
    """K11: LayerNorm(res + drop(x @ w + b)) * g + beta, the output mask of
    (key, STREAM_OUT) at rate `rate`; see dense_dropout_res_ln_plain.  CUDA
    tensors as for dense_res_ln (float32: its f32 entry with the mask;
    bfloat16 without dense_fused(H): the down pass with the output mask,
    then the LayerNorm rows)."""
    n, din = x.shape
    h = w.shape[1]
    if x.device.type == "cpu":
        return dense_dropout_res_ln_plain(
            x, w, b, res, g, beta,
            _mask_plain(key, STREAM_OUT, n, h, rate, x.device), eps)
    _check_dense("dense_dropout_res_ln", x, w, b, res, g, beta)
    if x.dtype == torch.float32:
        return _f32_dense(x, w, b, res, g, beta, eps, key, rate)
    if not dense_fused(h):
        return res_ln_rows(ffn_down(x, w, b, res, key, rate), g, beta, eps)
    out = torch.empty_like(res)
    DENSE_DROPOUT_RES_LN.launch(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), res.data_ptr(), g.data_ptr(),
        beta.data_ptr(), out.data_ptr(), n, din, h, float(eps),
        *launch_args(key, rate), x.device.index)
    return out


def ffn_dropout_res_ln(x, w1, b1, w2, b2, res, g, beta, key: DropoutKey,
                       act_rate, out_rate, act="gelu", eps=1e-5):
    """K12: LayerNorm(res + drop_o(drop_a(act(x @ w1 + b1)) @ w2 + b2)) * g
    + beta, the activation mask of (key, STREAM_ACT) at act_rate and the
    output mask of (key, STREAM_OUT) at out_rate (either may be 0); see
    ffn_dropout_res_ln_plain.  CUDA tensors as for ffn_res_ln; it runs the
    up pass with the activation mask, the down pass with the output mask
    (each mask where its rate is above 0) and the LayerNorm rows, float32
    their f32 entries."""
    n, h = x.shape
    f = w1.shape[1]
    if x.device.type == "cpu":
        return ffn_dropout_res_ln_plain(
            x, w1, b1, w2, b2, res, g, beta,
            _mask_plain(key, STREAM_ACT, n, f, act_rate, x.device),
            _mask_plain(key, STREAM_OUT, n, h, out_rate, x.device), act, eps)
    n, h, _ = _check_ffn("ffn_dropout_res_ln", x, w1, b1, w2, act)
    check_cuda_tensor("res", res, x.dtype, (n, h), x.device)
    for name, t in (("b2", b2), ("g", g), ("beta", beta)):
        _check_vec(name, t, h, x.device)
    if x.dtype == torch.float32:
        return _f32_ffn(x, w1, b1, w2, b2, act, key, act_rate, res, g, beta,
                        out_rate, eps)
    z = ffn_down(ffn_up(x, w1, b1, act, key, act_rate), w2, b2, res, key,
                 out_rate)
    return res_ln_rows(z, g, beta, eps)


def ffn_dropout(x, w1, b1, w2, b2, key: DropoutKey, rate, act="gelu"):
    """K13: drop_a(act(x @ w1 + b1)) @ w2 + b2, the activation mask of
    (key, STREAM_ACT); see ffn_dropout_plain.  CUDA tensors as for
    ffn_fused; it runs the up pass with the mask (at `rate` above 0), then
    the down pass, float32 their f32 entries."""
    if x.device.type == "cpu":
        return ffn_dropout_plain(
            x, w1, b1, w2, b2, _mask_plain(key, STREAM_ACT, x.shape[0],
                                           w1.shape[1], rate, x.device), act)
    _, h, _ = _check_ffn("ffn_dropout", x, w1, b1, w2, act)
    _check_vec("b2", b2, h, x.device)
    if x.dtype == torch.float32:
        return _f32_ffn(x, w1, b1, w2, b2, act, key, rate)
    return ffn_down(ffn_up(x, w1, b1, act, key, rate), w2, b2)


def ffn_dropout_bwd_dx(x, g, w1, b1, w2, key: DropoutKey, rate, act="gelu"):
    """K8's input gradient with the activation mask of (key, STREAM_ACT)
    regenerated in the kernel."""
    if x.device.type == "cpu":
        return ffn_bwd_dx_plain(x, g, w1, b1, w2, act, _mask_plain(
            key, STREAM_ACT, x.shape[0], w1.shape[1], rate, x.device))
    _check_ffn_bwd("ffn_dropout_bwd_dx", x, g, w1, b1, w2, act)
    return _card_bwd(x, g, w1, b1, w2, act, key, rate)[0]


def ffn_dropout_bwd_dw(x, g, w1, b1, w2, key: DropoutKey, rate, act="gelu"):
    """K8's weight gradients with the activation mask of (key, STREAM_ACT)
    regenerated in the kernel."""
    if x.device.type == "cpu":
        return ffn_bwd_dw_plain(x, g, w1, b1, w2, act, _mask_plain(
            key, STREAM_ACT, x.shape[0], w1.shape[1], rate, x.device))
    _check_ffn_bwd("ffn_dropout_bwd_dw", x, g, w1, b1, w2, act)
    return _card_bwd(x, g, w1, b1, w2, act, key, rate)[1:]


def ffn_dropout_bwd(x, g, w1, b1, w2, key: DropoutKey, rate, act="gelu"):
    """K8 with the activation mask regenerated (the dropout recompute pass
    of x's dtype, then its products); returns (dx, dw1, db1, dw2, db2) as
    ffn_bwd does."""
    if x.device.type == "cpu":
        amask = _mask_plain(key, STREAM_ACT, x.shape[0], w1.shape[1], rate,
                            x.device)
        dx = ffn_bwd_dx_plain(x, g, w1, b1, w2, act, amask)
        dw1, db1, dw2 = ffn_bwd_dw_plain(x, g, w1, b1, w2, act, amask)
    else:
        _check_ffn_bwd("ffn_dropout_bwd", x, g, w1, b1, w2, act)
        dx, dw1, db1, dw2 = _card_bwd(x, g, w1, b1, w2, act, key, rate)
    return dx, dw1, db1, dw2, g.float().sum(0)


def _vec_or_zeros(b, size, device):
    if b is None:
        return torch.zeros(size, dtype=torch.float32, device=device)
    return b.float().contiguous()


def _dtypes(*params):
    return tuple(None if p is None else p.dtype for p in params)


def _like(grad, dtype):
    """A gradient in its parameter's dtype; None for an absent parameter."""
    return None if dtype is None else grad.to(dtype)


def _mm_f32(a, b):
    """a @ b as float32.  bfloat16 CUDA operands: their exact products summed
    in f32 (torch.mm(out_dtype=float32)), as the TPU package's dense
    backward takes them (preferred_element_type=f32); elsewhere the product
    of the upcast operands."""
    if a.device.type == "cuda" and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _FfnResLn(torch.autograd.Function):
    """K3 forward; backward: K9 recomputes the pre-LayerNorm sum, ln_bwd,
    then K8 on the sum's gradient.  Nothing of size (N, F) is kept."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, res, g, beta, act, eps):
        w1c, w2c = w1.to(x.dtype).contiguous(), w2.to(x.dtype).contiguous()
        b1c = _vec_or_zeros(b1, w1.shape[1], x.device)
        b2c = _vec_or_zeros(b2, w2.shape[1], x.device)
        ctx.act, ctx.eps = act, eps
        ctx.dtypes = _dtypes(w1, b1, w2, b2)
        ctx.save_for_backward(x, w1c, b1c, w2c, b2c, res, g, beta)
        return ffn_res_ln(x, w1c, b1c, w2c, b2c, res, g.float().contiguous(),
                          beta.float().contiguous(), act, eps)

    @staticmethod
    def backward(ctx, grad):
        x, w1c, b1c, w2c, b2c, res, g, beta = ctx.saved_tensors
        w1, b1, w2, b2 = ctx.dtypes
        y_pre = ffn_fused(x, w1c, b1c, w2c, b2c, ctx.act).float() + res.float()
        dy, dgamma, dbeta = ln_bwd(grad, y_pre, g, ctx.eps)
        dy = dy.to(x.dtype)
        dx, dw1, db1, dw2, db2 = ffn_bwd(x, dy.contiguous(), w1c, b1c, w2c,
                                         ctx.act)
        return (dx, _like(dw1, w1), _like(db1, b1), _like(dw2, w2),
                _like(db2, b2), dy.to(res.dtype), dgamma.to(g.dtype),
                dbeta.to(beta.dtype), None, None)


def ffn_res_ln_trainable(x, w1, b1, w2, b2, res, g, beta, act="gelu",
                         eps=1e-5):
    """Differentiable LayerNorm(res + act(x @ w1 + b1) @ w2 + b2) * g + beta.
    x, res: (N, H) in the compute dtype; w1, w2 as stored (cast inside);
    b1, b2: (F,), (H,) or None; g, beta: (H,)."""
    return _FfnResLn.apply(x, w1, b1, w2, b2, res, g, beta, act, eps)


class _DenseResLn(torch.autograd.Function):
    """K2 forward; backward by hand in plain matrix products, as the TPU
    package's _dense_bwd_hand: the pre-LayerNorm sum again (x @ w, f32
    result), ln_bwd, then dx, dw (f32 result) and db from its gradient
    rounded to x's dtype."""

    @staticmethod
    def forward(ctx, x, w, b, res, g, beta, eps):
        wc = w.to(x.dtype).contiguous()
        bc = _vec_or_zeros(b, w.shape[1], x.device)
        ctx.eps = eps
        ctx.dtypes = _dtypes(w, b)
        ctx.save_for_backward(x, wc, bc, res, g, beta)
        return dense_res_ln(x, wc, bc, res, g.float().contiguous(),
                            beta.float().contiguous(), eps)

    @staticmethod
    def backward(ctx, grad):
        x, wc, bc, res, g, beta = ctx.saved_tensors
        w, b = ctx.dtypes
        y_pre = _mm_f32(x, wc) + bc + res.float()
        dy, dgamma, dbeta = ln_bwd(grad, y_pre, g, ctx.eps)
        g16 = dy.to(x.dtype)
        dx = g16 @ wc.t()
        dw = _mm_f32(x.t(), g16)
        return (dx, _like(dw, w), _like(dy.sum(0), b), dy.to(res.dtype),
                dgamma.to(g.dtype), dbeta.to(beta.dtype), None)


def dense_res_ln_trainable(x, w, b, res, g, beta, eps=1e-5):
    """Differentiable LayerNorm(res + x @ w + b) * g + beta.  x: (N, Din),
    res: (N, H) in the compute dtype; w as stored (cast inside); b: (H,) or
    None."""
    return _DenseResLn.apply(x, w, b, res, g, beta, eps)


class _FfnFused(torch.autograd.Function):
    """K9 forward, K8 backward."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, act):
        w1c, w2c = w1.to(x.dtype).contiguous(), w2.to(x.dtype).contiguous()
        b1c = _vec_or_zeros(b1, w1.shape[1], x.device)
        b2c = _vec_or_zeros(b2, w2.shape[1], x.device)
        ctx.act = act
        ctx.dtypes = _dtypes(w1, b1, w2, b2)
        ctx.save_for_backward(x, w1c, b1c, w2c)
        return ffn_fused(x, w1c, b1c, w2c, b2c, act)

    @staticmethod
    def backward(ctx, grad):
        x, w1c, b1c, w2c = ctx.saved_tensors
        w1, b1, w2, b2 = ctx.dtypes
        dx, dw1, db1, dw2, db2 = ffn_bwd(
            x, grad.to(x.dtype).contiguous(), w1c, b1c, w2c, ctx.act)
        return (dx, _like(dw1, w1), _like(db1, b1), _like(dw2, w2),
                _like(db2, b2), None)


def ffn_fused_trainable(x, w1, b1, w2, b2, act="gelu"):
    """Differentiable act(x @ w1 + b1) @ w2 + b2.  x: (N, H) in the compute
    dtype; w1, w2 as stored (cast inside); b1, b2: (F,), (H,) or None."""
    return _FfnFused.apply(x, w1, b1, w2, b2, act)


class _FfnDropoutResLn(torch.autograd.Function):
    """K12 forward; backward: K13 (or K9 at act_rate 0) recomputes the FFN,
    K10 regenerates the output mask, ln_bwd, then K8 with the activation
    mask (without it at act_rate 0) on the masked gradient.  Nothing
    of size (N, F) or (N, H) is kept beyond the inputs."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, res, g, beta, key, act_rate,
                out_rate, act, eps):
        w1c, w2c = w1.to(x.dtype).contiguous(), w2.to(x.dtype).contiguous()
        b1c = _vec_or_zeros(b1, w1.shape[1], x.device)
        b2c = _vec_or_zeros(b2, w2.shape[1], x.device)
        ctx.act, ctx.eps, ctx.key = act, eps, key
        ctx.rates = (act_rate, out_rate)
        ctx.dtypes = _dtypes(w1, b1, w2, b2)
        ctx.save_for_backward(x, w1c, b1c, w2c, b2c, res, g, beta)
        return ffn_dropout_res_ln(x, w1c, b1c, w2c, b2c, res,
                                  g.float().contiguous(),
                                  beta.float().contiguous(), key, act_rate,
                                  out_rate, act, eps)

    @staticmethod
    def backward(ctx, grad):
        x, w1c, b1c, w2c, b2c, res, g, beta = ctx.saved_tensors
        w1, b1, w2, b2 = ctx.dtypes
        (act_rate, out_rate), key = ctx.rates, ctx.key
        n, h = x.shape
        if act_rate > 0.0:
            f = ffn_dropout(x, w1c, b1c, w2c, b2c, key, act_rate, ctx.act)
        else:
            f = ffn_fused(x, w1c, b1c, w2c, b2c, ctx.act)
        y = f.float()
        omask = None
        if out_rate > 0.0:
            omask = dropout_mask(key, STREAM_OUT, n, h, out_rate, x.device)
            y = y * omask
        dy, dgamma, dbeta = ln_bwd(grad, y + res.float(), g, ctx.eps)
        g_out = (dy if omask is None else dy * omask).to(x.dtype).contiguous()
        if act_rate > 0.0:
            dx, dw1, db1, dw2, db2 = ffn_dropout_bwd(
                x, g_out, w1c, b1c, w2c, key, act_rate, ctx.act)
        else:
            dx, dw1, db1, dw2, db2 = ffn_bwd(x, g_out, w1c, b1c, w2c, ctx.act)
        return (dx, _like(dw1, w1), _like(db1, b1), _like(dw2, w2),
                _like(db2, b2), dy.to(res.dtype), dgamma.to(g.dtype),
                dbeta.to(beta.dtype), None, None, None, None, None)


def ffn_dropout_res_ln_trainable(x, w1, b1, w2, b2, res, g, beta,
                                 key: DropoutKey, act_rate, out_rate,
                                 act="gelu", eps=1e-5):
    """Differentiable LayerNorm(res + drop_o(drop_a(act(x @ w1 + b1)) @ w2 +
    b2)) * g + beta, the counterpart of the TPU package's function of this
    name; operands as for ffn_res_ln_trainable; the masks are those of `key`
    (streams STREAM_ACT and STREAM_OUT), either rate may be 0."""
    return _FfnDropoutResLn.apply(x, w1, b1, w2, b2, res, g, beta, key,
                                  act_rate, out_rate, act, eps)


class _DenseDropoutResLn(torch.autograd.Function):
    """K11 forward; backward by hand in plain matrix products (_DenseResLn's),
    with the output mask regenerated by K10."""

    @staticmethod
    def forward(ctx, x, w, b, res, g, beta, key, rate, eps):
        wc = w.to(x.dtype).contiguous()
        bc = _vec_or_zeros(b, w.shape[1], x.device)
        ctx.eps, ctx.key, ctx.rate = eps, key, rate
        ctx.dtypes = _dtypes(w, b)
        ctx.save_for_backward(x, wc, bc, res, g, beta)
        return dense_dropout_res_ln(x, wc, bc, res, g.float().contiguous(),
                                    beta.float().contiguous(), key, rate, eps)

    @staticmethod
    def backward(ctx, grad):
        x, wc, bc, res, g, beta = ctx.saved_tensors
        w, b = ctx.dtypes
        omask = dropout_mask(ctx.key, STREAM_OUT, x.shape[0], wc.shape[1],
                             ctx.rate, x.device)
        y_pre = (_mm_f32(x, wc) + bc) * omask + res.float()
        dy, dgamma, dbeta = ln_bwd(grad, y_pre, g, ctx.eps)
        g_out = dy * omask
        g16 = g_out.to(x.dtype)
        dx = g16 @ wc.t()
        dw = _mm_f32(x.t(), g16)
        return (dx, _like(dw, w), _like(g_out.sum(0), b), dy.to(res.dtype),
                dgamma.to(g.dtype), dbeta.to(beta.dtype), None, None, None)


def dense_dropout_res_ln_trainable(x, w, b, res, g, beta, key: DropoutKey,
                                   rate, eps=1e-5):
    """Differentiable LayerNorm(res + drop(x @ w + b)) * g + beta, the
    counterpart of the TPU package's function of this name; operands as for
    dense_res_ln_trainable, the output mask of (key, STREAM_OUT)."""
    return _DenseDropoutResLn.apply(x, w, b, res, g, beta, key, rate, eps)


class _FfnDropout(torch.autograd.Function):
    """K13 forward, K8 with the activation mask backward."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, key, rate, act):
        w1c, w2c = w1.to(x.dtype).contiguous(), w2.to(x.dtype).contiguous()
        b1c = _vec_or_zeros(b1, w1.shape[1], x.device)
        b2c = _vec_or_zeros(b2, w2.shape[1], x.device)
        ctx.act, ctx.key, ctx.rate = act, key, rate
        ctx.dtypes = _dtypes(w1, b1, w2, b2)
        ctx.save_for_backward(x, w1c, b1c, w2c)
        return ffn_dropout(x, w1c, b1c, w2c, b2c, key, rate, act)

    @staticmethod
    def backward(ctx, grad):
        x, w1c, b1c, w2c = ctx.saved_tensors
        w1, b1, w2, b2 = ctx.dtypes
        dx, dw1, db1, dw2, db2 = ffn_dropout_bwd(
            x, grad.to(x.dtype).contiguous(), w1c, b1c, w2c, ctx.key,
            ctx.rate, ctx.act)
        return (dx, _like(dw1, w1), _like(db1, b1), _like(dw2, w2),
                _like(db2, b2), None, None, None)


def ffn_dropout_trainable(x, w1, b1, w2, b2, key: DropoutKey, rate,
                          act="gelu"):
    """Differentiable drop_a(act(x @ w1 + b1)) @ w2 + b2, the counterpart of
    the TPU package's function of this name; operands as for
    ffn_fused_trainable, the activation mask of (key, STREAM_ACT)."""
    return _FfnDropout.apply(x, w1, b1, w2, b2, key, rate, act)
