"""K6: one stride-2 feature-extractor layer, conv + bias (+ LayerNorm) + GELU
in one pass.

``fused_conv_layer`` launches ``csrc/conv_ln_gelu.cu`` for CUDA tensors and
runs ``fused_conv_layer_plain`` for CPU tensors.  It replaces the TPU kernel
``speechmix_tpu/ops/pallas/conv_extractor.py: fused_conv_layer``;
``fused_conv_stack`` chains it over layers 1.. of the extractor as the TPU
package's ``fused_conv_stack`` does, with no padded physical shapes: each
layer writes exactly its ``(T_in - k) // 2 + 1`` frames.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._cuda import CudaKernel, check_aligned, check_cuda_tensor, dtype_code

STRIDE = 2
KERNEL_SIZES = (2, 3)
MAX_CHANNELS = 1024  # the float32 kernel holds all columns of a row tile
BF16_CHANNELS = 512  # width the bfloat16 tensor-core kernel is built for

KERNEL = CudaKernel(
    "conv_ln_gelu.cu", "smx_conv_ln_gelu",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float] +
    [ctypes.c_int] * 2)


def _check_geometry(x, kernel):
    c_out, c_in, k = kernel.shape
    if k not in KERNEL_SIZES or c_in != c_out or x.shape[-1] != c_in:
        raise ValueError(f"fused_conv_layer takes k in {KERNEL_SIZES} and "
                         f"C_in == C_out == x's width, got kernel "
                         f"{tuple(kernel.shape)} for x {tuple(x.shape)}")
    if x.ndim != 3 or x.shape[1] < k:
        raise ValueError(f"fused_conv_layer needs x (B, T >= {k}, C), got "
                         f"{tuple(x.shape)}")


def fused_conv_layer_plain(x, kernel, bias=None, ln_params=None, ln_eps=1e-5):
    """GELU([LayerNorm](conv1d(x, stride 2, VALID) + bias)) with f32 products
    and statistics, exact-erf GELU, one rounding to x's dtype.  x:
    (B, T_in, C); kernel: (C, C, k), k in {2, 3}; bias: (C,) or None;
    ln_params: {"scale", "bias"} or None.  Returns (B, (T_in - k) // 2 + 1,
    C)."""
    _check_geometry(x, kernel)
    y = F.conv1d(x.float().transpose(1, 2), kernel.float(),
                 None if bias is None else bias.float(), stride=STRIDE)
    y = y.transpose(1, 2)
    if ln_params is not None:
        y = F.layer_norm(y, (y.shape[-1],), ln_params["scale"].float(),
                         ln_params["bias"].float(), ln_eps)
    return F.gelu(y).to(x.dtype)


def fused_conv_layer(x, kernel, bias=None, ln_params=None, ln_eps=1e-5):
    """K6; see fused_conv_layer_plain.  CUDA tensors need x and kernel in one
    dtype (float32 or bfloat16), x contiguous, C <= 1024; bfloat16 needs
    C == 512 and x 16-byte aligned."""
    if x.device.type == "cpu":
        return fused_conv_layer_plain(x, kernel, bias, ln_params, ln_eps)
    _check_geometry(x, kernel)
    c, _, k = kernel.shape
    b, t_in, _ = x.shape
    if c > MAX_CHANNELS:
        raise ValueError(f"fused_conv_layer supports C <= {MAX_CHANNELS}, "
                         f"got {c}")
    if x.dtype == torch.bfloat16 and c != BF16_CHANNELS:
        raise ValueError(f"fused_conv_layer in bfloat16 supports C == "
                         f"{BF16_CHANNELS}, got {c}")
    check_cuda_tensor("x", x)
    code = dtype_code(x.dtype)
    check_cuda_tensor("kernel", kernel, x.dtype, device=x.device)
    # (k * C_in, C_out): row j * C + ci is tap j of input channel ci
    w = kernel.permute(2, 1, 0).reshape(k * c, c).contiguous()
    vec = lambda t: t.float().contiguous()
    bias = (torch.zeros(c, dtype=torch.float32, device=x.device)
            if bias is None else vec(bias))
    check_cuda_tensor("bias", bias, torch.float32, (c,), x.device)
    g = beta = None
    if ln_params is not None:
        g, beta = vec(ln_params["scale"]), vec(ln_params["bias"])
        check_cuda_tensor("ln scale", g, torch.float32, (c,), x.device)
        check_cuda_tensor("ln bias", beta, torch.float32, (c,), x.device)
    if x.dtype == torch.bfloat16:
        check_aligned("x", x, 16)
        check_aligned("kernel", w, 32)
    out = torch.empty((b, (t_in - k) // STRIDE + 1, c), dtype=x.dtype,
                      device=x.device)
    KERNEL.launch(x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                  None if g is None else g.data_ptr(),
                  None if beta is None else beta.data_ptr(), out.data_ptr(),
                  b, t_in, c, k, int(ln_params is not None), float(ln_eps),
                  code, x.device.index)
    return out


def fused_conv_stack(x, layers, ln_layers=False, ln_eps=1e-5):
    """Chain fused_conv_layer over `layers` (dicts with "conv" {kernel, bias}
    and, when ln_layers, "norm" {scale, bias}).  x: (B, T_in, C) in the
    compute dtype.  Returns (B, T_out, C)."""
    for layer in layers:
        conv = layer["conv"]
        x = fused_conv_layer(x, conv["kernel"].to(x.dtype), conv.get("bias"),
                             layer.get("norm") if ln_layers else None, ln_eps)
    return x
