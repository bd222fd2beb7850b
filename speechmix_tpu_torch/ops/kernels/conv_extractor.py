"""K6: one stride-2 feature-extractor layer, conv + bias (+ LayerNorm) + GELU
in one pass.

``fused_conv_layer`` launches ``csrc/conv_ln_gelu.cu`` for CUDA tensors and
runs ``fused_conv_layer_plain`` for CPU tensors.  It replaces the TPU kernel
``speechmix_tpu/ops/pallas/conv_extractor.py: fused_conv_layer``;
``fused_conv_stack`` chains it over layers 1.. of the extractor as the TPU
package's ``fused_conv_stack`` does, with no padded physical shapes: each
layer writes exactly its ``(T_in - k) // 2 + 1`` frames.  When a gradient is
wanted the chain runs as one ``torch.autograd.Function`` whose backward
recomputes it through library convolutions, as the TPU package's
``fused_conv_stack_trainable`` recomputes through XLA: there is no backward
kernel on either side.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._cuda import CudaKernel, check_aligned, check_cuda_tensor, dtype_code

STRIDE = 2
KERNEL_SIZES = (2, 3)
MAX_CHANNELS = 1024  # the float32 kernel holds all columns of a row tile
# width the bfloat16 tensor-core kernel is built for; other bfloat16 widths
# run the float32 kernel's body with bf16 loads and stores
BF16_CHANNELS = 512

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


# the bf16 kernel's tiles: 128 output rows of one batch row, 64-channel
# steps of each tap, LayerNorm sums over 128-column slices
ROW_TILE = 128
K_STEP = 64
LN_SLICE = 128


def fused_conv_layer_tiled_plain(x, kernel, bias=None, ln_params=None,
                                 ln_eps=1e-5):
    """fused_conv_layer_plain as the bfloat16 kernel computes it: per batch
    row, tiles of ROW_TILE output rows cut at T_out; each tile the f32 sum
    over taps j, then K_STEP-channel steps, of x[2 t + j, step] @
    w_j[step] (w_j = kernel[:, :, j]^T); plus bias; with LayerNorm the
    mean from the LN_SLICE-column slices' row sums added in slice order,
    then the variance from those of the squared centred values; exact-erf
    GELU, rounded once to x's dtype.  Nothing on the card's path calls it:
    it pins the kernel's structure in the tests and in chip_smoke.py."""
    _check_geometry(x, kernel)
    c, _, k = kernel.shape
    b, t_in, _ = x.shape
    t_out = (t_in - k) // STRIDE + 1
    w = kernel.float().permute(2, 1, 0)  # (k, C_in, C_out)
    out = torch.empty((b, t_out, c), dtype=x.dtype, device=x.device)

    def row_sum(t):
        total = torch.zeros(t.shape[:-1], dtype=torch.float32,
                            device=t.device)
        for part in t.split(LN_SLICE, dim=-1):
            total = total + part.sum(-1)
        return total[..., None]

    for t0 in range(0, t_out, ROW_TILE):
        t1 = min(t0 + ROW_TILE, t_out)
        acc = torch.zeros((b, t1 - t0, c), dtype=torch.float32,
                          device=x.device)
        for j in range(k):
            rows = x[:, STRIDE * t0 + j:STRIDE * (t1 - 1) + j + 1:STRIDE]
            for c0 in range(0, c, K_STEP):
                acc = acc + (rows[..., c0:c0 + K_STEP].float()
                             @ w[j, c0:c0 + K_STEP])
        if bias is not None:
            acc = acc + bias.float()
        if ln_params is not None:
            dev = acc - row_sum(acc) / c
            acc = (dev * torch.rsqrt(row_sum(dev * dev) / c + ln_eps)
                   * ln_params["scale"].float() + ln_params["bias"].float())
        out[:, t0:t1] = F.gelu(acc).to(x.dtype)
    return out


def fused_conv_layer(x, kernel, bias=None, ln_params=None, ln_eps=1e-5):
    """K6; see fused_conv_layer_plain.  CUDA tensors need x and kernel in one
    dtype (float32 or bfloat16), x contiguous, C <= 1024; bfloat16 at
    C == 512 (the tensor-core kernel) x 16-byte aligned."""
    if x.device.type == "cpu":
        return fused_conv_layer_plain(x, kernel, bias, ln_params, ln_eps)
    _check_geometry(x, kernel)
    c, _, k = kernel.shape
    b, t_in, _ = x.shape
    if c > MAX_CHANNELS:
        raise ValueError(f"fused_conv_layer supports C <= {MAX_CHANNELS}, "
                         f"got {c}")
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
    if x.dtype == torch.bfloat16 and c == BF16_CHANNELS:
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


def _run_stack(x, layer_params, ln_layers, ln_eps):
    for kernel, bias, scale, beta in layer_params:
        ln = {"scale": scale, "bias": beta} if ln_layers else None
        x = fused_conv_layer(x, kernel.to(x.dtype), bias, ln, ln_eps)
    return x


def conv_stack_recompute(x, layer_params, ln_layers, ln_eps):
    """The chain of fused_conv_stack out of differentiable library calls:
    per layer a stride-2 convolution in x's dtype, then bias, optional
    LayerNorm and exact-erf GELU in float32, rounded once to x's dtype."""
    for kernel, bias, scale, beta in layer_params:
        y = F.conv1d(x.transpose(1, 2), kernel.to(x.dtype), None,
                     stride=STRIDE).transpose(1, 2).float()
        if bias is not None:
            y = y + bias.float()
        if ln_layers:
            y = F.layer_norm(y, (y.shape[-1],), scale.float(), beta.float(),
                             ln_eps)
        x = F.gelu(y).to(x.dtype)
    return x


class _ConvStack(torch.autograd.Function):
    """K6 layer by layer forward; backward: autograd through
    conv_stack_recompute from the saved input.  Only the stack's input is
    kept between the two."""

    @staticmethod
    def forward(ctx, x, ln_layers, ln_eps, *flat):
        ctx.ln_layers, ctx.ln_eps = ln_layers, ln_eps
        ctx.present = [t is not None for t in flat]
        ctx.save_for_backward(x, *[t for t in flat if t is not None])
        return _run_stack(x, list(zip(*[iter(flat)] * 4)), ln_layers, ln_eps)

    @staticmethod
    def backward(ctx, grad):
        x, *saved = ctx.saved_tensors
        saved = iter(saved)
        flat = [next(saved) if here else None for here in ctx.present]
        needs = ctx.needs_input_grad
        with torch.enable_grad():
            x_in = x.detach().requires_grad_(needs[0])
            leaves = [None if t is None
                      else t.detach().requires_grad_(needs[3 + i])
                      for i, t in enumerate(flat)]
            out = conv_stack_recompute(x_in, list(zip(*[iter(leaves)] * 4)),
                                       ctx.ln_layers, ctx.ln_eps)
            wanted = [t for t in [x_in] + leaves
                      if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted,
                                             grad.to(out.dtype)))
        pick = lambda t: (next(grads) if t is not None and t.requires_grad
                          else None)
        dx = pick(x_in)
        return (dx, None, None, *[pick(t) for t in leaves])


def fused_conv_stack(x, layers, ln_layers=False, ln_eps=1e-5):
    """Chain fused_conv_layer over `layers` (dicts with "conv" {kernel, bias}
    and, when ln_layers, "norm" {scale, bias}).  x: (B, T_in, C) in the
    compute dtype.  Returns (B, T_out, C).  Differentiable in x and in every
    parameter, which may be stored in another dtype than x's."""
    flat = []
    for layer in layers:
        conv, norm = layer["conv"], layer.get("norm") if ln_layers else None
        flat += [conv["kernel"], conv.get("bias"),
                 None if norm is None else norm["scale"],
                 None if norm is None else norm["bias"]]
    if not torch.is_grad_enabled() or not any(
            t is not None and t.requires_grad for t in [x] + flat):
        return _run_stack(x, list(zip(*[iter(flat)] * 4)), ln_layers, ln_eps)
    return _ConvStack.apply(x, ln_layers, ln_eps, *flat)
