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
MAX_CHANNELS = 1024  # a row's columns over at most 8 blocks of 128

KERNEL = CudaKernel(
    "conv_ln_gelu.cu", "smx_conv_ln_gelu",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_float] +
    [ctypes.c_int] * 2)


def kernel_layout(c, dtype):
    """(c_in, cpo, kp, depth) of the kernel at C = c in `dtype`: x's row
    length (c rounded up to 8, the wrapper's padding of x), the output
    columns the blocks cover (64 for c <= 64, one block holding the row;
    else c rounded up to 128, a cluster of blocks of 128), the per-tap depth
    of wt (c_in rounded up to a stage) and the stage depth (64 bf16 or 32
    f32 elements: one 128-byte row)."""
    depth = 64 if dtype == torch.bfloat16 else 32
    c_in = -(-c // 8) * 8
    cpo = 64 if c <= 64 else -(-c // 128) * 128
    return c_in, cpo, -(-c_in // depth) * depth, depth


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


# the kernel's tiles: 128 output rows of one batch row, stages of one
# 128-byte row of channels of each tap (64 bf16, 32 f32), LayerNorm sums
# over column slices of 128 (one slice below 128 columns)
ROW_TILE = 128
LN_SLICE = 128


def fused_conv_layer_tiled_plain(x, kernel, bias=None, ln_params=None,
                                 ln_eps=1e-5):
    """fused_conv_layer_plain as the kernel computes it: per batch row,
    tiles of ROW_TILE output rows cut at T_out; each tile the f32 sum over
    taps j, then stages of 64 (bf16) or 32 (f32) channels, of x[2 t + j,
    step] @ w_j[step] (w_j = kernel[:, :, j]^T); plus bias; with LayerNorm
    the mean from the LN_SLICE-column slices' row sums added in slice
    order, then the variance from those of the squared centred values;
    exact-erf GELU, rounded once to x's dtype.  Nothing on the card's path
    calls it: it pins the kernel's structure in the tests and in
    chip_smoke.py."""
    _check_geometry(x, kernel)
    c, _, k = kernel.shape
    b, t_in, _ = x.shape
    t_out = (t_in - k) // STRIDE + 1
    w = kernel.float().permute(2, 1, 0)  # (k, C_in, C_out)
    step = kernel_layout(c, x.dtype)[3]
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
            for c0 in range(0, c, step):
                acc = acc + (rows[..., c0:c0 + step].float()
                             @ w[j, c0:c0 + step])
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
    dtype (float32: f32-accurate products on the tensor cores; bfloat16:
    bf16 products), x contiguous, C <= 1024.  The weights are laid out per
    call as the kernel's K-major B, wt (k, cpo, kp), zero past C (see
    kernel_layout); a C that is not a multiple of 8 also pads x's channels
    with zeros and drops the output's extra columns."""
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
    c_in, cpo, kp, _ = kernel_layout(c, x.dtype)
    if c_in != c:
        x = F.pad(x, (0, c_in - c))
    check_aligned("x", x, 16)
    # where nothing is padded (C = 512: every wav2vec2 extractor) one copy
    # lays out the weights, and f32 vectors are used as they are
    wt = kernel.permute(2, 0, 1)
    wt = (wt.contiguous() if (cpo, kp) == (c, c)
          else F.pad(wt, (0, kp - c, 0, cpo - c)))

    def vec(t):
        if t is None:
            return torch.zeros(cpo, dtype=torch.float32, device=x.device)
        t = t.float().contiguous()
        check_cuda_tensor("bias or LayerNorm vector", t, shape=(c,),
                          device=x.device)
        return t if cpo == c else F.pad(t, (0, cpo - c))
    g = beta = None
    if ln_params is not None:
        g, beta = vec(ln_params["scale"]), vec(ln_params["bias"])
    bias = vec(bias)
    out = torch.empty((b, (t_in - k) // STRIDE + 1, c_in), dtype=x.dtype,
                      device=x.device)
    KERNEL.launch(x.data_ptr(), wt.data_ptr(), bias.data_ptr(),
                  None if g is None else g.data_ptr(),
                  None if beta is None else beta.data_ptr(), out.data_ptr(),
                  b, t_in, c, c_in, cpo, kp, k, int(ln_params is not None),
                  float(ln_eps), code, x.device.index)
    return out if c_in == c else out[..., :c].contiguous()


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
