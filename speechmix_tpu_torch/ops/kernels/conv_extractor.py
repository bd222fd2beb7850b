"""K6: one stride-2 feature-extractor layer, conv + bias (+ LayerNorm) + GELU
in one pass, and its backward in three.

``fused_conv_layer`` launches ``csrc/conv_ln_gelu.cu`` for CUDA tensors and
runs ``fused_conv_layer_plain`` for CPU tensors.  It replaces the TPU kernel
``speechmix_tpu/ops/pallas/conv_extractor.py: fused_conv_layer``;
``fused_conv_stack`` chains it over layers 1.. of the extractor as the TPU
package's ``fused_conv_stack`` does, with no padded physical shapes: each
layer writes exactly its ``(T_in - k) // 2 + 1`` frames.  When a gradient is
wanted the chain runs as one ``torch.autograd.Function``, whose forward
keeps every layer's input and whose backward walks the layers from the
last to the first.  On CUDA tensors each layer's backward is the three
launchers of ``csrc/conv_bwd.cu``: the activation pass (``conv_bwd_act``:
K6's products again, then GELU's and LayerNorm's backward, dL/dz and the
column sums of the bias and LayerNorm gradients), the data gradient
(``conv_bwd_data``, split by the parity of the input row) and the weight
gradient (``conv_bwd_weight``, over fixed row ranges added in order); a C
that is not a multiple of 8 is padded with zero channels, as the forward
pads it.
CPU tensors take the same walk through the plain version of each layer's
backward.  The TPU package has no backward kernel: its
``fused_conv_stack_trainable`` recomputes through XLA, as
``conv_stack_recompute`` does through library convolutions for the tests.
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
ACT_KERNEL = CudaKernel(
    "conv_bwd.cu", "smx_conv_bwd_act",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_float] +
    [ctypes.c_int] * 4)
DATA_KERNEL = CudaKernel("conv_bwd.cu", "smx_conv_bwd_data",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8)
WEIGHT_KERNEL = CudaKernel("conv_bwd.cu", "smx_conv_bwd_weight",
                           [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9)


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


def _weights(kernel, cpo, kp, order):
    """kernel (C, C, k) as a kernel's K-major B (k, cpo, kp), zero past C:
    `order` (2, 0, 1) gives K6's wt[j, o, i] = kernel[o, i, j], (2, 1, 0)
    the data gradient's wd[j, i, o].  Where nothing is padded (C = 512:
    every wav2vec2 extractor) one copy lays it out."""
    c = kernel.shape[0]
    w = kernel.permute(*order)
    return (w.contiguous() if (cpo, kp) == (c, c)
            else F.pad(w, (0, kp - c, 0, cpo - c)))


def _vector(t, c, cpo, device):
    """A bias or LayerNorm vector as the kernels read it: (cpo,) float32,
    zero past C (all zero for None)."""
    if t is None:
        return torch.zeros(cpo, dtype=torch.float32, device=device)
    t = t.float().contiguous()
    check_cuda_tensor("bias or LayerNorm vector", t, shape=(c,),
                      device=device)
    return t if cpo == c else F.pad(t, (0, cpo - c))


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
    wt = _weights(kernel, cpo, kp, (2, 0, 1))
    g = beta = None
    if ln_params is not None:
        g = _vector(ln_params["scale"], c, cpo, x.device)
        beta = _vector(ln_params["bias"], c, cpo, x.device)
    bias = _vector(bias, c, cpo, x.device)
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
    LayerNorm and exact-erf GELU in float32, rounded once to x's dtype.
    The tests take its autograd gradient as the reference of the
    backward's."""
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


# ---------------------------------------------------------------- backward
# One layer's backward takes dout, the gradient of its output (x's dtype),
# and `needs`, five flags: the gradients of x, kernel, bias, LayerNorm scale
# and LayerNorm bias that are wanted (None: every one the layer has).  It
# returns those five, None where not wanted: dx in x's dtype, the others
# float32.  With z = conv(x) + bias, y =
# LayerNorm(z) (or z) and out = GELU(y), its passes are the activation pass
# (gz = dL/dz from dout, and the column sums that are the vectors'
# gradients), the data pass (dx from gz) and the weight pass (dkernel from x
# and gz).

# the weight pass cuts its rows into fixed ranges, about WEIGHT_WAVES blocks
# on each of an H100's SM_COUNT SMs, a plan that the shape alone decides
SM_COUNT = 132
WEIGHT_WAVES = 4


def weight_split_plan(b, t_out, c, k, dtype):
    """(splits, per_split): the weight pass's row ranges.  A step is one
    chunk of `depth` rows of one batch row (64 bf16, 32 f32), b ceil(t_out
    / depth) steps in batch-row order; range s holds steps [s per_split,
    (s + 1) per_split), none empty."""
    depth = 64 if dtype == torch.bfloat16 else 32
    steps = b * -(-t_out // depth)
    tiles = k * (-(-c // ROW_TILE)) ** 2
    splits = max(1, min(steps, SM_COUNT * WEIGHT_WAVES // tiles))
    per = -(-steps // splits)
    return -(-steps // per), per


def _gelu_grad(y):
    """d GELU(y) / dy, exact erf (common.cuh: dactivate)."""
    return (0.5 * (1.0 + torch.erf(y * 0.7071067811865476))
            + y * torch.exp(-0.5 * y * y) * 0.3989422804014327)


def _epilogue_backward(z, d, ln_params, ln_eps, row_sum):
    """(gz, sums): dL/dz from z (f32, bias added) and d = dL/d out (f32), and
    the column sums over z's rows of gz and, with LayerNorm, of dL/dy x^ and
    dL/dy, stacked (1 or 3, C).  row_sum(t) sums each row (keeping the
    dimension)."""
    c = z.shape[-1]
    if ln_params is None:
        g = d * _gelu_grad(z)
        return g, g.sum(-2)[None]
    dev = z - row_sum(z) / c
    rstd = torch.rsqrt(row_sum(dev * dev) / c + ln_eps)
    xh = dev * rstd
    scale = ln_params["scale"].float()
    dy = d * _gelu_grad(xh * scale + ln_params["bias"].float())
    dxh = dy * scale
    g = rstd * (dxh - row_sum(dxh) / c - xh * (row_sum(dxh * xh) / c))
    return g, torch.stack([g.sum(-2), (dy * xh).sum(-2), dy.sum(-2)])


def _needs(needs, bias, ln_params):
    """`needs`, or for None every gradient the layer has."""
    if needs is not None:
        return needs
    return (True, True, bias is not None) + (ln_params is not None,) * 2


def _vector_grads(vectors, needs):
    """(dbias, dscale, dbeta) from the column sums, None where not wanted."""
    out = [None] * 3
    for i in range(3):
        if needs[2 + i]:
            out[i] = vectors[i]
    return out


def conv_bwd_act_plain(x, kernel, bias, ln_params, ln_eps, dout):
    """The activation pass from library calls in float32: z by conv1d, the
    epilogue's backward by its formulas.  Returns (gz in x's dtype, the
    column sums (1 or 3, C))."""
    z = F.conv1d(x.float().transpose(1, 2), kernel.float(),
                 None if bias is None else bias.float(),
                 stride=STRIDE).transpose(1, 2)
    g, sums = _epilogue_backward(
        z, dout.float(), ln_params, ln_eps,
        lambda t: t.sum(-1, keepdim=True))
    return g.to(x.dtype), sums.sum(1)


def conv_bwd_data_plain(gz, kernel, t_in):
    """The data pass: dx (B, t_in, C) by conv_transpose1d in float32,
    rounded to gz's dtype."""
    extra = t_in - ((gz.shape[1] - 1) * STRIDE + kernel.shape[2])
    dx = F.conv_transpose1d(gz.float().transpose(1, 2), kernel.float(),
                            stride=STRIDE, output_padding=extra)
    return dx.transpose(1, 2).to(gz.dtype)


def conv_bwd_weight_plain(x, kernel, gz):
    """The weight pass: dkernel (C, C, k) float32 by conv1d_weight."""
    return torch.nn.grad.conv1d_weight(
        x.float().transpose(1, 2), kernel.shape,
        gz.float().transpose(1, 2), stride=STRIDE)


def conv_layer_backward_plain(x, kernel, bias, ln_params, ln_eps, dout,
                              needs=None):
    """One layer's backward in float32 from library calls, pass by pass:
    conv_bwd_act_plain, conv_bwd_data_plain, conv_bwd_weight_plain."""
    _check_geometry(x, kernel)
    needs = _needs(needs, bias, ln_params)
    gz, vectors = conv_bwd_act_plain(x, kernel, bias, ln_params, ln_eps, dout)
    dx = conv_bwd_data_plain(gz, kernel, x.shape[1]) if needs[0] else None
    dkernel = conv_bwd_weight_plain(x, kernel, gz) if needs[1] else None
    return (dx, dkernel, *_vector_grads(vectors, needs))


def _ordered_sum(parts):
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def conv_layer_backward_tiled_plain(x, kernel, bias, ln_params, ln_eps,
                                    dout, needs=None, product=None):
    """conv_layer_backward_plain as the three kernels compute it.
    product(a, b) is one stage's f32 product a @ b (default: a plain one; the
    tests pass the tensor cores' split products).

    The activation pass: per batch row, tiles of ROW_TILE output rows; per
    tile z is the sum over taps, then stages of `depth` channels (64 bf16,
    32 f32), plus the bias; with LayerNorm the statistics and the row sums of
    its backward from LN_SLICE-column slices added in slice order; gz in x's
    dtype, and the tile's column sums, added over the tiles in order.  The
    data pass, by the parity of the input row: dx[2 t] = gz[t] w_0^T +
    gz[t - 1] w_2^T and dx[2 t + 1] = gz[t] w_1^T (k = 3), dx[2 t + j] =
    gz[t] w_j^T (k = 2), rows of gz outside [0, T_out) zero, in ROW_TILE-row
    tiles, stages of `depth` over gz's columns.  The weight pass:
    dkernel[o, i, j] = sum over rows of gz[t, o] x[2 t + j, i], per range of
    weight_split_plan a sum over its steps (chunks of 64 bf16 or 32 f32 rows
    of one batch row), the ranges added in order.  Nothing on the card's
    path calls it: it pins the kernels' structure in the tests and in
    chip_smoke.py."""
    _check_geometry(x, kernel)
    needs = _needs(needs, bias, ln_params)
    product = product or (lambda a, b: a @ b)
    c, _, k = kernel.shape
    b, t_in, _ = x.shape
    t_out = (t_in - k) // STRIDE + 1
    w = kernel.float().permute(2, 1, 0)  # (k, C_in, C_out)
    depth = kernel_layout(c, x.dtype)[3]

    def stages(pairs):
        acc = 0.0
        for rows, wj in pairs:
            for c0 in range(0, rows.shape[-1], depth):
                acc = acc + product(rows[:, c0:c0 + depth],
                                    wj[c0:c0 + depth])
        return acc

    def row_sum(t):
        total = torch.zeros(t.shape[:-1], dtype=torch.float32,
                            device=t.device)
        for part in t.split(LN_SLICE, dim=-1):
            total = total + part.sum(-1)
        return total[..., None]

    def taps(bi, t0, t1):  # tap j's rows 2 t + j, t in [t0, t1)
        return [x[bi, STRIDE * t0 + j:STRIDE * (t1 - 1) + j + 1:STRIDE]
                .float() for j in range(k)]

    gz = torch.empty((b, t_out, c), dtype=x.dtype, device=x.device)
    sums = []
    for bi in range(b):
        for t0 in range(0, t_out, ROW_TILE):
            t1 = min(t0 + ROW_TILE, t_out)
            z = stages(zip(taps(bi, t0, t1), w))
            if bias is not None:
                z = z + bias.float()
            g, tile_sums = _epilogue_backward(
                z, dout[bi, t0:t1].float(), ln_params, ln_eps, row_sum)
            gz[bi, t0:t1] = g.to(x.dtype)
            sums.append(tile_sums)
    vectors = _ordered_sum(sums)

    dx = dkernel = None
    if needs[0]:
        wd = w.transpose(1, 2)  # (k, C_out, C_in)
        # a zero row before and after each batch row: the shifted tap at
        # t = 0 and the rows that no output reads
        gp = F.pad(gz.float(), (0, 0, 1, 1))
        dx = torch.empty((b, t_in, c), dtype=x.dtype, device=x.device)
        for par in (0, 1):
            rows = (t_in - par + 1) // 2
            shifts = ([(0, 0), (2, -1)] if par == 0 and k == 3
                      else [(par, 0)])
            for bi in range(b):
                for t0 in range(0, rows, ROW_TILE):
                    t1 = min(t0 + ROW_TILE, rows)
                    acc = stages([(gp[bi, 1 + t0 + s:1 + t1 + s], wd[j])
                                  for j, s in shifts])
                    dx[bi, 2 * t0 + par:2 * (t1 - 1) + par + 1:2] = \
                        acc.to(x.dtype)
    if needs[1]:
        splits, per = weight_split_plan(b, t_out, c, k, x.dtype)
        chunk = 64 if x.dtype == torch.bfloat16 else 32
        steps = [(bi, t0) for bi in range(b) for t0 in range(0, t_out, chunk)]
        parts = []
        for s in range(splits):
            part = torch.zeros((k, c, c), device=x.device)
            for bi, t0 in steps[s * per:(s + 1) * per]:
                t1 = min(t0 + chunk, t_out)
                gt = gz[bi, t0:t1].float().t()
                for j, rows in enumerate(taps(bi, t0, t1)):
                    part[j] = part[j] + product(gt, rows)
            parts.append(part)
        dkernel = _ordered_sum(parts).permute(1, 2, 0)
    return (dx, dkernel, *_vector_grads(vectors, needs))


def _check_backward(x, kernel, dout):
    _check_geometry(x, kernel)
    check_cuda_tensor("x", x)
    check_cuda_tensor("kernel", kernel, x.dtype, device=x.device)
    t_out = (x.shape[1] - kernel.shape[2]) // STRIDE + 1
    check_cuda_tensor("dout", dout, x.dtype, (x.shape[0], t_out, x.shape[2]),
                      device=x.device)
    c = kernel.shape[0]
    if c % 8 or c > MAX_CHANNELS:
        raise ValueError(f"the extractor's backward kernels take C a "
                         f"multiple of 8 up to {MAX_CHANNELS}, got {c} "
                         f"(conv_layer_backward pads it)")
    return dtype_code(x.dtype)


def conv_bwd_act(x, kernel, bias, ln_params, ln_eps, dout, transposed=False,
                 vectors=False, width=None):
    """The activation pass (smx_conv_bwd_act) on CUDA tensors: (gz, gzt,
    sums).  x (B, T_in, C), dout (B, T_out, C) and kernel (C, C, k)
    contiguous in one dtype, C a multiple of 8.  `width` (default C) is the
    layer's own width, over which LayerNorm normalises, where the caller
    padded the channels up to C with zeros; bias and LayerNorm vectors are
    (width,).  gz = dL/dz, (B, T_out, C) in x's dtype; gzt, with
    `transposed` (float32 only: the weight pass's K-major operand), gz^T per
    batch row (B, C, ldt) float32, ldt = T_out rounded up to 4; sums, with
    `vectors`, the column sums (1 or 3, C) float32 of _epilogue_backward;
    each zero past `width`."""
    code = _check_backward(x, kernel, dout)
    c, _, k = kernel.shape
    width = c if width is None else width
    b, t_in, _ = x.shape
    t_out = dout.shape[1]
    _, cpo, kp, _ = kernel_layout(c, x.dtype)
    dev = x.device
    ln = ln_params is not None
    wt = _weights(kernel, cpo, kp, (2, 0, 1))
    scale = beta = None
    if ln:
        scale = _vector(ln_params["scale"], width, cpo, dev)
        beta = _vector(ln_params["bias"], width, cpo, dev)
    bias = _vector(bias, width, cpo, dev)
    gz = torch.empty((b, t_out, c), dtype=x.dtype, device=dev)
    ldt = -(-t_out // 4) * 4
    gzt = (torch.empty((b, c, ldt), dtype=torch.float32, device=dev)
           if transposed else None)
    nq = (3 if ln else 1) if vectors else 0
    tiles = b * -(-t_out // ROW_TILE)
    part = (torch.empty((nq, tiles, c), dtype=torch.float32, device=dev)
            if nq else None)
    sums = (torch.empty((nq, c), dtype=torch.float32, device=dev)
            if nq else None)
    ptr = lambda t: None if t is None else t.data_ptr()
    ACT_KERNEL.launch(x.data_ptr(), wt.data_ptr(), bias.data_ptr(),
                      ptr(scale), ptr(beta), dout.data_ptr(), gz.data_ptr(),
                      ptr(gzt), ptr(part), ptr(sums), b, t_in, c, width, cpo,
                      kp, k, int(ln), float(ln_eps), nq, ldt, code,
                      dev.index)
    return gz, gzt, sums


def conv_bwd_data(gz, kernel, t_in):
    """The data pass (smx_conv_bwd_data): dx (B, T_in, C) in gz's dtype from
    gz (B, T_out, C) and kernel (C, C, k) in gz's dtype."""
    c, _, k = kernel.shape
    b = gz.shape[0]
    dx = gz.new_empty((b, t_in, c))
    code = _check_backward(dx, kernel, gz)
    _, cpo, kp, _ = kernel_layout(c, gz.dtype)
    wd = _weights(kernel, cpo, kp, (2, 1, 0))
    DATA_KERNEL.launch(gz.data_ptr(), wd.data_ptr(), dx.data_ptr(), b, t_in,
                       c, cpo, kp, k, code, gz.device.index)
    return dx


def conv_bwd_weight(x, kernel, gz, gzt=None):
    """The weight pass (smx_conv_bwd_weight): dkernel (C, C, k) float32 from
    x (B, T_in, C) and gz (B, T_out, C); float32 reads gzt (conv_bwd_act's
    `transposed`) instead of gz and lays out x^T in a workspace."""
    code = _check_backward(x, kernel, gz)
    c, _, k = kernel.shape
    b, t_in, _ = x.shape
    t_out = gz.shape[1]
    dev = x.device
    f32 = x.dtype == torch.float32
    splits, per = weight_split_plan(b, t_out, c, k, x.dtype)
    xt = ldt = None
    if f32:
        if gzt is None:
            raise ValueError("the float32 weight pass reads gz^T")
        ldt = gzt.shape[2]
        check_cuda_tensor("gzt", gzt, torch.float32, (b, c, ldt), device=dev)
        # each tap's rows of x transposed: tap 2 cannot read tap 0's one
        # column on (a TMA box starts on a 16-byte boundary)
        xt = torch.empty((k, b, c, ldt), dtype=torch.float32, device=dev)
    out = torch.empty((k, c, c), dtype=torch.float32, device=dev)
    ws = (torch.empty((splits, k, c, c), dtype=torch.float32, device=dev)
          if splits > 1 else None)
    WEIGHT_KERNEL.launch(x.data_ptr(), (gzt if f32 else gz).data_ptr(),
                         None if xt is None else xt.data_ptr(),
                         None if ws is None else ws.data_ptr(),
                         out.data_ptr(), b, t_in, c, k, ldt or 0, splits, per,
                         code, dev.index)
    return out.permute(1, 2, 0).contiguous()


def conv_layer_backward(x, kernel, bias, ln_params, ln_eps, dout,
                        needs=None):
    """One layer's backward (see above) with the kernel rounded to x's dtype
    as the forward takes it (kernel, bias and LayerNorm vectors in any float
    dtype): through conv_bwd.cu's three passes for CUDA tensors, a C that
    is not a multiple of 8 padded with zero channels (in x, dout and the
    kernel; the LayerNorm still over C); conv_layer_backward_plain for CPU
    tensors."""
    needs = _needs(needs, bias, ln_params)
    kernel = kernel.to(x.dtype)
    if x.device.type == "cpu":
        return conv_layer_backward_plain(x, kernel, bias, ln_params, ln_eps,
                                         dout, needs)
    c = kernel.shape[0]
    c_in = kernel_layout(c, x.dtype)[0]
    if c_in != c:
        x, dout = (F.pad(t, (0, c_in - c)) for t in (x, dout))
        kernel = F.pad(kernel, (0, 0, 0, c_in - c, 0, c_in - c))
    want_w = needs[1]
    f32 = x.dtype == torch.float32
    gz, gzt, sums = conv_bwd_act(x, kernel, bias, ln_params, ln_eps, dout,
                                 transposed=f32 and want_w,
                                 vectors=any(needs[2:]), width=c)
    dkernel = conv_bwd_weight(x, kernel, gz, gzt) if want_w else None
    del gzt
    dx = conv_bwd_data(gz, kernel, x.shape[1]) if needs[0] else None
    if c_in != c:
        dx = None if dx is None else dx[..., :c].contiguous()
        dkernel = None if dkernel is None else dkernel[:c, :c].contiguous()
        sums = None if sums is None else sums[:, :c]
    vectors = [None] * 3 if sums is None else sums
    return (dx, dkernel, *_vector_grads(vectors, needs))


def conv_stack_backward(inputs, layer_params, ln_layers, ln_eps, grad, needs,
                        layer_backward=None):
    """The gradients of fused_conv_stack from each layer's input (inputs[l]
    the input of layer l): (dx, grads), grads flat as the layers' (kernel,
    bias, LayerNorm scale, LayerNorm bias), None where not wanted, each in
    its parameter's dtype.  needs: x's flag, then four a layer.  The layers
    are walked from the last, down to the lowest that x or a parameter
    needs; a layer's dx is computed only where x or a lower layer's
    parameter wants a gradient.  layer_backward defaults to
    conv_layer_backward, looked up at the call."""
    layer_backward = layer_backward or conv_layer_backward
    grads = [None] * (4 * len(layer_params))
    dout = grad.to(inputs[0].dtype).contiguous()
    for l in reversed(range(len(layer_params))):
        params = layer_params[l]
        want = [needs[0] or any(needs[1:1 + 4 * l])]
        want += [needs[1 + 4 * l + i] and t is not None
                 for i, t in enumerate(params)]
        if not any(want):   # nothing here or below trains
            break
        ln = ({"scale": params[2], "bias": params[3]} if ln_layers
              else None)
        dx, *layer_grads = layer_backward(inputs[l], params[0], params[1],
                                          ln, ln_eps, dout, want)
        for i, (t, g) in enumerate(zip(params, layer_grads)):
            if want[1 + i]:
                grads[4 * l + i] = g.to(t.dtype)
        if dx is None:
            break
        dout = dx
    return (dout if needs[0] else None), grads


def conv_stack_backward_tiled_plain(x, layer_params, ln_layers, ln_eps, grad,
                                    needs, product=None):
    """conv_stack_backward with conv_layer_backward_tiled_plain from the
    stack's input x: the inputs of the later layers come from
    fused_conv_layer_tiled_plain, as the card's from K6."""
    inputs = [x]
    for kernel, bias, scale, beta in layer_params[:-1]:
        ln = {"scale": scale, "bias": beta} if ln_layers else None
        inputs.append(fused_conv_layer_tiled_plain(
            inputs[-1], kernel.to(x.dtype), bias, ln, ln_eps))

    def layer(*args):
        return conv_layer_backward_tiled_plain(*args, product=product)
    return conv_stack_backward(inputs, layer_params, ln_layers, ln_eps, grad,
                               needs, layer)


class _ConvStack(torch.autograd.Function):
    """K6 layer by layer forward, keeping every layer's input; the backward
    is conv_stack_backward (conv_bwd.cu for CUDA tensors, the plain version
    for CPU tensors)."""

    @staticmethod
    def forward(ctx, x, ln_layers, ln_eps, *flat):
        ctx.ln_layers, ctx.ln_eps = ln_layers, ln_eps
        ctx.present = [t is not None for t in flat]
        inputs = [x]
        for layer in zip(*[iter(flat)] * 4):
            inputs.append(_run_stack(inputs[-1], [layer], ln_layers, ln_eps))
        out = inputs.pop()
        ctx.inputs = len(inputs)
        ctx.save_for_backward(*inputs, *[t for t in flat if t is not None])
        return out

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        inputs, params = saved[:ctx.inputs], iter(saved[ctx.inputs:])
        flat = [next(params) if here else None for here in ctx.present]
        needs = ctx.needs_input_grad
        dx, grads = conv_stack_backward(
            list(inputs), list(zip(*[iter(flat)] * 4)), ctx.ln_layers,
            ctx.ln_eps, grad, (needs[0],) + tuple(needs[3:]))
        return (dx, None, None, *grads)


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
