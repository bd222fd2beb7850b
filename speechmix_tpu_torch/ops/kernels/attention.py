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

``attention_dropout_fwd`` (K14, ``smx_attention_dropout_fwd`` of
``csrc/attention_fwd.cu``) and ``attention_dropout_bwd`` (K15,
``smx_attention_dropout_bwd`` of ``csrc/attention_bwd.cu``) are the same
with attention-probability dropout, the mask drawn in the kernel from the
port's generator (``dropout.py``: stream STREAM_ACT, row (b * H + h) * Tq +
q, column k) and regenerated by the backward.  They replace the TPU
package's ``_flash_dropout_fwd_tpu`` and ``_dropout_bwd``;
``attention_dropout_trainable`` is the counterpart of
``flash_attention_dropout``.  The plain versions take the mask explicitly
(``dmask``, (B, H, Tq, Tk) float32).
"""

from __future__ import annotations

import ctypes

import torch

from ._cuda import CudaKernel, check_aligned, check_cuda_tensor, dtype_code
from .dropout import DropoutKey, attention_mask_plain, launch_args

# the TPU kernel's excluded-logit value: finite, so a fully masked row
# averages its values instead of producing NaN
NEG_INF = -1e30
# the head widths the kernels take: multiples of 8 (16-byte rows of a head
# in bf16) from 8 to 128 (two 64-column boxes); 64 runs the body built for
# it, the others one padded to 64 or 128 columns
MIN_HEAD_DIM, MAX_HEAD_DIM, HEAD_DIM_STEP = 8, 128, 8


def check_head_dim(what, width, heads):
    """The head width of a (.., width) slab of `heads` heads, or
    ValueError if the kernels do not take it."""
    d = width // heads if heads and width % heads == 0 else None
    if d is None or d % HEAD_DIM_STEP or not (
            MIN_HEAD_DIM <= d <= MAX_HEAD_DIM):
        raise ValueError(
            f"{what} needs a head_dim that is a multiple of {HEAD_DIM_STEP} "
            f"in [{MIN_HEAD_DIM}, {MAX_HEAD_DIM}], got {width} / {heads} "
            f"heads")
    return d

KERNEL = CudaKernel(
    "attention_fwd.cu", "smx_attention_fwd",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 +
    [ctypes.c_float] + [ctypes.c_int] * 3)
BWD_KERNEL = CudaKernel(
    "attention_bwd.cu", "smx_attention_bwd",
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 +
    [ctypes.c_float] + [ctypes.c_int] * 3)
# the dropout twins: the key's two words and the mask's (threshold, scale)
# after `causal`
_DROP_ARGS = [ctypes.c_uint32] * 3 + [ctypes.c_float]
DROPOUT_KERNEL = CudaKernel(
    "attention_fwd.cu", "smx_attention_dropout_fwd",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float] +
    [ctypes.c_int] + _DROP_ARGS + [ctypes.c_int] * 2)
# K15 also takes a workspace for the mask's keep bits, after `delta`
DROPOUT_BWD_KERNEL = CudaKernel(
    "attention_bwd.cu", "smx_attention_dropout_bwd",
    [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_float] +
    [ctypes.c_int] + _DROP_ARGS + [ctypes.c_int] * 2)


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
                        return_lse=False, dmask=None):
    """softmax(q k^T * scale + mask) v per (batch, head), f32 scores,
    softmax and products, output in q's dtype.  q: (B, Tq, H*D); k, v:
    (B, Tk, H*D); kv_mask: (B, Tk) bool or None.  With return_lse also the
    float32 row log-sum-exp of the masked logits, (B, H, Tq).  dmask:
    (B, H, Tq, Tk) float32 dropout mask multiplying the probabilities (the
    log-sum-exp stays undropped), or None."""
    b, tq, hd = q.shape
    tk = k.shape[1]
    s = _masked_scores(q, k, kv_mask, heads, scale, causal)
    p = torch.softmax(s, dim=-1)
    if dmask is not None:
        p = p * dmask
    vf = v.float().reshape(b, tk, heads, hd // heads)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    out = out.reshape(b, tq, hd).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


# the bf16 forward kernel's tiles: a block holds 64 queries and walks 64-key
# tiles
FWD_QUERY_BLOCK = 64
FWD_KEY_TILE = 64
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453


def attention_fwd_tiled_plain(q, k, v, kv_mask, heads, scale, causal=False,
                              return_lse=False, dmask=None):
    """K1 / K14's bf16 forward in plain PyTorch, tile for tile: per block of
    FWD_QUERY_BLOCK queries, an online softmax over FWD_KEY_TILE-key tiles
    in order, in log2 units (logits times scale * log2(e); an excluded logit
    is -1e30 * log2(e), a key past Tk is not there: the kernel's -inf gives
    it no weight); the running max m, the rescale 2^(m_old - m_new) of the
    output and of the f32 denominator, which sums the unrounded
    probabilities; P times the dropout mask (dmask, (B, H, Tq, Tk) float32,
    or None), rounded to q's dtype before P . v; out = o / l and lse = m ln 2
    + log l.  Under `causal` a block stops at the key tile of its last
    query, unless a row of the block has no valid key at or before its
    query (then it averages all Tk keys, and the block visits every tile).
    Nothing on the card's path calls it: it pins the kernel's structure in
    the tests and in chip_smoke.py."""
    b, tq, hd = q.shape
    tk = k.shape[1]
    d = hd // heads
    split = lambda x, t: x.float().reshape(b, t, heads, d).transpose(1, 2)
    qf, kf, vf = split(q, tq), split(k, tk), split(v, tk)
    if kv_mask is None:
        kv_mask = torch.ones((b, tk), dtype=torch.bool, device=q.device)
    valid = kv_mask.bool()
    neg2 = torch.tensor(NEG_INF, dtype=torch.float32) * _LOG2E
    sl2 = torch.tensor(scale, dtype=torch.float32) * _LOG2E
    out = torch.empty_like(qf)
    lse = torch.empty(b, heads, tq, dtype=torch.float32, device=q.device)
    tiles = -(-tk // FWD_KEY_TILE)
    for q0 in range(0, tq, FWD_QUERY_BLOCK):
        qs = slice(q0, min(q0 + FWD_QUERY_BLOCK, tq))
        qi = torch.arange(qs.start, qs.stop, device=q.device)[:, None]
        # per batch row: the key tiles this block visits
        visit = torch.full((b,), tiles, device=q.device)
        if causal:
            has_key = valid[:, :min(q0, tk - 1) + 1].any(1)
            visit = torch.where(has_key, min(tiles, (qs.stop - 1)
                                             // FWD_KEY_TILE + 1), visit)
        rows = qs.stop - qs.start
        m = torch.full((b, heads, rows, 1), -torch.inf, device=q.device)
        l = torch.zeros(b, heads, rows, 1, device=q.device)
        o = torch.zeros(b, heads, rows, d, device=q.device)
        for t in range(tiles):
            ks = slice(t * FWD_KEY_TILE, min((t + 1) * FWD_KEY_TILE, tk))
            kj = torch.arange(ks.start, ks.stop, device=q.device)[None, :]
            allowed = valid[:, None, None, ks]
            if causal:
                allowed = allowed & (kj <= qi)
            x = torch.where(allowed, (qf[:, :, qs] @ kf[:, :, ks]
                                      .transpose(-1, -2)) * sl2, neg2)
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new)
            step = (t < visit)[:, None, None, None]
            l = torch.where(step, l * alpha + p.sum(-1, keepdim=True), l)
            if dmask is not None:
                p = p * dmask[:, :, qs, ks]
            pv = p.to(q.dtype).float() @ vf[:, :, ks]
            o = torch.where(step, o * alpha + pv, o)
            m = torch.where(step, m_new, m)
        out[:, :, qs] = o / l.clamp_min(1e-30)
        lse[:, :, qs] = (m * _LN2 + torch.log(l))[..., 0]
    out = out.transpose(1, 2).reshape(b, tq, hd).to(q.dtype)
    return (out, lse) if return_lse else out


def _check_slabs(what, q, k, v, kv_mask, heads):
    """Shared checks of the K1 / K7 wrappers; returns (mask, dtype code)."""
    b, tq, hd = q.shape
    tk = k.shape[1]
    check_head_dim(what, hd, heads)
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
    requires a head_dim that is a multiple of 8 in [8, 128] (check_head_dim),
    float32 or bfloat16, contiguous inputs, and q, k, v 16-byte aligned (the
    TMA reads them, in either dtype); anything else raises."""
    if q.device.type == "cpu":
        return attention_fwd_plain(q, k, v, kv_mask, heads, scale, causal,
                                   return_lse)
    return _fwd_launch(KERNEL, "attention_fwd", q, k, v, kv_mask, heads,
                       scale, causal, return_lse, ())


def attention_dropout_fwd(q, k, v, kv_mask, heads, scale, causal,
                          key: DropoutKey, rate, return_lse=False):
    """K14: attention_fwd with probability dropout at `rate`, the mask of
    `key` (see attention_fwd_plain's dmask).  CUDA tensors as for
    attention_fwd."""
    if q.device.type == "cpu":
        b, tq, _ = q.shape
        dmask = attention_mask_plain(key, b, heads, tq, k.shape[1], rate,
                                     q.device)
        return attention_fwd_plain(q, k, v, kv_mask, heads, scale, causal,
                                   return_lse, dmask)
    return _fwd_launch(DROPOUT_KERNEL, "attention_dropout_fwd", q, k, v,
                       kv_mask, heads, scale, causal, return_lse,
                       launch_args(key, rate))


def _fwd_launch(kernel, what, q, k, v, kv_mask, heads, scale, causal,
                return_lse, drop_args):
    b, tq, hd = q.shape
    tk = k.shape[1]
    kv_mask, code = _check_slabs(what, q, k, v, kv_mask, heads)
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_aligned(name, t, 16)
    out = torch.empty_like(q)
    lse = (torch.empty((b, heads, tq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    kernel.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  kv_mask.data_ptr(), out.data_ptr(),
                  None if lse is None else lse.data_ptr(), b, tq, tk, heads,
                  hd // heads, float(scale), int(bool(causal)), *drop_args,
                  code, q.device.index)
    return (out, lse) if return_lse else out


def attention_bwd_plain(q, k, v, kv_mask, g, heads, scale, causal=False,
                        dmask=None):
    """(dq, dk, dv) of attention_fwd_plain for d(out) = g, by recomputing the
    probabilities: p = softmax(s) in f32, dv = round(p)^T g,
    ds = round(p * (g v^T - rowsum(g v^T * p))), dq = ds k * scale,
    dk = ds^T q * scale, round() to g's dtype, sums in f32 (the formulas and
    roundings of the TPU package's backward).  With a dropout mask dmask:
    dv = round(p * dmask)^T g and dp = (g v^T) * dmask, as the TPU package's
    _dropout_ref_bwd."""
    b, tq, hd = q.shape
    tk = k.shape[1]
    d = hd // heads
    p = torch.softmax(_masked_scores(q, k, kv_mask, heads, scale, causal),
                      dim=-1)
    qf = q.float().reshape(b, tq, heads, d)
    kf = k.float().reshape(b, tk, heads, d)
    vf = v.float().reshape(b, tk, heads, d)
    gf = g.float().reshape(b, tq, heads, d)
    pd = p if dmask is None else p * dmask
    dv = torch.einsum("bhqk,bqhd->bkhd", pd.to(g.dtype).float(), gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    if dmask is not None:
        dp = dp * dmask
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds = ds.to(g.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return (dq.reshape(b, tq, hd).to(q.dtype),
            dk.reshape(b, tk, hd).to(k.dtype),
            dv.reshape(b, tk, hd).to(v.dtype))


# the bf16 kernels' tile: 64 queries or keys per product (a block holds
# two, one per consumer warpgroup, each summing its own)
BWD_TILE = 64


def attention_bwd_tiled_plain(q, k, v, kv_mask, out, lse, g, heads, scale,
                              causal=False, dmask=None):
    """K7 / K15's decomposition in plain PyTorch, tile for tile: delta =
    rowsum(g * out) from the (rounded) forward output; p = exp(s * scale -
    lse) from the forward's log-sum-exp, 0 where a logit is excluded and 1 /
    Tk on every key of a row whose lse <= -1e29 (all excluded); then the dk /
    dv pass (each 64-key tile sums round(p m)^T g and round(p (dp m -
    delta))^T q over the 64-query tiles in order) and the dq pass (each
    64-query tile sums round(ds) k over the 64-key tiles in order), f32
    sums, round() to g's dtype.  The last tile of each axis is cut at T,
    where the kernel's is padded with zero rows whose p is 0.  dmask:
    (B, H, Tq, Tk) float32 dropout mask (K15), or None.  Nothing on the
    card's path calls it: it pins the kernels' structure in the tests and
    in chip_smoke.py."""
    b, tq, hd = q.shape
    tk = k.shape[1]
    d = hd // heads
    split = lambda x, t: x.float().reshape(b, t, heads, d).transpose(1, 2)
    qf, kf, vf, gf = split(q, tq), split(k, tk), split(v, tk), split(g, tq)
    delta = (gf * split(out, tq)).sum(-1)
    lse = lse.float()
    if kv_mask is None:
        kv_mask = torch.ones((b, tk), dtype=torch.bool, device=q.device)
    rnd = lambda x: x.to(g.dtype).float()

    def tile(q0, k0):
        """round(p m) and round(ds) of the (q0, k0) tile, (B, H, 64, 64)."""
        qs = slice(q0, min(q0 + BWD_TILE, tq))
        ks = slice(k0, min(k0 + BWD_TILE, tk))
        qi = torch.arange(qs.start, qs.stop, device=q.device)[:, None]
        kj = torch.arange(ks.start, ks.stop, device=q.device)[None, :]
        allowed = kv_mask.bool()[:, None, None, ks]
        if causal:
            allowed = allowed & (kj <= qi)
        lt = lse[:, :, qs, None]
        s = qf[:, :, qs] @ kf[:, :, ks].transpose(-1, -2)
        p = torch.where(allowed, torch.exp(s * scale - lt), 0.0)
        p = torch.where(lt <= -1e29, 1.0 / tk, p)
        dp = gf[:, :, qs] @ vf[:, :, ks].transpose(-1, -2)
        m = 1.0 if dmask is None else dmask[:, :, qs, ks].float()
        return rnd(p * m), rnd(p * (dp * m - delta[:, :, qs, None]))

    dq, dk, dv = (torch.zeros_like(x) for x in (qf, kf, vf))
    # dk / dv pass
    for k0 in range(0, tk, BWD_TILE):
        ks = slice(k0, min(k0 + BWD_TILE, tk))
        for q0 in range(0, tq, BWD_TILE):
            qs = slice(q0, min(q0 + BWD_TILE, tq))
            pm, ds = tile(q0, k0)
            dv[:, :, ks] += pm.transpose(-1, -2) @ gf[:, :, qs]
            dk[:, :, ks] += ds.transpose(-1, -2) @ qf[:, :, qs]
    # dq pass
    for q0 in range(0, tq, BWD_TILE):
        qs = slice(q0, min(q0 + BWD_TILE, tq))
        for k0 in range(0, tk, BWD_TILE):
            ks = slice(k0, min(k0 + BWD_TILE, tk))
            dq[:, :, qs] += tile(q0, k0)[1] @ kf[:, :, ks]
    join = lambda x, t, dtype: x.transpose(1, 2).reshape(b, t, hd).to(dtype)
    return (join(dq * scale, tq, q.dtype), join(dk * scale, tk, k.dtype),
            join(dv, tk, v.dtype))


def attention_bwd(q, k, v, kv_mask, out, lse, g, heads, scale, causal=False):
    """K7: (dq, dk, dv) for d(out) = g; see attention_bwd_plain.  `out` and
    `lse` are what attention_fwd(..., return_lse=True) returned for the same
    inputs.  CPU tensors take the plain version (which needs neither); CUDA
    tensors launch the kernel, which requires attention_fwd's head widths,
    one dtype (float32 or bfloat16), contiguous 16-byte-aligned slabs and a float32
    lse of shape (B, H, Tq)."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, kv_mask, g, heads, scale, causal)
    return _bwd_launch(BWD_KERNEL, "attention_bwd", q, k, v, kv_mask, out,
                       lse, g, heads, scale, causal, (), ())


def attention_dropout_bwd(q, k, v, kv_mask, out, lse, g, heads, scale,
                          causal, key: DropoutKey, rate):
    """K15: (dq, dk, dv) of attention_dropout_fwd for d(out) = g, the mask
    of `key` regenerated in the kernel; `out` and `lse` are what
    attention_dropout_fwd(..., return_lse=True) returned.  CUDA tensors as
    for attention_bwd."""
    if q.device.type == "cpu":
        b, tq, _ = q.shape
        dmask = attention_mask_plain(key, b, heads, tq, k.shape[1], rate,
                                     q.device)
        return attention_bwd_plain(q, k, v, kv_mask, g, heads, scale, causal,
                                   dmask)
    # bf16: the dk/dv pass hands the mask's keep bits to the dq pass, 16
    # keys to a 16-bit word, (B*H, ceil(Tk / 64), Tq, 4) words
    b, tq, _ = q.shape
    keep = (torch.empty((b * heads, -(-k.shape[1] // BWD_TILE), tq, 4),
                        dtype=torch.int16, device=q.device)
            if q.dtype == torch.bfloat16 else None)
    return _bwd_launch(DROPOUT_BWD_KERNEL, "attention_dropout_bwd", q, k, v,
                       kv_mask, out, lse, g, heads, scale, causal,
                       launch_args(key, rate),
                       (None if keep is None else keep.data_ptr(),))


def _bwd_launch(kernel, what, q, k, v, kv_mask, out, lse, g, heads, scale,
                causal, drop_args, workspace):
    b, tq, hd = q.shape
    tk = k.shape[1]
    kv_mask, code = _check_slabs(what, q, k, v, kv_mask, heads)
    check_cuda_tensor("out", out, q.dtype, (b, tq, hd), q.device)
    check_cuda_tensor("g", g, q.dtype, (b, tq, hd), q.device)
    check_cuda_tensor("lse", lse, torch.float32, (b, heads, tq), q.device)
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out), ("g", g)):
        check_aligned(name, t, 16)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    kernel.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  g.data_ptr(), kv_mask.data_ptr(), lse.data_ptr(),
                  delta.data_ptr(), *workspace, dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), b, tq, tk, heads, hd // heads, float(scale),
                  int(bool(causal)), *drop_args, code, q.device.index)
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


class _AttentionDropout(torch.autograd.Function):
    """attention_dropout_fwd (K14) with attention_dropout_bwd (K15) as its
    backward; the key, not the mask, is kept."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, heads, scale, causal, key, rate):
        ctx.heads, ctx.scale, ctx.causal = heads, scale, causal
        ctx.key, ctx.rate = key, rate
        if not any(ctx.needs_input_grad[:3]):
            return attention_dropout_fwd(q, k, v, kv_mask, heads, scale,
                                         causal, key, rate)
        out, lse = attention_dropout_fwd(q, k, v, kv_mask, heads, scale,
                                         causal, key, rate, return_lse=True)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_dropout_bwd(
            q, k, v, kv_mask, out, lse, g.to(q.dtype).contiguous(), ctx.heads,
            ctx.scale, ctx.causal, ctx.key, ctx.rate)
        return dq, dk, dv, None, None, None, None, None, None


def attention_dropout_trainable(q, k, v, kv_mask, heads, scale, causal,
                                key: DropoutKey, rate):
    """Differentiable masked MHA with probability dropout on (B, T, H*D)
    slabs: K14 forward, K15 backward; nothing of size (Tq, Tk) is kept."""
    return _AttentionDropout.apply(q, k, v, kv_mask, heads, scale, causal,
                                   key, rate)
