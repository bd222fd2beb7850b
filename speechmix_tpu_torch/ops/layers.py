"""Core neural-net ops of the port (counterpart of ``speechmix_tpu.ops.layers``).

Plain functions over parameter dicts of tensors.  Dense kernels keep the JAX
layout ``(in, out)``; conv kernels are stored in PyTorch's ``(out, in, k)``
layout (``convert.params_from_jax`` maps them).  The compute dtype is the
caller's; normalisation statistics are f32.

``ffn_residual_ln_apply``, ``dense_residual_ln_apply`` and ``ffn_apply`` send
the blocks the JAX package's gate admits to the fused kernels K3, K2 and K9
(``ops.kernels.ffn``) through their differentiable forms, whose backward runs
K9 and K8, as the JAX package sends them to its TPU kernels: at least
``FUSED_MIN_ROWS`` rows, both widths multiples of ``FUSED_WIDTH``,
unquantized weights (a ``kernel`` entry) and, for the FFN, one of the
kernels' activations.  Every other block (the cached decode steps, rows ==
B; other widths) takes the plain chain, as the JAX package runs its XLA
chain there.

Dropout: each site takes one ``DropoutKey`` (None: no dropout).  With a key
and a rate above 0 the fused blocks run the dropout kernels K12, K11 and K13;
the plain chain draws the same masks (``dropout``: K10 on the card, the plain
generator on the CPU), keyed on the same rows and streams, so a site's masks
do not depend on the row gate.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..parallel import collectives
from ..parallel import mesh as mesh_lib
from .kernels import ffn as ffn_kernels
from .kernels import dropout as drop
from .kernels.dropout import STREAM_ACT, STREAM_OUT

FUSED_MIN_ROWS = 1024  # the JAX row gate: cached decode steps stay plain
FUSED_WIDTH = 128      # the JAX width gate: both widths of a fused block

# With int8 weights present, also quantize the activations per token and
# take the product int8 x int8 -> int32 (``set_int8_dense_compute``);
# off: dequantize the weights and take the product in the compute dtype.
INT8_DENSE_COMPUTE = False
# torch._int_mm's conditions on the card: more than 16 rows, inner and
# output widths multiples of 8; smaller operands are zero-padded up to them
_INT_MM_MIN_ROWS, _INT_MM_MULTIPLE = 17, 8


def set_int8_dense_compute(enabled: bool):
    """Switch the int8 x int8 -> int32 product of int8 dense weights on or
    off (the JAX package's trace-time switch; here it acts on the next
    call).  Serving only: it adds the activations' rounding error."""
    global INT8_DENSE_COMPUTE
    INT8_DENSE_COMPUTE = bool(enabled)


def _pad_to(n, multiple):
    return -n % multiple


def int8_matmul(a, b):
    """Exact (M, K) int8 x (K, N) int8 -> (M, N) int32 product.  On the card
    torch._int_mm (cuBLAS), with the operands zero-padded to its shape
    conditions; on the CPU an int32 matmul.  Both sum exact integers, so
    their results are equal bit for bit."""
    if a.device.type != "cuda":
        return a.to(torch.int32) @ b.to(torch.int32)
    m, k = a.shape
    n = b.shape[1]
    pm = max(_INT_MM_MIN_ROWS - m, 0)
    pk, pn = _pad_to(k, _INT_MM_MULTIPLE), _pad_to(n, _INT_MM_MULTIPLE)
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b, (0, pn, 0, pk))
    y = torch._int_mm(a.contiguous(), b.contiguous())
    return y[:m, :n] if pm or pn else y


def dense(params, x, dtype=None, row_parallel=False):
    """x @ W + b in `dtype`.  An int8 kernel (``kernel_q`` with per-output-
    channel ``kernel_scale``, utils/quantize.py) is dequantized as the JAX
    package rounds it, ``q.to(dtype) * scale.to(dtype)``, at every call;
    with set_int8_dense_compute(True) the activations are quantized per
    token instead and the product is exact in int32, rescaled in float32.

    Under tensor parallelism a column-parallel kernel holds this rank's
    output columns and its replicated bias / scales are sliced to them;
    row_parallel=True (the kernel holds this rank's input rows, x its
    share) sums the partial products over the model group before the bias
    is added."""
    dtype = dtype or x.dtype
    if "kernel_q" in params:
        wq = params["kernel_q"]
        sw = mesh_lib.local_slice(params["kernel_scale"], wq.shape[1])
        if INT8_DENSE_COMPUTE:
            xf = x.float()
            sx = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
            xq = torch.round(xf / sx).clamp(-127, 127).to(torch.int8)
            acc = int8_matmul(xq.reshape(-1, xq.shape[-1]), wq)
            acc = acc.reshape(*x.shape[:-1], wq.shape[1])
            y = (acc.float() * sx * sw.float()).to(dtype)
        else:
            y = x.to(dtype) @ (wq.to(dtype) * sw.to(dtype))
    else:
        y = x.to(dtype) @ params["kernel"].to(dtype)
    if row_parallel:
        y = collectives.reduce_from_model(y, mesh_lib.active_tp_mesh())
    if "bias" in params:
        y = y + mesh_lib.local_slice(params["bias"], y.shape[-1]).to(dtype)
    return y


def embed(params, ids, dtype=torch.float32):
    """Rows `ids` of the table in `dtype`; an int8 table (``embedding_q``
    with per-row ``embedding_scale``) is gathered, then dequantized row by
    row in `dtype`."""
    if "embedding_q" in params:
        rows = params["embedding_q"][ids].to(dtype)
        return rows * params["embedding_scale"][ids].to(dtype)[..., None]
    return params["embedding"][ids].to(dtype)


def layer_norm(params, x, eps=1e-5):
    y = F.layer_norm(x.float(), (x.shape[-1],), params["scale"].float(),
                     params["bias"].float(), eps)
    return y.to(x.dtype)


def rms_norm(params, x, eps=1e-6):
    """T5's RMS norm: x * rsqrt(mean(x^2) + eps) * scale, the statistics in
    float32, the result in x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * params["scale"].float()).to(x.dtype)


def group_norm_per_channel(params, x, eps=1e-5, mask=None):
    """GroupNorm with one group per channel over (B, T, C): statistics over
    T per (batch, channel), from the valid frames only when `mask` (B, T)
    is given; var = E[x^2] - E[x]^2 as in the JAX package."""
    xf = x.float()
    if mask is None:
        n = torch.tensor(float(x.shape[1]), device=x.device)
        s1 = xf.sum(1, keepdim=True)
        s2 = (xf * xf).sum(1, keepdim=True)
    else:
        m = mask[..., None]
        n = m.float().sum(1, keepdim=True).clamp_min(1.0)
        xm = torch.where(m, xf, 0.0)
        s1 = xm.sum(1, keepdim=True)
        s2 = (xm * xm).sum(1, keepdim=True)
    mean = s1 / n
    var = (s2 / n - mean * mean).clamp_min(0.0)
    scale = torch.rsqrt(var + eps) * params["scale"].float()
    shift = params["bias"].float() - mean * scale
    return (xf * scale + shift).to(x.dtype)


ACTIVATIONS = {
    "gelu": F.gelu,
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
}


def activation(name: str):
    return ACTIVATIONS[name]


def _rows(x):
    return math.prod(x.shape[:-1])


def dropout(x, rate, key, stream=STREAM_ACT):
    """Inverted dropout at rate `rate` with the mask of (key, stream) (K10 on
    the card), rows the leading dims of x; the identity for key None or rate
    0 (the JAX package's ``layers.dropout``, whose rng becomes a
    DropoutKey).  The multiply is taken in float32, the result has x's
    dtype."""
    drop.check_key(key)
    if key is None or rate <= 0.0:
        return x
    mask = drop.dropout_mask(key, stream, _rows(x), x.shape[-1], rate,
                             x.device)
    return (x.float() * mask.view(x.shape)).to(x.dtype)


def _live(key, rate):
    return rate if key is not None and rate > 0.0 else 0.0


def _sharded_forward() -> bool:
    """Under tensor or sequence parallelism the JAX package's gates send
    every block to its XLA chain (GSPMD cannot partition a Pallas call over
    a sharded contraction or time axis); the port mirrors them."""
    return (mesh_lib.active_seq_mesh() is not None
            or mesh_lib.active_tp_mesh() is not None)


def _ffn_fused_eligible(p1, p2, x, act_name):
    """The JAX package's gate of the fused FFN kernels (its
    ``_ffn_fused_eligible``): enough rows, an activation the kernels have,
    unquantized weights, and H and F multiples of FUSED_WIDTH; never under
    tensor or sequence parallelism."""
    if _sharded_forward():
        return False
    if "kernel" not in p1 or "kernel" not in p2:
        return False
    if act_name not in ffn_kernels.ACT_CODES:
        return False
    h, f = p1["kernel"].shape
    return (_rows(x) >= FUSED_MIN_ROWS and h % FUSED_WIDTH == 0
            and f % FUSED_WIDTH == 0)


def _dense_fused_eligible(p, x):
    """The JAX package's gate of the dense epilogue kernel (its
    ``_dense_fused_eligible``): the FFN's without the activation."""
    if _sharded_forward():
        return False
    if "kernel" not in p:
        return False
    din, h = p["kernel"].shape
    return (_rows(x) >= FUSED_MIN_ROWS and din % FUSED_WIDTH == 0
            and h % FUSED_WIDTH == 0)


def ffn_apply(p1, p2, x, act_name, dtype, key=None, act_dropout=0.0,
              tp=False):
    """FFN block act(x @ W1 + b1) @ W2 + b2, dropout after the activation
    (mask of (key, STREAM_ACT)).  Blocks the gate admits run as one fused
    kernel (K9, or K13 with dropout), with K8 (its dropout entries) as the
    backward.  tp=True: W1 holds this model rank's columns and W2 its rows
    (``mesh.tp_split``); the replicated x enters through copy_to_model, the
    activation mask is this rank's own, and the partial outputs are summed
    over the model group."""
    rate = _live(key, act_dropout)
    if tp:
        mesh = mesh_lib.active_tp_mesh()
        x = collectives.copy_to_model(x, mesh)
        h = dropout(activation(act_name)(dense(p1, x, dtype)), rate,
                    mesh_lib.fold_key(key, mesh_lib.MODEL_AXIS))
        return dense(p2, h, dtype, row_parallel=True)
    if _ffn_fused_eligible(p1, p2, x, act_name):
        lead, h = x.shape[:-1], x.shape[-1]
        operands = (x.to(dtype).reshape(-1, h).contiguous(), p1["kernel"],
                    p1.get("bias"), p2["kernel"], p2.get("bias"))
        if rate:
            y = ffn_kernels.ffn_dropout_trainable(*operands, key, rate,
                                                  act_name)
        else:
            y = ffn_kernels.ffn_fused_trainable(*operands, act_name)
        return y.reshape(*lead, y.shape[-1])
    h = dropout(activation(act_name)(dense(p1, x, dtype)), rate, key)
    return dense(p2, h, dtype)


def ffn_residual_ln_apply(p1, p2, p_ln, x, act_name, dtype, eps=1e-5, *,
                          key=None, act_dropout=0.0, out_dropout=0.0,
                          tp=False):
    """Post-LN FFN block: LayerNorm(x + drop_o(drop_a(act(x @ W1 + b1)) @ W2
    + b2)), the masks of (key, STREAM_ACT) and (key, STREAM_OUT).  Blocks
    the gate admits run as one fused kernel (K3, or K12 with dropout),
    differentiable through K9 / K13, K10 and K8.  tp: as in ffn_apply."""
    act_rate, out_rate = _live(key, act_dropout), _live(key, out_dropout)
    if _ffn_fused_eligible(p1, p2, x, act_name):
        lead, h = x.shape[:-1], x.shape[-1]
        x2 = x.to(dtype).reshape(-1, h).contiguous()
        # the residual is the FFN input itself
        operands = (x2, p1["kernel"], p1.get("bias"), p2["kernel"],
                    p2.get("bias"), x2, p_ln["scale"], p_ln["bias"])
        if act_rate or out_rate:
            y = ffn_kernels.ffn_dropout_res_ln_trainable(
                *operands, key, act_rate, out_rate, act_name, eps)
        else:
            y = ffn_kernels.ffn_res_ln_trainable(*operands, act_name, eps)
        return y.reshape(*lead, y.shape[-1])
    f = ffn_apply(p1, p2, x, act_name, dtype, key, act_rate, tp=tp)
    f = dropout(f, out_rate, key, STREAM_OUT)
    return layer_norm(p_ln, x + f, eps)


def dense_residual_ln_apply(p, p_ln, x, res, dtype, eps=1e-5, *, key=None,
                            dropout_rate=0.0, row_parallel=False):
    """Post-LN attention epilogue: LayerNorm(res + drop(x @ W + b)), the
    mask of (key, STREAM_OUT).  Blocks the gate admits run as one fused
    kernel (K2, or K11 with dropout), differentiable by plain matrix
    products.  row_parallel: x holds this model rank's heads and W their
    rows (see dense)."""
    rate = _live(key, dropout_rate)
    if _dense_fused_eligible(p, x):
        lead, din = x.shape[:-1], x.shape[-1]
        h = p["kernel"].shape[1]
        operands = (x.to(dtype).reshape(-1, din).contiguous(), p["kernel"],
                    p.get("bias"), res.to(dtype).reshape(-1, h).contiguous(),
                    p_ln["scale"], p_ln["bias"])
        if rate:
            y = ffn_kernels.dense_dropout_res_ln_trainable(*operands, key,
                                                           rate, eps)
        else:
            y = ffn_kernels.dense_res_ln_trainable(*operands, eps)
        return y.reshape(*lead, h)
    a = dropout(dense(p, x, dtype, row_parallel), rate, key, STREAM_OUT)
    return layer_norm(p_ln, res + a, eps)


def cross_entropy_with_ignore(logits, labels, ignore_index=-100):
    """Mean token cross-entropy over the positions where labels !=
    ignore_index, in float32 (0 when there is none).  logits: (..., V);
    labels: (...) integers.  Under a mesh with data ranks the mean is over
    the valid tokens of the global batch: this rank's sum over the global
    count (the data group's partial losses sum to the loss)."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None]).squeeze(-1)
    nll = (logz - gold) * valid.float()
    count = mesh_lib.data_sum(valid.sum().float())
    return nll.sum() / count.clamp_min(1.0)


def kld_batchmean(student_logits, teacher_logits):
    """torch's KLDivLoss(reduction='batchmean') of log_softmax(student)
    against softmax(teacher), in float32: the sum of t (log t - s) over all
    elements, a term 0 where t == 0, divided by the (global) batch size."""
    s = torch.log_softmax(student_logits.float(), dim=-1)
    t = torch.softmax(teacher_logits.float(), dim=-1)
    log_t = torch.where(t > 0, torch.log(t.clamp_min(1e-30)), 0.0)
    return ((t * (log_t - s)).sum()
            / mesh_lib.data_global_rows(student_logits.shape[0]))


def bce_with_logits(logits, targets):
    """BCEWithLogitsLoss (mean over the global batch) in float32."""
    x = logits.float()
    terms = (torch.clamp_min(x, 0) - x * targets
             + torch.log1p(torch.exp(-x.abs())))
    m = mesh_lib.active_mesh()
    if m is None or m.n_data == 1:
        return torch.mean(terms)
    return terms.sum() / mesh_lib.data_global_rows(terms.numel())


def conv1d(params, x, stride, dtype=None):
    """x: (B, T, C_in) -> (B, T_out, C_out), VALID padding; kernel
    (C_out, C_in, K)."""
    dtype = dtype or x.dtype
    bias = params.get("bias")
    y = F.conv1d(x.to(dtype).transpose(1, 2), params["kernel"].to(dtype),
                 None if bias is None else bias.to(dtype), stride=stride)
    return y.transpose(1, 2)


def conv1d_same_grouped(params, x, groups, dtype=None):
    """The wav2vec2 positional conv: grouped, padded k//2 on both sides, one
    trailing frame removed when k is even.  x: (B, T, C); kernel
    (C_out, C_in/groups, K)."""
    dtype = dtype or x.dtype
    kernel = params["kernel"].to(dtype)
    k = kernel.shape[-1]
    bias = params.get("bias")
    y = F.conv1d(x.to(dtype).transpose(1, 2), kernel,
                 None if bias is None else bias.to(dtype), padding=k // 2,
                 groups=groups).transpose(1, 2)
    if k % 2 == 0:
        y = y[:, :-1, :]
    return y


def remat(enabled, fn, *args, **kwargs):
    """fn(*args, **kwargs); with `enabled` (the configs' ``remat``) while
    autograd records, rematerialised as the JAX package's jax.checkpoint
    of a layer: the forward keeps only the inputs, and the backward runs
    the layer's forward (its kernels included) once more before its own.
    The kernels' autograd functions save through ``ctx.save_for_backward``,
    which the checkpoint's hooks drop.  No layer draws from a torch RNG
    (dropout masks are Philox words of the layer's key; LayerDrop and
    SpecAugment draw before the loop), so the RNG state is not kept.
    Without autograd (generate, eval, predict) the call is unchanged."""
    if enabled and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kwargs)
    return fn(*args, **kwargs)
