"""The f32 bodies of K8 and K6 on the CPU: their products emulated as the
tensor cores take them, against the JAX package's f32 functions.

On the card an f32 product of these kernels is three tf32 products: each
operand v splits into hi = tf32(v) and lo = tf32(v - hi) (10 mantissa bits,
round to nearest, ties to even), and a b = hi_a hi_b + hi_a lo_b + lo_a hi_b
(csrc/hopper.cuh, split_tf32 and wgmma_tf32x3).  The emulation here
(`split_product`) keeps the kernels' k order: stages of 32, each a partial
sum that starts afresh, slice by slice of 8 (lo hi, hi lo, then hi hi), then
added to the f32 accumulator (hopper.cuh, consume_split).

K8 (`k8_split`) is the recompute pass (a = x w1 + b1 and dh = g w2^T in
128-row tiles, h = act(a) m, da = dh act'(a) m, da's column sums per tile),
then the products (dx = da w1^T, dw1 = x^T da and dw2 = h^T g over the f32
row ranges of dw_split_plan, added in range order; db1 the tile sums in
order).  K6 (`conv_split`) is 128-row tiles of each batch row, per tap the
stages over its channels, the bias, LayerNorm from the row sums of column
slices of 128 added in slice order, the exact-erf GELU.  They are held
against the Pallas ffn_fused_bwd and fused_conv_stack (fused_conv_layer)
in interpret mode and against _ffn_bwd_hand(amask=), with the limits
chip_smoke.py holds the kernels to: |k - p| <= 1e-4 + 1e-4 |p| for dx and
K6, 5e-4 + 1e-4 |p| for K8's weight gradients, both over (1 - r) with the
mask.  The same inputs through one-pass tf32 products (tf32(a) tf32(b))
land further from the reference: the split is what holds the limits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from speechmix_tpu.ops.pallas import conv_extractor as j_conv
from speechmix_tpu.ops.pallas import ffn_kernel as fk
from speechmix_tpu_torch.ops.kernels import ffn as t_ffn
from torch_threads import one_torch_thread  # noqa: F401

ACTS = ["gelu", "gelu_new", "relu", "silu"]
RATE = 0.1
STAGE, SLICE = 32, 8        # f32 elements a stage / a tf32 product
TOL = (1e-4, 1e-4)          # chip_smoke.py: TOL["float32"]
DW_TOL = (5e-4, 1e-4)       # chip_smoke.py: K8_DW_F32_TOL


def tf32(t):
    """t rounded to tf32: 10 mantissa bits, to nearest, ties to even."""
    u = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u)
    return u.to(torch.int32).view(torch.float32)


def split_product(a, b, passes=3):
    """a @ b (f32) as the kernels' tensor cores take it: per stage of 32 of
    K a partial started afresh, per slice of 8 its products added to it, the
    partial added to the f32 result.  passes=3: lo hi + hi lo + hi hi of the
    tf32 halves; passes=1: one tf32 product, tf32(a) tf32(b)."""
    k = a.shape[1]
    pad = -k % STAGE
    a, b = F.pad(a, (0, pad)), F.pad(b, (0, 0, 0, pad))
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    out = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, k + pad, STAGE):
        part = torch.zeros_like(out)
        for s in range(k0, k0 + STAGE, SLICE):
            ks = slice(s, s + SLICE)
            terms = ((a_hi, b_hi),) if passes == 1 else (
                (a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi))
            for p, q in terms:
                part = part + p[:, ks] @ q[ks]
        out = out + part
    return out


def _inputs(n, h, f, seed, masked=False):
    rng = np.random.RandomState(seed)
    mk = lambda *s, sc=1.0: (rng.randn(*s) * sc).astype(np.float32)
    a = dict(x=mk(n, h, sc=0.5), g=mk(n, h), w1=mk(h, f, sc=0.1),
             b1=mk(f, sc=0.1), w2=mk(f, h, sc=0.1), amask=None)
    if masked:
        a["amask"] = ((rng.rand(n, f) >= RATE) / (1.0 - RATE)).astype(
            np.float32)
    return a


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def k8_split(a, act, passes=3):
    """K8's f32 body: (dx, dw1, db1, dw2)."""
    x, g, w1, b1, w2 = (_t(a[k]) for k in ("x", "g", "w1", "b1", "w2"))
    amask = _t(a["amask"])
    n = x.shape[0]
    pre = split_product(x, w1, passes) + b1
    dh = split_product(g, w2.t(), passes)
    hid = t_ffn.act_f32(act, pre)
    da = dh * t_ffn.dact_f32(act, pre)
    if amask is not None:
        hid, da = hid * amask, da * amask
    tiles = [da[t0:t0 + t_ffn.ROW_TILE].sum(0)
             for t0 in range(0, n, t_ffn.ROW_TILE)]
    splits, rows = t_ffn.dw_split_plan(n, t_ffn.DW_ROWS_PER_SPLIT_F32)
    cuts = [slice(s * rows, (s + 1) * rows) for s in range(splits)]
    dx = split_product(da, w1.t(), passes)
    dw1 = t_ffn._ordered_sum([split_product(x[c].t(), da[c], passes)
                              for c in cuts])
    dw2 = t_ffn._ordered_sum([split_product(hid[c].t(), g[c], passes)
                              for c in cuts])
    return dx, dw1, t_ffn._ordered_sum(tiles), dw2


def _worst(got, ref, tol, rate=0.0):
    """The largest |got - ref| / limit of the pairs, limit (atol + rtol
    |ref|) / (1 - rate)."""
    worst = 0.0
    for o, r in zip(got, ref):
        o = torch.as_tensor(np.array(o)).double()
        r = torch.as_tensor(np.array(r)).double()
        lim = (tol[0] + tol[1] * r.abs()) / (1.0 - rate)
        worst = max(worst, ((o - r).abs() / lim).max().item())
    return worst


def _k8_ratios(got, ref, rate=0.0):
    return max(_worst(got[:1], ref[:1], TOL, rate),
               _worst(got[1:4], ref[1:4], DW_TOL, rate))


@pytest.fixture
def short_ranges(monkeypatch):
    """f32 row ranges of 64 rows, so that 200 rows cut into four."""
    monkeypatch.setattr(t_ffn, "DW_ROWS_PER_SPLIT_F32", 64)


def test_split_product_is_f32_accurate():
    """The three-product emulation against the float64 product: within a
    few 2^-22 of sum |a||b| (the split's), where one tf32 product, whose
    terms are each off by up to 2^-10, lands a hundred times further."""
    rng = np.random.RandomState(1)
    a = torch.from_numpy(rng.randn(64, 300).astype(np.float32))
    b = torch.from_numpy(rng.randn(300, 48).astype(np.float32))
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    err3 = ((split_product(a, b).double() - exact).abs() / scale).max()
    err1 = ((split_product(a, b, 1).double() - exact).abs() / scale).max()
    assert err3 < 4 * 2.0 ** -22
    assert err1 > 100 * err3
    v = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -2.5])
    assert tf32(v).tolist() == [1.0, 1.0 + 4 * 2.0 ** -11, -2.5]


@pytest.mark.parametrize("act", ACTS)
def test_k8_split_matches_pallas(act, short_ranges):
    """No mask: the Pallas ffn_fused_bwd in interpret mode, 256 rows in
    four ranges."""
    a = _inputs(256, 128, 256, seed=11)
    ref = fk.ffn_fused_bwd(*(jnp.asarray(a[k]) for k in ("x", "g", "w1",
                                                         "b1", "w2")),
                           act=act, block_rows=128, block_f=128,
                           interpret=True)
    split = _k8_ratios(k8_split(a, act), ref)
    assert split <= 1.0, f"worst err / limit {split:.3g}"
    assert _k8_ratios(k8_split(a, act, passes=1), ref) > split


@pytest.mark.parametrize("n", [256, 200])
@pytest.mark.parametrize("act", ACTS)
def test_k8_split_with_mask_matches_ffn_bwd_hand(act, n, short_ranges):
    """The dropout recompute's function: _ffn_bwd_hand given the same
    mask; n = 200 fills neither a row tile nor a range."""
    a = _inputs(n, 128, 256, seed=13, masked=True)
    ref = fk._ffn_bwd_hand(jnp.asarray(a["x"]), jnp.asarray(a["w1"]),
                           jnp.asarray(a["b1"]), jnp.asarray(a["w2"]),
                           jnp.asarray(a["g"]), act,
                           amask=jnp.asarray(a["amask"]))
    split = _k8_ratios(k8_split(a, act), ref, RATE)
    assert split <= 1.0, f"worst err / limit {split:.3g}"
    assert _k8_ratios(k8_split(a, act, passes=1), ref, RATE) > split


def conv_split(x, kernel, bias, norm, eps=1e-5, passes=3):
    """K6's f32 body: x (B, T_in, C), kernel (k, C_in, C_out) as the JAX
    package holds it."""
    b, t_in, c = x.shape
    k = kernel.shape[0]
    t_out = (t_in - k) // 2 + 1
    out = torch.empty(b, t_out, c)
    for bi in range(b):
        for t0 in range(0, t_out, 128):
            t1 = min(t0 + 128, t_out)
            acc = torch.zeros(t1 - t0, c)
            for j in range(k):
                rows = x[bi, 2 * t0 + j:2 * (t1 - 1) + j + 1:2]
                acc = acc + split_product(rows, kernel[j], passes)
            acc = acc + bias
            if norm is not None:
                def row_sum(t):
                    total = torch.zeros(t.shape[0])
                    for part in t.split(128, dim=-1):
                        total = total + part.sum(-1)
                    return total[:, None]
                dev = acc - row_sum(acc) / c
                acc = (dev * torch.rsqrt(row_sum(dev * dev) / c + eps)
                       * norm["scale"] + norm["bias"])
            out[bi, t0:t1] = F.gelu(acc)
    return out


@pytest.mark.parametrize("ln", [False, True])
@pytest.mark.parametrize("c,t_in", [(32, 301), (256, 263), (1024, 69)])
def test_conv_split_matches_pallas_layer(c, t_in, ln):
    """C = 32 (tiny-speech: one block of 64 columns), 256 (a cluster of
    two) and 1024 (of eight), k = 3, a ragged row tile at C = 32 and 256;
    against fused_conv_stack with one layer (its fused_conv_layer) in
    interpret mode."""
    k, b = 3, 2
    rng = np.random.RandomState(20 + c + ln)
    layer = {"conv": {
        "kernel": (rng.randn(k, c, c) / np.sqrt(k * c)).astype(np.float32),
        "bias": (rng.randn(c) * 0.1).astype(np.float32)}}
    if ln:
        layer["norm"] = {"scale": (1 + 0.1 * rng.randn(c)).astype(np.float32),
                         "bias": (0.1 * rng.randn(c)).astype(np.float32)}
    x = rng.randn(b, t_in, c).astype(np.float32)
    ref = j_conv.fused_conv_stack(
        jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, [layer]), (k,),
        (2,), bt=32, ln_layers=ln, interpret=True)
    norm = ({n_: _t(v) for n_, v in layer["norm"].items()} if ln else None)
    args = (_t(x), _t(layer["conv"]["kernel"]), _t(layer["conv"]["bias"]),
            norm)
    got = conv_split(*args)
    assert got.shape == (b, (t_in - k) // 2 + 1, c)
    split = _worst([got], [ref], TOL)
    assert split <= 1.0, f"worst err / limit {split:.3g}"
    assert _worst([conv_split(*args, passes=1)], [ref], TOL) > split
