"""The f32 body of K7 / K15 (csrc/attention_bwd.cu) on the CPU: its
arithmetic emulated as the tensor cores take it, against the JAX package.

On the card every product of the f32 backward is three tf32 products of
split operands.  The tensor cores read the top 19 bits of an f32 element,
so an operand v serves as its own hi half, trunc(v), beside lo =
tf32(v - trunc(v)), rounded to nearest with ties away from zero (cvt.rna);
a b is then lo_a hi_b + hi_a lo_b + hi_a hi_b, added in that order slice by
slice of 8.  The emulation (`f32_split_bwd`) keeps the kernels' structure:
delta = rowsum(g * out); per 32-query stage the dk/dv pass forms s^T = k q^T
and dp^T = v g^T over the padded head (64 or 128 columns, zeros past D) in
one accumulator, p = 2^(s scale log2(e) - lse log2(e)) where allowed (1 / Tk
on a row whose lse <= -1e29), ds = p (dp m - delta), and dv, dk as a partial
per stage (4 slices) added to the f32 sums; the dq pass likewise over
32-key stages.  It is held against the JAX package's Pallas backward kernels
in interpret mode (_flash_bwd_fused_layout, and _trainable_bwd's
_attn_bwd_kernel), jax.grad of flash_attention_trainable, and, given JAX's
mask, _dropout_ref_bwd, at chip_smoke.py's f32 limits: |k - r| <= 1e-4 +
1e-4 |r|, over (1 - rate) with the mask.  The same inputs through one-pass
tf32 products land further from the references: the split is what holds
the limits.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechmix_tpu.ops.pallas import flash_attention_kernel as fak
from speechmix_tpu_torch.ops.kernels import attention as t_attn
from torch_threads import one_torch_thread  # noqa: F401

HEADS = 2
TOL = (1e-4, 1e-4)         # chip_smoke.py: TOL["float32"]
RATE = 0.2
STAGE, SLICE = 32, 8       # rows of a stage, of a tf32 product
LOG2E = 1.4426950408889634


def _bits(t):
    return t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _float(u):
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u)
    return u.to(torch.int32).view(torch.float32)


def trunc(t):
    """t as the tensor cores read it: its top 19 bits."""
    return _float(_bits(t) & 0xFFFFE000)


def rna(t):
    """t rounded to tf32, to nearest, ties away from zero (cvt.rna)."""
    return _float((_bits(t) + 0x1000) & 0xFFFFE000)


def tc_product(a, b, passes=3):
    """a @ b over K (a multiple of 8) as the tensor cores take it: slice by
    slice of 8 into one accumulator; passes=3: lo_a hi_b, hi_a lo_b, hi_a
    hi_b of the split; passes=1: one tf32 product rna(a) rna(b)."""
    if passes == 1:
        terms = ((rna(a), rna(b)),)
    else:
        a_hi, b_hi = trunc(a), trunc(b)
        a_lo, b_lo = rna(a - a_hi), rna(b - b_hi)
        terms = ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi))
    acc = None
    for s in range(0, a.shape[-1], SLICE):
        for x, y in terms:
            part = x[..., s:s + SLICE] @ y[..., s:s + SLICE, :]
            acc = part if acc is None else acc + part
    return acc


def f32_split_bwd(q, k, v, kv_mask, out, lse, g, heads, scale, causal,
                  dmask=None, passes=3):
    """(dq, dk, dv) of the f32 body; slabs (B, T, H*D), lse (B, H, Tq),
    dmask (B, H, Tq, Tk) float32 or None."""
    b, tq, hd = q.shape
    tk = k.shape[1]
    d = hd // heads
    dp_w = 64 if d <= 64 else 128
    tqp, tkp = -(-tq // STAGE) * STAGE, -(-tk // STAGE) * STAGE

    def heads_of(x, t, tp):
        x = x.float().reshape(b, t, heads, d).transpose(1, 2)
        return torch.nn.functional.pad(x, (0, dp_w - d, 0, tp - t))
    qf, gf, of = (heads_of(x, tq, tqp) for x in (q, g, out))
    kf, vf = (heads_of(x, tk, tkp) for x in (k, v))
    delta = (gf * of).sum(-1)                              # (B, H, Tqp)
    lse = torch.nn.functional.pad(lse.float(), (0, tqp - tq))
    lse2 = lse * np.float32(LOG2E)
    sl2 = np.float32(scale) * np.float32(LOG2E)
    valid = torch.nn.functional.pad(kv_mask.bool(), (0, tkp - tk))
    qi = torch.arange(tqp)[:, None]
    kj = torch.arange(tkp)[None, :]
    allowed = valid[:, None, None, :] & (qi < tq) & (kj < tk)
    if causal:
        allowed = allowed & (kj <= qi)
    uniform = (lse <= -1e29)[..., None] & (qi < tq) & (kj < tk)
    m = torch.ones(b, heads, tqp, tkp)
    if dmask is not None:
        m = torch.nn.functional.pad(dmask.float(), (0, tkp - tk, 0, tqp - tq))

    def probs(s, qs, ks):
        """p of the (queries qs, keys ks) block from its logits s."""
        e = torch.exp2(s * sl2 - lse2[:, :, qs, None])
        p = torch.where(allowed[:, :, qs, ks], e, 0.0)
        return torch.where(uniform[:, :, qs, ks], 1.0 / tk, p)

    dq, dk, dv = torch.zeros_like(qf), torch.zeros_like(kf), torch.zeros_like(vf)
    # dk / dv pass: keys as M, 32-query stages
    for q0 in range(0, tqp, STAGE):
        qs = slice(q0, q0 + STAGE)
        s_t = tc_product(kf, qf[:, :, qs].transpose(-1, -2), passes)
        dp_t = tc_product(vf, gf[:, :, qs].transpose(-1, -2), passes)
        p = probs(s_t.transpose(-1, -2), qs, slice(None))     # (.., 32, Tkp)
        mm = m[:, :, qs]
        ds = p * (dp_t.transpose(-1, -2) * mm - delta[:, :, qs, None])
        dv = dv + tc_product((p * mm).transpose(-1, -2), gf[:, :, qs], passes)
        dk = dk + tc_product(ds.transpose(-1, -2), qf[:, :, qs], passes)
    # dq pass: queries as M, 32-key stages
    for k0 in range(0, tkp, STAGE):
        ks = slice(k0, k0 + STAGE)
        s = tc_product(qf, kf[:, :, ks].transpose(-1, -2), passes)
        dpm = tc_product(gf, vf[:, :, ks].transpose(-1, -2), passes)
        p = probs(s, slice(None), ks)
        ds = p * (dpm * m[:, :, :, ks] - delta[..., None])
        dq = dq + tc_product(ds, kf[:, :, ks], passes)

    def slab(x, t):
        return x[:, :, :t, :d].transpose(1, 2).reshape(b, t, hd)
    return slab(dq * scale, tq), slab(dk * scale, tk), slab(dv, tk)


def _inputs(tq, tk, d, lens, seed):
    rng = np.random.RandomState(seed)
    q, g = (rng.randn(len(lens), tq, HEADS, d).astype(np.float32)
            for _ in range(2))
    k, v = (rng.randn(len(lens), tk, HEADS, d).astype(np.float32)
            for _ in range(2))
    mask = np.arange(tk)[None, :] < np.array(lens)[:, None]
    return q, k, v, g, mask


def _slab(a):
    b, t, h, d = a.shape
    return torch.from_numpy(np.ascontiguousarray(a)).reshape(b, t, h * d)


def _split(q, k, v, g, mask, causal, dmask=None, passes=3):
    """The forward's output and lse (plain version), then the emulation."""
    scale = q.shape[-1] ** -0.5
    qs, ks, vs, gs = (_slab(a) for a in (q, k, v, g))
    tm = torch.from_numpy(mask)
    out, lse = t_attn.attention_fwd_plain(qs, ks, vs, tm, HEADS, scale, causal,
                                          return_lse=True, dmask=dmask)
    return f32_split_bwd(qs, ks, vs, tm, out, lse, gs, HEADS, scale, causal,
                         dmask, passes)


def _worst(got, refs, rate=0.0):
    """The largest |got - ref| / limit of dq, dk, dv."""
    worst = 0.0
    for o, r in zip(got, refs):
        r = np.asarray(jnp.asarray(r, jnp.float32)).reshape(o.shape)
        assert torch.isfinite(o).all()
        lim = (TOL[0] + TOL[1] * np.abs(r)) / (1.0 - rate)
        worst = max(worst, float((np.abs(o.numpy() - r) / lim).max()))
    return worst


def _held(q, k, v, g, mask, causal, refs, rate=0.0, dmask=None):
    split = _worst(_split(q, k, v, g, mask, causal, dmask), refs, rate)
    assert split <= 1.0, f"worst err / limit {split:.3g}"
    return split


@pytest.fixture
def interpret(monkeypatch):
    """The JAX package's Pallas calls in interpret mode."""
    monkeypatch.setattr(fak.pl, "pallas_call",
                        functools.partial(fak.pl.pallas_call, interpret=True))


# (Tq, Tk, key lengths): a row without a valid key where Tk is a multiple of
# 8 (the Pallas kernels pad keys to 8, and such a row averages the padding)
CASES = [(100, 100, [100, 63]), (200, 200, [200, 163, 0]),
         (130, 200, [200, 77, 0])]


@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk,lens", CASES)
def test_split_matches_fused_layout_kernel(tq, tk, lens, causal, d,
                                           interpret):
    """_flash_bwd_fused_layout (_attn_bwd_fused_kernel) in interpret mode."""
    q, k, v, g, mask = _inputs(tq, tk, d, lens, seed=tq + d + causal)
    refs = fak._flash_bwd_fused_layout(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask),
        jnp.asarray(g), scale=d ** -0.5, causal=causal)
    assert refs is not None
    _held(q, k, v, g, mask, causal, refs)


@pytest.mark.parametrize("causal", [False, True])
def test_split_matches_trainable_bwd_kernel(causal, interpret, monkeypatch):
    """_trainable_bwd's per-head kernel (_attn_bwd_kernel) in interpret
    mode, taken as on the TPU with the fused layout declined."""
    monkeypatch.setattr(fak, "_bwd_kernel_ok", lambda tq, tk: True)
    monkeypatch.setattr(fak, "_bwd_fused_hb", lambda q, k: None)
    q, k, v, g, mask = _inputs(200, 200, 64, [200, 163, 0], seed=3)
    dq, dk, dv, _ = fak._trainable_bwd(
        64 ** -0.5, causal,
        (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask)),
        jnp.asarray(g))
    _held(q, k, v, g, mask, causal, (dq, dk, dv))


@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("causal", [False, True])
def test_split_matches_jax_grad(causal, d):
    """jax.grad of the JAX package's differentiable attention."""
    q, k, v, g, mask = _inputs(200, 200, d, [200, 163, 0], seed=5)

    def loss(q_, k_, v_):
        out = fak.flash_attention_trainable(q_, k_, v_, jnp.asarray(mask),
                                            d ** -0.5, causal)
        return jnp.sum(out * jnp.asarray(g))
    refs = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                               for a in (q, k, v)))
    _held(q, k, v, g, mask, causal, refs)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk,lens", CASES)
def test_split_with_mask_matches_dropout_reference(tq, tk, lens, causal):
    """K15's body with JAX's mask: p m in dv, dp m in ds."""
    seed, d = 7, 64
    q, k, v, g, mask = _inputs(tq, tk, d, lens, seed=11)
    refs = fak._dropout_ref_bwd(*(jnp.asarray(a) for a in (q, k, v)),
                                jnp.asarray(mask), seed, d ** -0.5, causal,
                                RATE, jnp.asarray(g))
    dmask = torch.from_numpy(np.array(fak._xla_dropout_mask(
        seed, (len(lens), HEADS, tq, tk), RATE), np.float32))
    _held(q, k, v, g, mask, causal, refs, RATE, dmask)


@pytest.mark.parametrize("causal", [False, True])
def test_one_pass_tf32_lands_further(causal):
    """The same inputs through one tf32 product each: further from the
    reference than the split, and beyond the f32 limits."""
    q, k, v, g, mask = _inputs(200, 200, 64, [200, 163, 0], seed=13)
    refs = fak._attn_ref_bwd(*(jnp.asarray(a) for a in (q, k, v)),
                             jnp.asarray(mask), 64 ** -0.5, causal,
                             jnp.asarray(g))
    split = _held(q, k, v, g, mask, causal, refs)
    one = _worst(_split(q, k, v, g, mask, causal, passes=1), refs)
    assert one > 1.0 and one > 4 * split, (one, split)


def test_split_matches_untiled_plain():
    """The emulation against the port's untiled plain version (the f32
    path's CPU stand-in), a row without a valid key included."""
    q, k, v, g, mask = _inputs(130, 200, 80, [200, 77, 0], seed=17)
    qs, ks, vs, gs = (_slab(a) for a in (q, k, v, g))
    refs = t_attn.attention_bwd_plain(qs, ks, vs, torch.from_numpy(mask), gs,
                                      HEADS, 80 ** -0.5, False)
    _held(q, k, v, g, mask, False, [r.numpy() for r in refs])


def test_rounding_helpers():
    """trunc keeps the top 19 bits; rna rounds half away from zero; hi + lo
    of the split is v within 2^-21 |v|."""
    v = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 3 * 2.0 ** -11, -2.5])
    assert rna(v).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                               1.0 + 2.0 ** -9, -2.5]
    assert trunc(v).tolist() == [1.0, -1.0, 1.0 + 2.0 ** -10, -2.5]
    x = torch.from_numpy(np.random.RandomState(0).randn(1000).astype(
        np.float32))
    hi = trunc(x)
    lo = rna(x - hi)
    err = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs())
    assert err.max() <= 2.0 ** -21
