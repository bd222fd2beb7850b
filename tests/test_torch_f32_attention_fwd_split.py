"""The f32 body of K1 / K14 (csrc/attention_fwd.cu) on the CPU: its
arithmetic emulated as the tensor cores take it, against the JAX package.

On the card every product of the f32 forward is three tf32 products of
split operands: an operand x serves as its own hi half, trunc(x) (the
tensor cores read its top 19 bits), beside lo = tf32(x - trunc(x)) rounded
to nearest with ties away from zero (cvt.rna); a b is lo_a hi_b + hi_a lo_b
+ hi_a hi_b, added in that order slice by slice of 8 (the helpers of
test_torch_f32_attention_bwd_split.py).  The emulation (`f32_split_fwd`)
keeps the kernel's structure: blocks of 128 queries (64 where the head is
padded to 128 columns) walk stages of 64 keys (32 at 128 columns); per
stage S = q k^T over the padded head (zeros past D) in one accumulator, the
exclusions (-1e30 for a masked key or one after the query under causal,
-inf past Tk), the online softmax in log2 units (running max m, the
rescale 2^(m_old - m_new), the f32 denominator of the undropped
probabilities), P times the dropout mask, P v as a partial of the stage
(P split as an operand) folded into O as O alpha + partial, then out = O /
l and lse = m ln 2 + log l; under `causal` a block stops at the stage of
its last query unless a row of it has no valid key at or before its query.
It is held against the Pallas flash_attention_fused_layout and
flash_attention_masked's single-pass kernel in interpret mode,
_attn_ref_fwd and, given JAX's mask, _dropout_ref_fwd, at chip_smoke.py's
f32 limits: |k - r| <= 1e-4 + 1e-4 |r|, over (1 - rate) with the mask.  The
same inputs through one-pass tf32 products land beyond them: the split is
what holds the limits.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechmix_tpu.ops.pallas import flash_attention_kernel as fak
from speechmix_tpu_torch.ops.kernels import attention as t_attn
from test_torch_f32_attention_bwd_split import rna, tc_product, trunc
from torch_threads import one_torch_thread  # noqa: F401

HEADS = 2
TOL = (1e-4, 1e-4)         # chip_smoke.py: TOL["float32"]
RATE = 0.2
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
NEG2 = np.float32(-1e30) * np.float32(LOG2E)


def plan(d):
    """(padded head width, keys of a stage, queries of a block) of the
    body for head width d."""
    return (64, 64, 128) if d <= 64 else (128, 32, 64)


def f32_split_fwd(q, k, v, kv_mask, heads, scale, causal, dmask=None,
                  passes=3):
    """(out, lse) of the f32 body; slabs (B, T, H*D), kv_mask (B, Tk)
    bool, dmask (B, H, Tq, Tk) float32 or None."""
    b, tq, hd = q.shape
    tk = k.shape[1]
    d = hd // heads
    dp_w, sk, rows = plan(d)
    tqp, tkp = -(-tq // rows) * rows, -(-tk // sk) * sk

    def heads_of(x, t, tp):
        x = x.float().reshape(b, t, heads, d).transpose(1, 2)
        return torch.nn.functional.pad(x, (0, dp_w - d, 0, tp - t))
    qf = heads_of(q, tq, tqp)
    kf, vf = heads_of(k, tk, tkp), heads_of(v, tk, tkp)
    valid = torch.nn.functional.pad(kv_mask.bool(), (0, tkp - tk))
    if dmask is not None:
        dmask = torch.nn.functional.pad(dmask.float(),
                                        (0, tkp - tk, 0, tqp - tq))
    sl2 = np.float32(scale) * np.float32(LOG2E)
    out = torch.zeros(b, heads, tqp, dp_w)
    lse = torch.zeros(b, heads, tqp)
    stages = tkp // sk
    for q0 in range(0, tqp, rows):
        qs = slice(q0, q0 + rows)
        qi = torch.arange(q0, q0 + rows)[:, None]
        visit = torch.full((b,), stages)
        if causal:
            has_key = valid[:, :min(q0, tk - 1) + 1].any(1)
            last = min(q0 + rows, tq) - 1
            visit = torch.where(has_key, min(stages, last // sk + 1), visit)
        m = torch.full((b, heads, rows, 1), -torch.inf)
        l = torch.zeros(b, heads, rows, 1)
        o = torch.zeros(b, heads, rows, dp_w)
        for n in range(stages):
            ks = slice(n * sk, (n + 1) * sk)
            kj = torch.arange(n * sk, (n + 1) * sk)[None, :]
            s = tc_product(qf[:, :, qs], kf[:, :, ks].transpose(-1, -2),
                           passes)
            allowed = valid[:, None, None, ks]
            if causal:
                allowed = allowed & (kj <= qi)
            x = torch.where(allowed, s * sl2,
                            torch.where(kj < tk, torch.tensor(NEG2),
                                        torch.tensor(-torch.inf)))
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new)
            l_new = l * alpha + p.sum(-1, keepdim=True)
            if dmask is not None:
                p = p * dmask[:, :, qs, ks]
            part = tc_product(p, vf[:, :, ks], passes)
            step = (n < visit)[:, None, None, None]
            o = torch.where(step, o * alpha + part, o)
            l = torch.where(step, l_new, l)
            m = torch.where(step, m_new, m)
        out[:, :, qs] = o / l.clamp_min(1e-30)
        lse[:, :, qs] = (m * LN2 + torch.log(l))[..., 0]
    out = out[:, :, :tq, :d].transpose(1, 2).reshape(b, tq, hd)
    return out, lse[:, :, :tq]


def _inputs(tq, tk, d, lens, seed, heads=HEADS, first_key=None):
    """q (B, tq, H, d); k, v (B, tk, H, d); the keys of batch row i valid
    below lens[i] (and, with first_key, the middle row's from it on)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(len(lens), tq, heads, d).astype(np.float32)
    k, v = (rng.randn(len(lens), tk, heads, d).astype(np.float32)
            for _ in range(2))
    mask = np.arange(tk)[None, :] < np.array(lens)[:, None]
    if first_key is not None:
        mask[1, :first_key] = False
    return q, k, v, mask


def _slab(a):
    b, t, h, d = a.shape
    return torch.from_numpy(np.ascontiguousarray(a)).reshape(b, t, h * d)


def _split(q, k, v, mask, causal, dmask=None, passes=3):
    heads, d = q.shape[2], q.shape[3]
    return f32_split_fwd(*(_slab(a) for a in (q, k, v)),
                         torch.from_numpy(mask), heads, d ** -0.5, causal,
                         dmask, passes)


def _worst(got, ref, rate=0.0):
    """The largest |got - ref| / limit."""
    ref = np.asarray(jnp.asarray(ref, jnp.float32)).reshape(got.shape)
    assert torch.isfinite(got).all()
    lim = (TOL[0] + TOL[1] * np.abs(ref)) / (1.0 - rate)
    return float((np.abs(got.numpy() - ref) / lim).max())


def _held(q, k, v, mask, causal, ref, rate=0.0, dmask=None):
    split = _worst(_split(q, k, v, mask, causal, dmask)[0], ref, rate)
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
    """flash_attention_fused_layout (_attn_single_fused_kernel), the TPU
    kernel K1 replaces, in interpret mode."""
    q, k, v, mask = _inputs(tq, tk, d, lens, seed=tq + d + causal)
    ref = fak.flash_attention_fused_layout(
        *(jnp.asarray(_slab(a).numpy()) for a in (q, k, v)),
        jnp.asarray(mask), heads=HEADS, scale=d ** -0.5, causal=causal)
    assert ref is not None
    _held(q, k, v, mask, causal, ref)


@pytest.mark.parametrize("causal", [False, True])
def test_split_matches_single_pass_kernel(causal, interpret):
    """flash_attention_masked's single-pass kernel (_attn_single_kernel,
    one head: the (B*H, T, D) layout) in interpret mode."""
    q, k, v, mask = _inputs(130, 200, 64, [200, 77, 0], seed=21, heads=1)
    ref = fak.flash_attention_masked.__wrapped__(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask),
        causal=causal, scale=0.125)
    _held(q, k, v, mask, causal, ref)


@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_split_matches_reference_forward(causal, d):
    q, k, v, mask = _inputs(200, 200, d, [200, 163, 0], seed=5)
    ref = fak._attn_ref_fwd(*(jnp.asarray(a) for a in (q, k, v)),
                            jnp.asarray(mask), d ** -0.5, causal)
    _held(q, k, v, mask, causal, ref)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk,lens", CASES)
def test_split_with_mask_matches_dropout_reference(tq, tk, lens, causal):
    """K14's body with JAX's mask: P times the mask before P v, the
    denominator and lse undropped."""
    seed, d = 7, 64
    q, k, v, mask = _inputs(tq, tk, d, lens, seed=11)
    ref = fak._dropout_ref_fwd(*(jnp.asarray(a) for a in (q, k, v)),
                               jnp.asarray(mask), seed, d ** -0.5, causal,
                               RATE)
    dmask = torch.from_numpy(np.array(fak._xla_dropout_mask(
        seed, (len(lens), HEADS, tq, tk), RATE), np.float32))
    _held(q, k, v, mask, causal, ref, RATE, dmask)


@pytest.mark.parametrize("d", [64, 128])
def test_causal_rows_without_an_allowed_key(d):
    """Causal, the middle batch row's keys valid from 150 on: its queries
    below 150 (some in a block beside rows that have a key, so that block
    visits every stage) average all Tk values, as the reference does; so
    does the key-length-0 row."""
    t, first = 300, 150
    q, k, v, mask = _inputs(t, t, d, [t, t, 0], seed=3, first_key=first)
    ref = fak._attn_ref_fwd(*(jnp.asarray(a) for a in (q, k, v)),
                            jnp.asarray(mask), d ** -0.5, True)
    _held(q, k, v, mask, True, ref)
    out = _split(q, k, v, mask, True)[0]
    mean_v = _slab(v).mean(1)
    lim = TOL[0] + TOL[1] * mean_v.abs()
    assert ((out[1, :first] - mean_v[1]).abs() <= lim[1]).all()
    assert ((out[2] - mean_v[2]).abs() <= lim[2]).all()


@pytest.mark.parametrize("causal", [False, True])
def test_one_pass_tf32_lands_further(causal):
    """The same inputs through one tf32 product each: further from the
    reference than the split, and beyond the f32 limits."""
    q, k, v, mask = _inputs(200, 200, 64, [200, 163, 0], seed=13)
    ref = fak._attn_ref_fwd(*(jnp.asarray(a) for a in (q, k, v)),
                            jnp.asarray(mask), 0.125, causal)
    split = _held(q, k, v, mask, causal, ref)
    one = _worst(_split(q, k, v, mask, causal, passes=1)[0], ref)
    assert one > 1.0 and one > 4 * split, (one, split)


@pytest.mark.parametrize("tq,tk,d,causal", [(130, 200, 80, False),
                                            (200, 130, 64, True),
                                            (1, 70, 128, False)])
def test_split_matches_untiled_plain(tq, tk, d, causal):
    """Output and lse against the port's untiled plain version (the f32
    path's CPU stand-in): query and key lengths apart, a single query, a
    row without a valid key."""
    q, k, v, mask = _inputs(tq, tk, d, [tk, tk - 33, 0], seed=17)
    args = (*(_slab(a) for a in (q, k, v)), torch.from_numpy(mask), HEADS,
            d ** -0.5, causal)
    ref, ref_lse = t_attn.attention_fwd_plain(*args, return_lse=True)
    out, lse = f32_split_fwd(*args)
    assert _worst(out, ref.numpy()) <= 1.0
    assert _worst(lse, ref_lse.numpy()) <= 1.0


def test_rounding_of_the_probabilities():
    """P enters P v as its own hi half and rna(P - trunc(P)): the pair is P
    within 2^-21 P, where one tf32 rounding is 2^-11 off."""
    p = torch.from_numpy(np.random.RandomState(0).rand(1000).astype(
        np.float32))
    hi = trunc(p)
    lo = rna(p - hi)
    err = (hi.double() + lo.double() - p.double()).abs() / p.double()
    assert err.max() <= 2.0 ** -21
    assert (rna(p).double() - p.double()).abs().max() > 2.0 ** -13
