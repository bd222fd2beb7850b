"""K4's cluster decomposition on the CPU: ``decode_attention_split_plain``
(each row's extent cut into equal shares, one a block, each share's maximum
and sum of exp(s - max), the row's statistics from the shares' in rank
order, the probabilities rounded to q's dtype after the row's
normalisation, the shares' partial P . v added in rank order) computes what
``decode_attention_plain`` and the JAX package's Pallas
``decode_attention`` (``_kernel``, ``_kernel_q8``) compute.

Same numpy inputs (seeded) on both sides.  The Pallas kernels run in
interpret mode (``force_pallas=True``); they take one query per K/V row, so
kb = 4 is held against them with K/V and mask repeated per beam.  Every
batch holds a prefix row, a row with holes before its last key, a row that
attends only a late window (the shares before it have no attended key), a
row with one key and a row that attends nothing.

Tolerances.  float32: 1e-5 absolute and relative (the decomposition sums
the scores and the values in other groupings).  bfloat16: both sides round
the same f32 probabilities, which differ in the last f32 bits, so a
probability may land one bf16 step apart (2^-8 relative): per output
element 2^-8 (P |v|) + 2^-7 |out|, the form chip_smoke.py holds the kernel
to; with one-hot values (the output is the probabilities themselves) at
most one bf16 step, on at most 1% of the entries.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechmix_tpu.ops.pallas import decode_attention as j_da
from speechmix_tpu_torch.ops.kernels import decode_attention as t_da
from torch_threads import one_torch_thread  # noqa: F401

HEADS, D, SCALE = 2, 64, 0.125
TOL = dict(rtol=1e-5, atol=1e-5)
RANGES = [16, 64, 48]        # keys a block: 48 divides none of the lengths
LENGTHS = [64, 100, 400, 1500]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _quant(x):
    amax = np.abs(x).max(axis=-1)
    scale = (np.maximum(amax, 1e-8) / 127.0).astype(np.float32)
    codes = np.clip(np.round(x / scale[..., None]), -127, 127)
    return codes.astype(np.int8), scale


def _mask(t):
    """Rows: a prefix, holes before the last key, a late window only, one
    key, nothing."""
    m = np.zeros((5, t), bool)
    m[0, :t // 2] = True
    m[1, :min(t, 37)] = True
    m[1, 1:min(t, 37) - 1:3] = False
    m[2, t - t // 4:t - t // 4 + 5] = True
    m[3, t // 3] = True
    return m


def _inputs(t, kb, int8_kv, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(5 * kb, 1, HEADS, D).astype(np.float32)
    k = rng.randn(5, t, HEADS, D).astype(np.float32)
    v = rng.randn(5, t, HEADS, D).astype(np.float32)
    scales = {}
    if int8_kv:
        (k, ks), (v, vs) = _quant(k), _quant(v)
        scales = dict(k_scale=ks, v_scale=vs)
    return q, k, v, _mask(t), scales


def _torch_args(q, k, v, mask, scales, dtype=torch.float32):
    kv = (lambda a: _t(a)) if k.dtype == np.int8 else (
        lambda a: _t(a).to(dtype))
    return ((_t(q).to(dtype), kv(k), kv(v), _t(mask)),
            dict(scale=SCALE, num_heads=HEADS,
                 **{n: _t(s) for n, s in scales.items()}))


@pytest.mark.parametrize("int8_kv", [False, True])
@pytest.mark.parametrize("kb", [1, 4])
@pytest.mark.parametrize("t", LENGTHS)
@pytest.mark.parametrize("range_keys", RANGES)
def test_split_matches_plain(range_keys, t, kb, int8_kv):
    args, kw = _torch_args(*_inputs(t, kb, int8_kv))
    got = t_da.decode_attention_split_plain(*args, range_keys=range_keys,
                                            **kw)
    ref = t_da.decode_attention_plain(*args, **kw)
    torch.testing.assert_close(got, ref, **TOL)


@pytest.mark.parametrize("int8_kv", [False, True])
@pytest.mark.parametrize("kb", [1, 4])
@pytest.mark.parametrize("t", LENGTHS)
def test_split_matches_pallas(t, kb, int8_kv):
    """The Pallas kernels in interpret mode; kb = 4 as four copies of each
    K/V row, which is what the shared K/V stands for."""
    q, k, v, mask, scales = _inputs(t, kb, int8_kv, seed=1)
    rep = lambda a: np.repeat(a, kb, axis=0)
    ref = j_da.decode_attention(
        jnp.asarray(q), jnp.asarray(rep(k)), jnp.asarray(rep(v)),
        jnp.asarray(rep(mask)), scale=SCALE, num_heads=HEADS,
        force_pallas=True,
        **{n: jnp.asarray(rep(s)) for n, s in scales.items()})
    args, kw = _torch_args(q, k, v, mask, scales)
    got = t_da.decode_attention_split_plain(*args, range_keys=64, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("int8_kv", [False, True])
@pytest.mark.parametrize("t", [100, 400])
def test_split_bf16_within_one_step(t, int8_kv):
    """bf16 q (and bf16 K/V): the outputs within the kernel's limit of the
    plain version's."""
    q, k, v, mask, scales = _inputs(t, 4, int8_kv, seed=2)
    args, kw = _torch_args(q, k, v, mask, scales, torch.bfloat16)
    got = t_da.decode_attention_split_plain(*args, range_keys=64, **kw)
    ref = t_da.decode_attention_plain(*args, **kw)
    assert got.dtype == torch.bfloat16
    q_, k_, v_, m_ = args
    pv = t_da.decode_attention_plain(q_.float(), k_, v_.abs(), m_, **kw)
    limit = 2.0 ** -8 * pv + 2.0 ** -7 * ref.float().abs()
    assert ((got.float() - ref.float()).abs() <= limit).all()


@pytest.mark.parametrize("range_keys", [16, 48])
def test_split_rounds_after_normalising(range_keys):
    """One-hot values (key i of 64 has v = e_i) and every key attended
    make the output the probabilities: the split's bf16 probabilities are
    the plain version's,
    but for an f32 rounding that crosses a bf16 boundary (one step, rare).
    A split that rounded exp(s - m_r) / sum_r before rescaling by the other
    ranges would be off by up to a bf16 step on most entries."""
    rng = np.random.RandomState(3)
    q = rng.randn(5, 1, HEADS, D).astype(np.float32)
    k = rng.randn(5, D, HEADS, D).astype(np.float32)
    v = np.broadcast_to(np.eye(D, dtype=np.float32)[None, :, None, :],
                        (5, D, HEADS, D)).copy()
    mask = np.ones((5, D), bool)    # every range holds attended keys
    args, kw = _torch_args(q, k, v, mask, {}, torch.bfloat16)
    got = t_da.decode_attention_split_plain(*args, range_keys=range_keys,
                                            **kw).float()
    ref = t_da.decode_attention_plain(*args, **kw).float()
    step = 2.0 ** -7 * ref.abs() + 1e-30
    diff = (got - ref).abs()
    assert (diff <= step).all()
    assert (diff > 0).float().mean() <= 0.01
    # the same test catches rounding before the row's normalisation
    early = _rounded_per_range(*args, range_keys=range_keys).float()
    assert ((early - ref).abs() > 0).float().mean() > 0.01


def _rounded_per_range(q, k, v, mask, range_keys):
    """The one-hot case's output when each range rounds its own softmax to
    bf16 and the ranges are then rescaled (flash-decoding's order): the
    order the cluster body must not take."""
    t = k.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * SCALE
    logits = logits + torch.where(mask[:, None, None, :], 0.0, -1e9)
    m = logits.amax(-1, keepdim=True)
    total = torch.exp(logits - m).sum(-1, keepdim=True)
    out = torch.empty_like(logits)
    for lo in range(0, t, range_keys):
        part = logits[..., lo:lo + range_keys]
        m_r = part.amax(-1, keepdim=True)
        e = torch.exp(part - m_r)
        l_r = e.sum(-1, keepdim=True)
        out[..., lo:lo + range_keys] = ((e / l_r).bfloat16().float()
                                        * (l_r * torch.exp(m_r - m) / total))
    return out.bfloat16().permute(0, 2, 1, 3)


@pytest.mark.parametrize("range_keys", [16, 48, 64, 128])
@pytest.mark.parametrize("t", [1, 64, 100, 129, 400, 1500, 2048])
def test_split_shares_cover_the_extent_once(t, range_keys):
    """At most MAX_RANKS blocks, each within `length` keys, whose shares
    cover a row's extent exactly once, in rank order, at any extent."""
    ranks, length = t_da.split_ranges(t, range_keys)
    assert 1 <= ranks <= t_da.MAX_RANKS and length == -(-t // ranks)
    for extent in sorted({1, max(1, t // 3), t}):
        shares = t_da.row_shares(extent, ranks)
        assert len(shares) == ranks
        count = np.zeros(extent, np.int64)
        for lo, hi in shares:
            assert 0 <= hi - lo <= length
            count[lo:hi] += 1
        assert (count == 1).all()
        assert [lo for lo, _ in shares] == sorted(lo for lo, _ in shares)


def test_split_ranges_of_the_decoder():
    """The cluster body's blocks at the decoder's lengths: cross-attention
    over 16 s (T = 400) in 4 blocks of at most 100 keys, over 30 s
    (T = 1500) in 6 of 250; the 64-slot cache is one block (the serial
    body's)."""
    assert t_da.split_ranges(400) == (4, 100)
    assert t_da.split_ranges(1500) == (6, 250)
    assert t_da.split_ranges(64) == (1, 64)
    assert t_da.split_ranges(2048) == (8, 256)
