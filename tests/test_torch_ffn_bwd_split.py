"""K8's bfloat16 structure on the CPU: the recompute pass (h, da and da's
column sums per 128-row tile, once) followed by the products (dx, dw1, dw2
over fixed row ranges added in order, db1 from the tile sums) computes what
``ffn_bwd_plain`` and the JAX package compute, and the host's row plans cover
every row exactly once.

Same numpy inputs (seeded) on both sides.  The Pallas ``ffn_fused_bwd``
runs in interpret mode; the masked cases are held against the TPU package's
``_ffn_bwd_hand(amask=)``, the backward its dropout functions run.  On the
CPU the port's entry wrappers run their plain versions, which are what the
CUDA kernels are held against on the card.

Tolerances: per element, from the error of f32 sums taken in another
grouping (``_limits``).  A sum of n terms in f32 is off from the exact sum
by at most n 2^-24 sum |terms| in any order, so two groupings differ by at
most 2 n 2^-24 sum |terms|: dx = da w1^T over F, dw1 = x^T da, db1 = sum da
and dw2 = h^T g over the N rows.  Against ``ffn_bwd_plain`` (the same h and
da, to the bit) that is the whole limit; against the JAX package, which
computes h and da itself, the limit adds what their own f32 sums over H may
move them (|act'| <= 1.2, |act''| <= 1).  bfloat16: dx bit for bit (equal
roundings of equal f32 values), the f32 weight gradients within the same
limits.  The limits still catch a 64-row range dropped or counted twice
(``test_split_limit_catches_a_range_dropped_or_doubled``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechmix_tpu.ops.pallas import ffn_kernel as fk
from speechmix_tpu_torch.ops.kernels import ffn as t_ffn
from torch_threads import one_torch_thread  # noqa: F401

ACTS = ["gelu", "gelu_new", "relu", "silu"]
RATE = 0.1
U = 2.0 ** -24
NAMES = ("dx", "dw1", "db1", "dw2")


def _inputs(n, h=128, f=256, seed=0, masked=False):
    rng = np.random.RandomState(seed)
    mk = lambda *s, sc=1.0: (rng.randn(*s) * sc).astype(np.float32)
    a = dict(x=mk(n, h, sc=0.5), g=mk(n, h), w1=mk(h, f, sc=0.1),
             b1=mk(f, sc=0.1), w2=mk(f, h, sc=0.1))
    a["amask"] = None
    if masked:
        keep = rng.rand(n, f) >= RATE
        a["amask"] = (keep / (1.0 - RATE)).astype(np.float32)
    return a


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(np.asarray(a)).to(dtype)


def _limits(a, dtype=torch.float32, same_hidden=True):
    """Per-element limits of (dx, dw1, db1, dw2), float64: 2 n 2^-24 times
    the sum of the absolute terms of each f32 sum of n terms, over the h and
    da that both sides share (same_hidden) or, for the JAX package's, plus
    the spread of its own h and da through the same sums."""
    x, g, w1, w2 = (_t(a[k], dtype) for k in ("x", "g", "w1", "w2"))
    b1, amask = _t(a["b1"]), _t(a["amask"])
    _, _, hid, da = t_ffn._hidden_and_da(x, g, w1, b1, w2, a["act"], amask)
    x, g, w1, w2, b1 = (t.double().abs() for t in (x, g, w1, w2, b1))
    hid, da = hid.double().abs(), da.double().abs()
    n, h = x.shape
    f = w1.shape[1]
    gam = lambda terms: 2 * terms * U
    lim = [gam(f) * da @ w1.T, gam(n) * x.T @ da, gam(n) * da.sum(0),
           gam(n) * hid.T @ g]
    if not same_hidden:
        m = 1.0 if amask is None else amask.double().abs()
        pre = gam(h) * (x @ w1 + b1)               # a = x w1 + b1
        gw = g @ w2.T                              # |g w2^T|'s terms
        da_err = (gam(h) * gw * 1.2 + gw * pre + U * da) * m
        h_err = (1.2 * pre + U * hid) * m
        lim[0] = lim[0] + da_err @ w1.T
        lim[1] = lim[1] + x.T @ da_err
        lim[2] = lim[2] + da_err.sum(0)
        lim[3] = lim[3] + h_err.T @ g
    return lim


def _within(got, ref, lim):
    """(|got - ref| <= lim everywhere, the largest |got - ref| / lim)."""
    err = (torch.as_tensor(np.array(got)).double()
           - torch.as_tensor(np.array(ref)).double()).abs()
    ratio = torch.where(err > 0, err / lim, 0.0).max().item()
    return bool((err <= lim).all()), ratio


def _assert_within(got, ref, lims):
    for name, o, r, lim in zip(NAMES, got, ref, lims):
        ok, ratio = _within(o, r, lim)
        assert ok, f"{name}: max |err| / limit {ratio:.3g}"


def _split(a, dtype=torch.float32):
    """The decomposition the kernels follow, through the CPU wrappers of
    the two entries (their plain versions) and the plan's fixed ranges."""
    x, g, w1, w2 = (_t(a[k], dtype) for k in ("x", "g", "w1", "w2"))
    b1 = _t(a["b1"])
    amask = _t(a["amask"])
    hid, da, colsum = t_ffn.ffn_bwd_recompute_plain(x, g, w1, b1, w2,
                                                    a["act"], amask)
    return t_ffn.ffn_bwd_products(x, g, w1, hid, da, colsum)


@pytest.fixture
def small_ranges(monkeypatch):
    """Ranges of 64 rows, so that the small inputs cut into several."""
    monkeypatch.setattr(t_ffn, "DW_ROWS_PER_SPLIT", 64)


@pytest.mark.parametrize("n", [256, 200])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("act", ACTS)
def test_split_matches_ffn_bwd_plain(act, masked, n, small_ranges):
    """n = 200 fills neither a 128-row tile nor a 64-row range."""
    a = _inputs(n, masked=masked)
    a["act"] = act
    splits, _ = t_ffn.dw_split_plan(n)
    assert splits == -(-n // 64)
    got = _split(a)
    ref = t_ffn.ffn_bwd_plain(*(_t(a[k]) for k in ("x", "g", "w1", "b1",
                                                    "w2")), act,
                              _t(a["amask"]))
    _assert_within(got, ref[:4], _limits(a))


@pytest.mark.parametrize("fault", ["dropped", "doubled"])
def test_split_limit_catches_a_range_dropped_or_doubled(fault, small_ranges):
    """dw1 and dw2 summed over the 64-row ranges with range 1 left out, or
    counted twice, fail the limits that the right sums pass."""
    a = _inputs(256)
    a["act"] = "gelu"
    x, g, w1, b1, w2 = (_t(a[k]) for k in ("x", "g", "w1", "b1", "w2"))
    hid, da, _ = t_ffn.ffn_bwd_recompute_plain(x, g, w1, b1, w2, "gelu")
    splits, rows = t_ffn.dw_split_plan(256)
    assert splits == 4
    cuts = [slice(s * rows, (s + 1) * rows) for s in range(splits)]
    ref = t_ffn.ffn_bwd_plain(x, g, w1, b1, w2, "gelu")
    lims = _limits(a)
    for i, left, right in ((1, x, da), (3, hid, g)):
        parts = [left[c].t() @ right[c] for c in cuts]
        parts = parts[:1] + parts[2:] if fault == "dropped" else parts + [
            parts[1]]
        wrong = t_ffn._ordered_sum(parts)
        assert not _within(wrong, ref[i], lims[i])[0], NAMES[i]
        assert _within(_split(a)[i], ref[i], lims[i])[0], NAMES[i]


@pytest.mark.parametrize("act", ACTS)
def test_split_matches_pallas(act, small_ranges):
    """The Pallas kernels in interpret mode (no mask: they have none)."""
    a = _inputs(256)
    a["act"] = act
    ref = fk.ffn_fused_bwd(*(jnp.asarray(a[k]) for k in ("x", "g", "w1",
                                                         "b1", "w2")),
                           act=act, block_rows=128, block_f=128,
                           interpret=True)
    got = _split(a)
    _assert_within(got, ref[:4], _limits(a, same_hidden=False))


@pytest.mark.parametrize("n", [256, 200])
@pytest.mark.parametrize("act", ACTS)
def test_split_with_mask_matches_ffn_bwd_hand(act, n, small_ranges):
    """The dropout twins' function: the TPU package's _ffn_bwd_hand given
    the same explicit mask."""
    a = _inputs(n, seed=3, masked=True)
    a["act"] = act
    ref = fk._ffn_bwd_hand(jnp.asarray(a["x"]), jnp.asarray(a["w1"]),
                           jnp.asarray(a["b1"]), jnp.asarray(a["w2"]),
                           jnp.asarray(a["g"]), act,
                           amask=jnp.asarray(a["amask"]))
    got = _split(a)
    _assert_within(got, ref[:4], _limits(a, same_hidden=False))


@pytest.mark.parametrize("masked", [False, True])
def test_split_bf16_matches_ffn_bwd_plain(masked, small_ranges):
    """bfloat16 operands: h and da rounded at the same places, so dx agrees
    bit for bit and the f32 sums within their order."""
    a = _inputs(200, seed=5, masked=masked)
    a["act"] = "gelu"
    bf = torch.bfloat16
    got = _split(a, bf)
    ref = t_ffn.ffn_bwd_plain(*(_t(a[k], bf) for k in ("x", "g", "w1")),
                              _t(a["b1"]), _t(a["w2"], bf), "gelu",
                              _t(a["amask"]))
    assert got[0].dtype == bf
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0)
    assert all(o.dtype == torch.float32 for o in got[1:])
    _assert_within(got[1:], ref[1:4], _limits(a, bf)[1:])


@pytest.mark.parametrize("masked", [False, True])
def test_split_bf16_at_t5_small_width(masked, small_ranges):
    """t5-small's FFN (relu, H = 512, F = 2048, no biases), the width K8's
    bfloat16 gate admits since it takes every multiple of 128: the same
    structure as at the flagship's width, dx bit for bit and the f32 sums
    within their order; on a tensor off the CPU the gate passes H = 512 and
    the wrapper stops only at the device check, while H = 192 (not a
    multiple of 128) is still refused by width."""
    a = _inputs(200, h=512, f=2048, seed=9, masked=masked)
    a["b1"] = np.zeros(2048, np.float32)
    a["act"] = "relu"
    bf = torch.bfloat16
    got = _split(a, bf)
    ref = t_ffn.ffn_bwd_plain(*(_t(a[k], bf) for k in ("x", "g", "w1")),
                              _t(a["b1"]), _t(a["w2"], bf), "relu",
                              _t(a["amask"]))
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0)
    _assert_within(got[1:], ref[1:4], _limits(a, bf)[1:])
    meta = lambda *s, dtype=bf: torch.empty(*s, dtype=dtype, device="meta")
    for h, match in ((512, "CUDA tensor"), (192, "supports H a multiple")):
        args = (meta(4, h), meta(4, h), meta(h, 2048),
                meta(2048, dtype=torch.float32), meta(2048, h))
        for entry in (t_ffn.ffn_bwd_dx, t_ffn.ffn_bwd_recompute):
            with pytest.raises(ValueError, match=match):
                entry(*args, "relu")


def test_recompute_column_sums_per_tile():
    """colsum row t is the sum of da over rows 128 t .. 128 t + 127 (the
    last tile short), and the tiles add up to db1."""
    a = _inputs(300, seed=7)
    x, g, w1, b1, w2 = (_t(a[k]) for k in ("x", "g", "w1", "b1", "w2"))
    hid, da, colsum = t_ffn.ffn_bwd_recompute(x, g, w1, b1, w2, "silu")
    assert colsum.shape == (3, 256)
    a["act"] = "silu"
    for t in range(3):
        tile = da[128 * t:128 * t + 128].double().abs().sum(0)
        assert _within(colsum[t], da[128 * t:128 * t + 128].sum(0),
                       2 * 128 * U * tile)[0]
    assert _within(colsum.sum(0), t_ffn.ffn_bwd_dw_plain(
        x, g, w1, b1, w2, "silu")[1], _limits(a)[2])[0]


@pytest.mark.parametrize("rows_per_split", [t_ffn.DW_ROWS_PER_SPLIT,
                                            t_ffn.DW_ROWS_PER_SPLIT_F32])
@pytest.mark.parametrize("n", [1000, 1024, 4001, 6400, 12800])
def test_split_plan_covers_every_row_once(n, rows_per_split):
    """The weight gradients' row ranges (bf16 products and the f32 kernels)
    and the recompute's 128-row tiles: every row in exactly one, none
    empty, ranges a multiple of 64 rows, at most DW_MAX_SPLITS of them."""
    splits, rows = t_ffn.dw_split_plan(n, rows_per_split)
    assert 1 <= splits <= t_ffn.DW_MAX_SPLITS
    assert rows % t_ffn.DW_SPLIT_ALIGN == 0
    count = np.zeros(n, np.int64)
    for s in range(splits):
        lo, hi = s * rows, min(n, (s + 1) * rows)
        assert lo < hi, f"range {s} is empty"
        count[lo:hi] += 1
    assert (count == 1).all()
    tiles = -(-n // t_ffn.ROW_TILE)
    count[:] = 0
    for t in range(tiles):
        count[t * t_ffn.ROW_TILE:(t + 1) * t_ffn.ROW_TILE] += 1
    assert (count == 1).all()


def test_split_plan_of_the_step():
    """The train step's row counts: 12800 rows in 4 ranges of 3200, 6400 in
    2, the decoder's 1024 in one (written without the workspace)."""
    assert t_ffn.dw_split_plan(12800) == (4, 3200)
    assert t_ffn.dw_split_plan(6400) == (2, 3200)
    assert t_ffn.dw_split_plan(1024) == (1, 1024)
    assert t_ffn.dw_split_plan(4001) == (2, 2048)
