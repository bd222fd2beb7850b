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

Tolerances.  float32: 1e-5 absolute and relative (the decomposition sums
the rows in other groupings: per tile, per range).  bfloat16: the
decomposition against ``ffn_bwd_plain``, which rounds the same f32 values at
the same places, 1e-5 on dx (equal roundings) and on the f32 weight
gradients.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechmix_tpu.ops.pallas import ffn_kernel as fk
from speechmix_tpu_torch.ops.kernels import ffn as t_ffn

ACTS = ["gelu", "gelu_new", "relu", "silu"]
TOL = dict(rtol=1e-5, atol=1e-5)
RATE = 0.1


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
    for name, o, r in zip(("dx", "dw1", "db1", "dw2"), got, ref):
        torch.testing.assert_close(o, r, **TOL, msg=name)


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
    for name, o, r in zip(("dx", "dw1", "db1", "dw2"), got, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), err_msg=name,
                                   **TOL)


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
    for name, o, r in zip(("dx", "dw1", "db1", "dw2"), got, ref[:4]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), err_msg=name,
                                   **TOL)


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
    for name, o, r in zip(("dw1", "db1", "dw2"), got[1:], ref[1:4]):
        assert o.dtype == torch.float32
        torch.testing.assert_close(o, r, **TOL, msg=name)


def test_recompute_column_sums_per_tile():
    """colsum row t is the sum of da over rows 128 t .. 128 t + 127 (the
    last tile short), and the tiles add up to db1."""
    a = _inputs(300, seed=7)
    x, g, w1, b1, w2 = (_t(a[k]) for k in ("x", "g", "w1", "b1", "w2"))
    hid, da, colsum = t_ffn.ffn_bwd_recompute(x, g, w1, b1, w2, "silu")
    assert colsum.shape == (3, 256)
    for t in range(3):
        torch.testing.assert_close(colsum[t], da[128 * t:128 * t + 128].sum(0),
                                   **TOL)
    torch.testing.assert_close(colsum.sum(0), t_ffn.ffn_bwd_dw_plain(
        x, g, w1, b1, w2, "silu")[1], **TOL)


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
