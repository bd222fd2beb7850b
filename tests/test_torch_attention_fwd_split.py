"""The structure of K1 / K14's bf16 forward kernel, attention_fwd_tiled_plain,
against the JAX package on the CPU.

attention_fwd_tiled_plain follows the kernel tile for tile: blocks of 64
queries, an online softmax over 64-key tiles in log2 units (the rescale of
the output and of the f32 denominator by 2^(m_old - m_new)), P times the
dropout mask rounded to the input dtype before P . v, excluded logits at
-1e30, keys past Tk given no weight, lse = m ln 2 + log l, and under
`causal` the key tiles up to a block's last query, all of them where a row
of the block has no valid key at or before its query.  Lengths 100, 200 and
800 are not multiples of the tiles; key lengths t, t - 37 and 0 (a batch row
with no valid key); a mask whose first valid key comes after the first
queries gives causal rows without an allowed key inside blocks that have
other rows.  It is held against the JAX package's Pallas kernel
flash_attention_fused_layout in interpret mode, its reference forward
(_attn_ref_fwd), with JAX's mask fed to both the dropout reference
(_dropout_ref_fwd), and the port's untiled plain version.

Tolerances.  float32: 1e-5, absolute and relative (exp2 against the
softmax's exp, and the order of the sums).  bfloat16: 2^-6 of the largest
reference magnitude.  The kernel rounds each probability to bf16 before the
division by the row's sum (relative to the running max), the references
after it; a rounded probability is off by at most 2^-9 of itself, and the
two roundings of the output, one bf16 step (2^-8) apart at most, add to
that.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechmix_tpu.ops.pallas import flash_attention_kernel as fak
from speechmix_tpu_torch.ops.kernels import attention as t_attn
from speechmix_tpu_torch.ops.kernels import dropout as t_drop
from torch_threads import one_torch_thread  # noqa: F401

HEADS, D, SCALE = 2, 64, 0.125
T_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
J_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
REL_BF16 = 2.0 ** -6


def _inputs(tq, tk=None, seed=0, first_key=None):
    """q (3, tq, H, D); k, v (3, tk, H, D); key lengths tk, tk - 37 and 0
    (a batch row with no valid key).  first_key: the middle row's keys
    before it are masked too."""
    tk = tq if tk is None else tk
    rng = np.random.RandomState(seed)
    q = rng.randn(3, tq, HEADS, D).astype(np.float32)
    k, v = (rng.randn(3, tk, HEADS, D).astype(np.float32) for _ in range(2))
    lens = np.array([tk, max(tk - 37, 1), 0])
    mask = np.arange(tk)[None, :] < lens[:, None]
    if first_key is not None:
        mask[1, :first_key] = False
    return q, k, v, mask


def _slab(a, dtype=torch.float32):
    b, t, h, d = a.shape
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).reshape(
        b, t, h * d)


def _tiled(q, k, v, mask, causal, dtype=torch.float32, dmask=None,
           return_lse=False):
    return t_attn.attention_fwd_tiled_plain(
        *(_slab(a, dtype) for a in (q, k, v)), torch.from_numpy(mask), HEADS,
        SCALE, causal, return_lse, dmask)


def _check(got, ref, dtype, what):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32)).reshape(got.shape)
    assert got.dtype == T_DTYPE[dtype] and torch.isfinite(got).all()
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5,
                                   err_msg=what)
    else:
        err, limit = np.abs(got - ref).max(), REL_BF16 * np.abs(ref).max()
        assert err <= limit, f"{what}: {err} > {limit}"


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [200, 600])
def test_tiled_matches_fused_layout_kernel(t, causal, monkeypatch):
    """The Pallas kernel K1 replaces, in interpret mode (float32).  That
    kernel pads T to a multiple of 8 with masked zero rows, so its row
    without a valid key averages the padding too (at T = 100 it divides by
    104): the lengths here are multiples of 8, not of the tiles."""
    monkeypatch.setattr(fak.pl, "pallas_call",
                        functools.partial(fak.pl.pallas_call, interpret=True))
    q, k, v, mask = _inputs(t, seed=1)
    ref = fak.flash_attention_fused_layout(
        *(jnp.asarray(_slab(a).numpy()) for a in (q, k, v)),
        jnp.asarray(mask), heads=HEADS, scale=SCALE, causal=causal)
    assert ref is not None
    _check(_tiled(q, k, v, mask, causal), ref, "float32",
           f"fused layout T={t} causal={causal}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [100, 200, 800])
def test_tiled_matches_reference_forward(t, causal, dtype):
    q, k, v, mask = _inputs(t)
    jd = J_DTYPE[dtype]
    ref = fak._attn_ref_fwd(*(jnp.asarray(a, jd) for a in (q, k, v)),
                            jnp.asarray(mask), SCALE, causal)
    _check(_tiled(q, k, v, mask, causal, T_DTYPE[dtype]), ref, dtype,
           f"T={t} causal={causal}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_tiled_matches_dropout_reference(causal, dtype):
    """K14's structure with JAX's mask: P times the mask before P . v, the
    denominator undropped."""
    t, seed, rate = 200, 5, 0.2
    q, k, v, mask = _inputs(t, seed=2)
    jd = J_DTYPE[dtype]
    ref = fak._dropout_ref_fwd(*(jnp.asarray(a, jd) for a in (q, k, v)),
                               jnp.asarray(mask), seed, SCALE, causal, rate)
    dmask = torch.from_numpy(np.array(
        fak._xla_dropout_mask(seed, (3, HEADS, t, t), rate), np.float32))
    _check(_tiled(q, k, v, mask, causal, T_DTYPE[dtype], dmask), ref, dtype,
           f"dropout causal={causal}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk", [(100, 100), (200, 130), (130, 200),
                                   (64, 64), (1, 70), (800, 800)])
def test_tiled_matches_untiled_plain(tq, tk, causal):
    """Query and key lengths apart, one tile exactly, a single query: the
    tiles' online softmax and its lse against the untiled plain version
    (float32)."""
    q, k, v, mask = _inputs(tq, tk, seed=7)
    args = (*(_slab(a) for a in (q, k, v)), torch.from_numpy(mask), HEADS,
            SCALE, causal)
    ref, ref_lse = t_attn.attention_fwd_plain(*args, return_lse=True)
    out, lse = t_attn.attention_fwd_tiled_plain(*args, return_lse=True)
    what = f"Tq={tq} Tk={tk} causal={causal}"
    _check(out, ref.numpy(), "float32", what)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), rtol=1e-5,
                               atol=1e-5, err_msg=f"lse {what}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_rows_without_an_allowed_key(dtype):
    """Causal, the middle batch row's keys valid from 150 on: its queries
    below 150 (in the blocks at 0, 64 and 128, the last beside rows that
    have a key) average all Tk values, as the references do; so does the
    key-length-0 row everywhere."""
    t, first = 300, 150
    q, k, v, mask = _inputs(t, seed=3, first_key=first)
    jd = J_DTYPE[dtype]
    ref = fak._attn_ref_fwd(*(jnp.asarray(a, jd) for a in (q, k, v)),
                            jnp.asarray(mask), SCALE, True)
    out = _tiled(q, k, v, mask, True, T_DTYPE[dtype])
    _check(out, ref, dtype, "causal, late first key")
    if dtype == "float32":
        mean_v = _slab(v).mean(1)
        torch.testing.assert_close(out[1, :first],
                                   mean_v[1].expand(first, -1), rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(out[2], mean_v[2].expand(t, -1),
                                   rtol=1e-5, atol=1e-5)
        plain = t_attn.attention_fwd_plain(
            *(_slab(a) for a in (q, k, v)), torch.from_numpy(mask), HEADS,
            SCALE, True)
        _check(out, plain.numpy(), "float32", "causal vs untiled plain")


def test_tiled_with_the_ports_mask_matches_attention_dropout_fwd():
    """With the port's own mask (the key's Philox words) the tiled version
    gives what attention_dropout_fwd gives on the CPU, lse included."""
    t, rate = 130, 0.1
    key = t_drop.DropoutKey.from_seed(11)
    q, k, v, mask = _inputs(t, seed=9)
    dmask = t_drop.attention_mask_plain(key, 3, HEADS, t, t, rate)
    args = (*(_slab(a) for a in (q, k, v)), torch.from_numpy(mask), HEADS,
            SCALE, False)
    ref, ref_lse = t_attn.attention_dropout_fwd(*args, key, rate,
                                                return_lse=True)
    out, lse = t_attn.attention_fwd_tiled_plain(*args, True, dmask)
    _check(out, ref.numpy(), "float32", "port mask")
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), rtol=1e-5,
                               atol=1e-5)
