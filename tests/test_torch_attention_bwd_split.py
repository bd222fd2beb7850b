"""The structure of K7 / K15's bf16 kernels, attention_bwd_tiled_plain,
against the JAX package on the CPU.

attention_bwd_tiled_plain follows the kernels tile for tile: delta from the
forward output, p from the forward's log-sum-exp, a dk / dv pass over
64-key tiles that sums over the 64-query tiles in order, a dq pass over
64-query tiles that sums over the 64-key tiles, last tiles cut at T (100 and
200 are not multiples of 64 or of the 128-row blocks), rows whose keys are
all masked (key length 0) at p = 1 / Tk, causal or not.  It is held against
the JAX package's reference backward (_attn_ref_bwd), jax.grad of
flash_attention_trainable, and with JAX's mask fed to both, the dropout
reference (_dropout_ref_bwd); and against the port's untiled plain version.

Tolerances.  float32: 1e-5, absolute and relative (measured within 1e-6 of
the largest value: summation order and exp(s - lse) against the softmax).
bfloat16: 2^-5 of the largest reference magnitude.  The tiled version takes
delta = g . out from the forward output rounded to bf16 (2^-9 relative per
element) where the references sum p dp in f32; that error enters every ds
of a row with one sign, so it adds up along the row (measured up to 0.82%
of the largest dq here), on top of one bf16 step (2^-8) wherever p or ds
round from f32 values that differ in their last bits.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from speechmix_tpu.ops.pallas import flash_attention_kernel as fak
from speechmix_tpu_torch.ops.kernels import attention as t_attn
from speechmix_tpu_torch.ops.kernels import dropout as t_drop
from torch_threads import one_torch_thread  # noqa: F401

HEADS, D, SCALE = 2, 64, 0.125
T_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
J_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
REL_BF16 = 2.0 ** -5


def _inputs(tq, tk=None, seed=0):
    """q, g (3, tq, H, D); k, v (3, tk, H, D); key lengths tk, tk - 37 and
    0 (a batch row with no valid key)."""
    tk = tq if tk is None else tk
    rng = np.random.RandomState(seed)
    q, g = (rng.randn(3, tq, HEADS, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(3, tk, HEADS, D).astype(np.float32) for _ in range(2))
    lens = np.array([tk, max(tk - 37, 1), 0])
    mask = np.arange(tk)[None, :] < lens[:, None]
    return q, k, v, g, mask


def _slab(a, dtype=torch.float32):
    b, t, h, d = a.shape
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).reshape(
        b, t, h * d)


def _tiled(q, k, v, g, mask, causal, dtype=torch.float32, dmask=None):
    """The forward's output and lse (plain version), then the tiled
    backward, all in `dtype`."""
    qs, ks, vs, gs = (_slab(a, dtype) for a in (q, k, v, g))
    tm = torch.from_numpy(mask)
    out, lse = t_attn.attention_fwd_plain(qs, ks, vs, tm, HEADS, SCALE, causal,
                                          return_lse=True, dmask=dmask)
    return t_attn.attention_bwd_tiled_plain(qs, ks, vs, tm, out, lse, gs,
                                            HEADS, SCALE, causal, dmask)


def _check(got, refs, dtype, what):
    for name, o, r in zip(("dq", "dk", "dv"), got, refs):
        r = np.asarray(jnp.asarray(r).astype(jnp.float32)).reshape(o.shape)
        assert o.dtype == T_DTYPE[dtype] and torch.isfinite(o).all()
        o = o.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{what} {name}")
        else:
            err, limit = np.abs(o - r).max(), REL_BF16 * np.abs(r).max()
            assert err <= limit, f"{what} {name}: {err} > {limit}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [100, 200])
def test_tiled_matches_reference_backward(t, causal, dtype):
    q, k, v, g, mask = _inputs(t)
    jd = J_DTYPE[dtype]
    refs = fak._attn_ref_bwd(*(jnp.asarray(a, jd) for a in (q, k, v)),
                             jnp.asarray(mask), SCALE, causal,
                             jnp.asarray(g, jd))
    _check(_tiled(q, k, v, g, mask, causal, T_DTYPE[dtype]), refs, dtype,
           f"T={t} causal={causal}")


@pytest.mark.parametrize("causal", [False, True])
def test_tiled_matches_jax_grad(causal):
    """jax.grad of the JAX package's differentiable attention, float32."""
    q, k, v, g, mask = _inputs(200, seed=3)

    def loss(q_, k_, v_):
        out = fak.flash_attention_trainable(q_, k_, v_, jnp.asarray(mask),
                                            SCALE, causal)
        return jnp.sum(out * jnp.asarray(g))
    refs = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                               for a in (q, k, v)))
    _check(_tiled(q, k, v, g, mask, causal), refs, "float32",
           f"jax.grad causal={causal}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_tiled_matches_dropout_reference(causal, dtype):
    """K15's decomposition with JAX's mask: p m in dv, dp m in ds."""
    t, seed, rate = 100, 5, 0.2
    q, k, v, g, mask = _inputs(t, seed=2)
    jd = J_DTYPE[dtype]
    refs = fak._dropout_ref_bwd(*(jnp.asarray(a, jd) for a in (q, k, v)),
                                jnp.asarray(mask), seed, SCALE, causal, rate,
                                jnp.asarray(g, jd))
    dmask = torch.from_numpy(np.array(
        fak._xla_dropout_mask(seed, (3, HEADS, t, t), rate), np.float32))
    _check(_tiled(q, k, v, g, mask, causal, T_DTYPE[dtype], dmask), refs,
           dtype, f"dropout causal={causal}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk", [(100, 100), (200, 130), (130, 200),
                                   (64, 64), (1, 70)])
def test_tiled_matches_untiled_plain(tq, tk, causal):
    """Query and key lengths apart, one tile exactly, a single query: the
    tiles' sums against the untiled plain version (float32)."""
    q, k, v, g, mask = _inputs(tq, tk, seed=7)
    refs = t_attn.attention_bwd_plain(*(_slab(a) for a in (q, k, v)),
                                      torch.from_numpy(mask), _slab(g), HEADS,
                                      SCALE, causal)
    _check(_tiled(q, k, v, g, mask, causal), [r.numpy() for r in refs],
           "float32", f"Tq={tq} Tk={tk} causal={causal}")


@pytest.mark.parametrize("causal", [False, True])
def test_tiled_with_the_ports_mask_matches_attention_dropout_bwd(causal):
    """With the port's own mask (the key's Philox words) the tiled version
    gives what attention_dropout_bwd gives on the CPU."""
    t, rate = 130, 0.1
    key = t_drop.DropoutKey.from_seed(11)
    q, k, v, g, mask = _inputs(t, seed=9)
    dmask = t_drop.attention_mask_plain(key, 3, HEADS, t, t, rate)
    tm = torch.from_numpy(mask)
    qs, ks, vs, gs = (_slab(a) for a in (q, k, v, g))
    out, lse = t_attn.attention_dropout_fwd(qs, ks, vs, tm, HEADS, SCALE,
                                            causal, key, rate,
                                            return_lse=True)
    refs = t_attn.attention_dropout_bwd(qs, ks, vs, tm, out, lse, gs, HEADS,
                                        SCALE, causal, key, rate)
    got = t_attn.attention_bwd_tiled_plain(qs, ks, vs, tm, out, lse, gs,
                                           HEADS, SCALE, causal, dmask)
    _check(got, [r.numpy() for r in refs], "float32",
           f"port mask causal={causal}")


def test_masked_row_is_uniform():
    """A batch row with no valid key attends every key at 1 / Tk: its dv is
    the mean of its queries' g, whatever the scores (float32)."""
    q, k, v, g, mask = _inputs(100, seed=4)
    _, _, dv = _tiled(q, k, v, g, mask, False)
    want = _slab(g)[2].sum(0, keepdim=True) / 100
    torch.testing.assert_close(dv[2], want.expand(100, -1), rtol=1e-5,
                               atol=1e-5)
