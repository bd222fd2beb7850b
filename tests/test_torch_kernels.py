"""The port's kernel plain versions (speechmix_tpu_torch.ops.kernels) against
the JAX package's Pallas kernels run in interpret mode on the CPU.

Same inputs (numpy, seeded) on both sides, float32.  The plain versions are
what a kernel wrapper runs for CPU tensors and what the CUDA kernels are
held against on the card (chip_smoke.py).  Tolerance: 1e-5 abs / 1e-5 rel.
The JAX kernels' exact-erf GELU uses XLA's rational erf approximation
(conv_extractor._erf_f32), which agrees with torch.erf to ~1e-7, inside it.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechmix_tpu.ops.pallas import ffn_kernel as fk
from speechmix_tpu.ops.pallas import flash_attention_kernel as fak
from speechmix_tpu_torch.ops.kernels import attention as t_attn
from speechmix_tpu_torch.ops.kernels import ffn as t_ffn
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _ffn_inputs(n=256, h=128, f=256, seed=0):
    rng = np.random.RandomState(seed)
    mk = lambda *s, sc=1.0: (rng.randn(*s) * sc).astype(np.float32)
    return dict(x=mk(n, h, sc=0.5), w1=mk(h, f, sc=0.1), b1=mk(f, sc=0.1),
                w2=mk(f, h, sc=0.1), b2=mk(h, sc=0.1), res=mk(n, h),
                g=1.0 + mk(h, sc=0.1), beta=mk(h, sc=0.1))


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("act", ["gelu", "gelu_new", "relu", "silu"])
def test_ffn_res_ln_plain_matches_pallas(act):
    a = _ffn_inputs()
    ref = fk.ffn_fused_res_ln(
        *(jnp.asarray(a[k]) for k in ("x", "w1", "b1", "w2", "b2", "res",
                                      "g", "beta")),
        act=act, eps=1e-5, block_rows=256, block_f=128, interpret=True)
    out = t_ffn.ffn_res_ln(*(_t(a[k]) for k in ("x", "w1", "b1", "w2", "b2",
                                                 "res", "g", "beta")),
                           act=act, eps=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_dense_res_ln_plain_matches_pallas():
    a = _ffn_inputs()
    w = a["w1"][:, :128]
    ref = fk.dense_res_ln(jnp.asarray(a["x"]), jnp.asarray(w),
                          jnp.asarray(a["b2"]), jnp.asarray(a["res"]),
                          jnp.asarray(a["g"]), jnp.asarray(a["beta"]),
                          eps=1e-5, block_rows=256, interpret=True)
    out = t_ffn.dense_res_ln(_t(a["x"]), _t(w), _t(a["b2"]), _t(a["res"]),
                             _t(a["g"]), _t(a["beta"]), eps=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_fwd_plain_matches_pallas(causal, monkeypatch):
    orig = fak.pl.pallas_call
    monkeypatch.setattr(fak.pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    b, t, h, d = 2, 40, 2, 64   # T = 40 is ragged against 8-row tiles
    rng = np.random.RandomState(1)
    q, k, v = (rng.randn(b, t, h * d).astype(np.float32) for _ in range(3))
    mask = np.arange(t)[None, :] < np.array([[t], [t - 9]])
    scale = 1.0 / math.sqrt(d)
    ref = fak.flash_attention_fused_layout(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        heads=h, scale=scale, causal=causal)
    assert ref is not None
    out = t_attn.attention_fwd(_t(q), _t(k), _t(v), _t(mask), h, scale,
                               causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_attention_fwd_plain_fully_masked_row_is_finite():
    """A row whose keys are all masked averages the values, as the TPU
    kernel's finite NEG_INF does, and never gives NaN."""
    rng = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rng.randn(1, 8, 64).astype(np.float32))
               for _ in range(3))
    mask = torch.zeros(1, 8, dtype=torch.bool)
    out = t_attn.attention_fwd(q, k, v, mask, 1, 0.125)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out[0].numpy(),
                               v[0].mean(0, keepdim=True).expand(8, 64)
                               .numpy(), rtol=1e-5, atol=1e-5)
