"""K2 / K11 in bfloat16 as the card reduces their LayerNorm rows: the tiled
plain version ``dense_res_ln_tiled_plain`` (z = (x @ w + b) * m + res in f32,
cut into 128-column slices, one per block of the thread-block cluster; the
slices' row sums added in slice order give the mean, then the centred
squares the variance) against the untiled plain versions, the JAX package's
Pallas ``dense_res_ln`` in interpret mode and its XLA twins
``_xla_dense_res_ln`` / ``_xla_dense_drop_res_ln`` (the dropout twin given
JAX's mask); and the two-launch form the wrapper takes where the cluster
would pass eight blocks (the down pass to the f32 sum, then the LayerNorm
rows) against the whole functions' plain versions, bit for bit.

Tolerances, each with its reason:
- float32 against float32: 1e-5 abs / 1e-5 rel, the order of summation of
  the product and of the row statistics (as tests/test_torch_kernels.py);
  with the output mask both terms times 1 / (1 - r), the scale of the kept
  values.
- bfloat16 output against a bfloat16 output of the same f32 function: one
  bf16 ulp (2^-7 relative) plus 1e-5, the f32 values before the rounding
  differing in summation order only.
- bfloat16 against the XLA twins, which round x @ w + b to bf16 (half an
  ulp, 2^-8 relative) before the residual: that rounding scaled by the
  LayerNorm's 1 / std and |g|, twice (the value and the mean it shifts),
  2^-7 * max|y| * |g| / std per row, on top of the bound above.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechmix_tpu.ops.pallas import ffn_kernel as fk
from speechmix_tpu.ops.pallas.ffn_kernel import _xla_dropout_mask
from speechmix_tpu_torch.ops.kernels import dropout as t_drop
from speechmix_tpu_torch.ops.kernels import ffn as t_ffn
from torch_threads import one_torch_thread  # noqa: F401

EPS = 1e-5
RATE = 0.1
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ULP = 2.0 ** -7


def _inputs(n, din, h, seed=0):
    rng = np.random.RandomState(seed)
    mk = lambda *s, sc=1.0: (rng.randn(*s) * sc).astype(np.float32)
    return dict(x=mk(n, din, sc=0.5), w=mk(din, h, sc=0.1), b=mk(h, sc=0.1),
                res=mk(n, h), g=1.0 + mk(h, sc=0.1), beta=mk(h, sc=0.1))


def _port(a, dtype):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    for k in ("x", "w", "res"):
        t[k] = t[k].to(dtype)
    return [t[k] for k in ("x", "w", "b", "res", "g", "beta")]


def _jax(a, dtype):
    j = {k: jnp.asarray(v) for k, v in a.items()}
    for k in ("x", "w", "res"):
        j[k] = j[k].astype(dtype)
    return [j[k] for k in ("x", "w", "b", "res", "g", "beta")]


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, dtype=np.float32)


def _omask(n, h, seed=3):
    rng = np.random.RandomState(seed)
    return ((rng.rand(n, h) >= RATE) / (1.0 - RATE)).astype(np.float32)


def _close_bf16(out, ref, extra=0.0):
    out, ref = _np(out), _np(ref)
    limit = 1e-5 + BF16_ULP * np.abs(ref) + extra
    assert np.all(np.abs(out - ref) <= limit), np.max(np.abs(out - ref) -
                                                      limit)


def _twin_rounding(a, omask=None):
    """The XLA twins' extra error in bf16 (module docstring), per element."""
    y = a["x"].astype(np.float64) @ a["w"] + a["b"]
    if omask is not None:
        y = y * omask
    z = y + a["res"]
    std = np.sqrt(z.var(-1, keepdims=True) + EPS)
    return BF16_ULP * np.abs(y).max(-1, keepdims=True) * np.abs(a["g"]) / std


# the widths of the cluster (one to eight 128-column blocks), Din != H both
# ways, and row counts off the kernel's 128-row tile
SHAPES = [(200, 128, 128), (77, 256, 256), (130, 512, 512), (64, 768, 768),
          (33, 1024, 1024), (150, 1024, 768), (100, 256, 512), (1, 384, 384)]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "omask"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "N%d-Din%d-H%d" % s)
def test_tiled_plain_matches_untiled_plain(shape, masked, dtype):
    a = _inputs(*shape)
    ops = _port(a, dtype)
    omask = torch.from_numpy(_omask(shape[0], shape[2])) if masked else None
    out = t_ffn.dense_res_ln_tiled_plain(*ops, omask, EPS)
    ref = t_ffn.dense_dropout_res_ln_plain(*ops, omask, EPS)
    assert out.dtype == dtype and out.shape == (shape[0], shape[2])
    if dtype == torch.float32:
        scale = 1.0 / (1.0 - RATE) if masked else 1.0
        np.testing.assert_allclose(out, ref, rtol=1e-5 * scale,
                                   atol=1e-5 * scale)
    else:
        _close_bf16(out, ref)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(256, 128, 128), (256, 768, 768),
                                   (128, 1024, 768), (128, 256, 512)],
                         ids=lambda s: "N%d-Din%d-H%d" % s)
def test_tiled_plain_matches_pallas_interpret(shape, dtype):
    """The Pallas kernel takes N a multiple of its 128-row blocks."""
    a = _inputs(*shape, seed=1)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = fk.dense_res_ln(*_jax(a, jdt), eps=EPS, block_rows=128,
                          interpret=True)
    out = t_ffn.dense_res_ln_tiled_plain(*_port(a, dtype), None, EPS)
    if dtype == torch.float32:
        np.testing.assert_allclose(out, _np(ref), **F32_TOL)
    else:
        _close_bf16(out, ref)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(77, 256, 256), (200, 768, 768),
                                   (150, 1024, 768)],
                         ids=lambda s: "N%d-Din%d-H%d" % s)
def test_tiled_plain_matches_xla_twin(shape, dtype):
    a = _inputs(*shape, seed=2)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = fk._xla_dense_res_ln(*_jax(a, jdt), EPS)
    out = t_ffn.dense_res_ln_tiled_plain(*_port(a, dtype), None, EPS)
    if dtype == torch.float32:
        np.testing.assert_allclose(out, _np(ref), **F32_TOL)
    else:
        _close_bf16(out, ref, _twin_rounding(a))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(77, 256, 256), (200, 768, 768),
                                   (150, 1024, 768)],
                         ids=lambda s: "N%d-Din%d-H%d" % s)
def test_tiled_plain_matches_xla_dropout_twin(shape, dtype):
    """JAX's mask handed to the port's explicit-mask version."""
    n, _, h = shape
    a = _inputs(*shape, seed=4)
    omask = np.array(_xla_dropout_mask(17, (n, h), RATE), np.float32)
    assert 0.8 < (omask > 0).mean() < 1.0
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = fk._xla_dense_drop_res_ln(*_jax(a, jdt), jnp.asarray(omask), EPS)
    out = t_ffn.dense_res_ln_tiled_plain(*_port(a, dtype),
                                         torch.from_numpy(omask), EPS)
    if dtype == torch.float32:
        scale = 1.0 / (1.0 - RATE)
        np.testing.assert_allclose(out, _np(ref), rtol=1e-5 * scale,
                                   atol=1e-5 * scale)
    else:
        _close_bf16(out, ref, _twin_rounding(a, omask))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "omask"])
@pytest.mark.parametrize("shape", [(77, 256, 1536), (200, 768, 768),
                                   (150, 1024, 768)],
                         ids=lambda s: "N%d-Din%d-H%d" % s)
def test_two_pass_form_is_the_whole_function(shape, masked, dtype):
    """The down pass to the f32 sum, then the LayerNorm rows: the same f32
    operations in the same order as the whole function's plain version."""
    a = _inputs(*shape, seed=5)
    x, w, b, res, g, beta = _port(a, dtype)
    omask = torch.from_numpy(_omask(shape[0], shape[2])) if masked else None
    z = t_ffn.ffn_down_plain(x, w, b, res, omask)
    assert z.dtype == torch.float32
    out = t_ffn.res_ln_rows_plain(z, g, beta, EPS, dtype)
    if masked:
        ref = t_ffn.dense_dropout_res_ln_plain(x, w, b, res, g, beta, omask,
                                               EPS)
    else:
        ref = t_ffn.dense_res_ln_plain(x, w, b, res, g, beta, EPS)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_cpu_wrappers_draw_the_tiled_functions(dtype):
    """The CPU wrappers (plain versions, the dropout one drawing the port's
    mask of the key) agree with the tiled version given that mask."""
    n, din, h = 150, 1024, 768
    a = _inputs(n, din, h, seed=6)
    ops = _port(a, dtype)
    key = t_drop.DropoutKey.from_seed(9)
    omask = t_drop.dropout_mask_plain(key, t_drop.STREAM_OUT, n, h, RATE,
                                      torch.device("cpu"))
    for out, ref in (
            (t_ffn.dense_res_ln(*ops, EPS),
             t_ffn.dense_res_ln_tiled_plain(*ops, None, EPS)),
            (t_ffn.dense_dropout_res_ln(*ops, key, RATE, EPS),
             t_ffn.dense_res_ln_tiled_plain(*ops, omask, EPS))):
        if dtype == torch.float32:
            scale = 1.0 / (1.0 - RATE)
            np.testing.assert_allclose(out, ref, rtol=1e-5 * scale,
                                       atol=1e-5 * scale)
        else:
            _close_bf16(out, ref)


def test_backward_products_off_the_card_are_upcast():
    """Off the card the dense backward's two products (x w and x^T g) are
    the products of the upcast operands, f32 results."""
    rng = np.random.RandomState(7)
    a = torch.from_numpy(rng.randn(50, 256).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.randn(256, 128).astype(np.float32)).bfloat16()
    out = t_ffn._mm_f32(a, b)
    assert out.dtype == torch.float32
    assert torch.equal(out, a.float() @ b.float())
    assert torch.equal(t_ffn._mm_f32(a.t(), a), a.float().t() @ a.float())


@pytest.mark.parametrize("h,fused", [
    (128, True), (384, True), (768, True), (1024, True), (1152, False),
    (1280, True), (1536, True), (2048, True), (2304, False)])
def test_fused_widths(h, fused):
    """One kernel while the cluster holds at most eight blocks, 256 columns
    wide where 256 divides H and 128 wide otherwise; wider rows take the two
    passes, which take every multiple of 128."""
    assert t_ffn.dense_fused(h) is fused
