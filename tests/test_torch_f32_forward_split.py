"""The f32 forward of K3 / K9 / K12 / K13 and K2 / K11 on the CPU: the f32
passes of csrc/ffn_fwd.cu emulated as the card takes them, against the JAX
package's f32 functions.

On the card the float32 forward is the bf16 forward's passes in their f32
entries: the up pass h = act(x w1 + b1) * m_a, kept in f32 and unrounded
(the TPU kernel's h.astype(x.dtype) is a no-op in f32); the down pass
(h w2 + b2) to the output, or z = (h w2 + b2) * m_o + res in f32; the row
pass LayerNorm(z) * g + beta, a warp per row taking the mean and then the
variance of the centred values.  K2 / K11 are the down pass on x and w,
then the row pass.  Every product is ffn_pass_kernel<float>'s: 128-row
tiles, 32-deep stages, each stage's three tf32 products (lo hi, hi lo,
hi hi, per slice of 8) into a partial that the stage starts afresh, added
to the f32 accumulator (`split_product` of test_torch_f32_split.py).  The
wrapper pads H, F and Din to multiples of 4 with zero columns (and the
TMA loads zeros past a matrix), so at an odd width the padded columns of
h and z are zeros and the row pass keeps them out of the variance.

The emulation is held against the Pallas ffn_fused, ffn_fused_res_ln and
dense_res_ln in interpret mode (all four activations), against the XLA
twins _xla_ffn_drop, _xla_ffn_drop_res_ln and _xla_dense_drop_res_ln fed
the same explicit masks, and at odd widths against the twins without a
mask, at chip_smoke.py's f32 limits: |k - p| <= 1e-4 + 1e-4 |p|, over
(1 - r) with a mask.  The same inputs through one-pass tf32 products land
further from the reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from speechmix_tpu.ops.pallas import ffn_kernel as fk
from test_torch_f32_split import TOL, _t, _worst, split_product
from speechmix_tpu_torch.ops.kernels import ffn as t_ffn
from torch_threads import one_torch_thread  # noqa: F401

ACTS = ["gelu", "gelu_new", "relu", "silu"]
RATE = 0.1
ROWS = 128          # rows of a block's tile
WARP = 32           # lanes of the row pass's warp
EPS = 1e-5


def _up4(n):
    return -(-n // 4) * 4


def _pad(t, cols, rows=None):
    """The wrapper's zero padding: columns up to `cols`, rows up to
    `rows`."""
    pc = cols - t.shape[-1]
    pr = 0 if rows is None else rows - t.shape[0]
    return F.pad(t, (0, pc) if t.dim() == 1 else (0, pc, 0, pr))


def pass_split(a, b, bias, act=None, mask=None, res=None, passes=3):
    """One f32 pass: (a @ b + bias), act for the up pass, times the mask,
    plus res for the down pass to z, in 128-row tiles (each element's sum
    is its own stages', whatever its tile)."""
    outs = []
    for r0 in range(0, a.shape[0], ROWS):
        rows = slice(r0, r0 + ROWS)
        v = split_product(a[rows], b, passes) + bias
        if act is not None:
            v = t_ffn.act_f32(act, v)
        if mask is not None:
            v = v * mask[rows]
        if res is not None:
            v = v + res[rows]
        outs.append(v)
    return torch.cat(outs)


def _warp_sum(t):
    """The row pass's sum of each row of t (n, ld), ld a multiple of 4:
    lane l adds the quads l, l + 32, ... in order, each quad as (x + y) +
    (z + w), then the butterfly over xor 16, 8, 4, 2, 1."""
    n, ld = t.shape
    q = t.view(n, ld // 4, 4)
    quads = (q[..., 0] + q[..., 1]) + (q[..., 2] + q[..., 3])
    lanes = torch.zeros(n, WARP)
    for c in range(quads.shape[1]):
        lanes[:, c % WARP] = lanes[:, c % WARP] + quads[:, c]
    idx = torch.arange(WARP)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, idx ^ off]
    return lanes[:, :1]


def rows_split(z, g, beta, h):
    """The f32 row pass on z (n, ld), its first h columns the row's, the
    rest zeros: the mean over the row, then the variance of the centred
    values of the h columns."""
    inv_h = torch.tensor(1.0 / h, dtype=torch.float32)
    mean = _warp_sum(z) * inv_h
    d = z - mean
    d = torch.where(torch.arange(z.shape[1]) < h, d, torch.zeros(()))
    inv = torch.rsqrt(_warp_sum(d * d) * inv_h + EPS)
    return ((z - mean) * inv * g + beta)[:, :h]


def ffn_split(a, act, res_ln=False, passes=3):
    """K9 / K13 (res_ln False) or K3 / K12 as the f32 passes take them, the
    widths padded as the wrapper pads them."""
    x, w1, b1, w2, b2 = (_t(a[k]) for k in ("x", "w1", "b1", "w2", "b2"))
    n, h = x.shape
    f = w1.shape[1]
    hp, fp = _up4(h), _up4(f)
    amask, omask = _t(a["amask"]), _t(a["omask"])
    hid = pass_split(_pad(x, hp), _pad(w1, fp, hp), _pad(b1, fp), act,
                     None if amask is None else _pad(amask, fp),
                     passes=passes)
    w2p, b2p = _pad(w2, hp, fp), _pad(b2, hp)
    if not res_ln:
        return pass_split(hid, w2p, b2p, passes=passes)[:, :h]
    z = pass_split(hid, w2p, b2p, mask=None if omask is None else
                   _pad(omask, hp), res=_pad(_t(a["res"]), hp),
                   passes=passes)
    return rows_split(z, _pad(_t(a["g"]), hp), _pad(_t(a["beta"]), hp), h)


def dense_split(a, passes=3):
    """K2 / K11: the f32 down pass on x and w to z, then the row pass."""
    x, w, res = _t(a["x"]), _t(a["w"]), _t(a["res"])
    din, h = w.shape
    dp, hp = _up4(din), _up4(h)
    omask = _t(a["omask"])
    z = pass_split(_pad(x, dp), _pad(w, hp, dp), _pad(_t(a["b"]), hp),
                   mask=None if omask is None else _pad(omask, hp),
                   res=_pad(res, hp), passes=passes)
    return rows_split(z, _pad(_t(a["g"]), hp), _pad(_t(a["beta"]), hp), h)


def _inputs(n, h, f, seed, masked=False, din=None):
    rng = np.random.RandomState(seed)
    mk = lambda *s, sc=1.0: (rng.randn(*s) * sc).astype(np.float32)
    din = din or h
    mask = lambda *s: ((rng.rand(*s) >= RATE) / (1.0 - RATE)).astype(
        np.float32)
    return dict(x=mk(n, h, sc=0.5), w1=mk(h, f, sc=0.1), b1=mk(f, sc=0.1),
                w2=mk(f, h, sc=0.1), b2=mk(h, sc=0.1), res=mk(n, h),
                g=1.0 + mk(h, sc=0.1), beta=mk(h, sc=0.1),
                xd=mk(n, din, sc=0.5), w=mk(din, h, sc=0.1),
                amask=mask(n, f) if masked else None,
                omask=mask(n, h) if masked else None)


def _dense_args(a):
    return dict(a, x=a["xd"], b=a["b2"])


def _j(a, *keys):
    return [None if a[k] is None else jnp.asarray(a[k]) for k in keys]


def _held(got_fn, ref, rate=0.0):
    """The split within the f32 limits of ref, and one-pass tf32 further."""
    split = _worst([got_fn(3)], [ref], TOL, rate)
    assert split <= 1.0, f"worst err / limit {split:.3g}"
    assert _worst([got_fn(1)], [ref], TOL, rate) > split


@pytest.mark.parametrize("act", ACTS)
def test_ffn_fused_split_matches_pallas(act):
    """K9's two f32 passes against the Pallas ffn_fused in interpret
    mode."""
    a = _inputs(256, 128, 256, seed=31)
    ref = fk.ffn_fused(*_j(a, "x", "w1", "b1", "w2", "b2"), act=act,
                       block_rows=128, block_f=128, interpret=True)
    _held(lambda p: ffn_split(a, act, passes=p), ref)


@pytest.mark.parametrize("act", ACTS)
def test_ffn_res_ln_split_matches_pallas(act):
    """K3's up, down-to-z and row passes against the Pallas
    ffn_fused_res_ln in interpret mode."""
    a = _inputs(256, 128, 256, seed=32)
    ref = fk.ffn_fused_res_ln(
        *_j(a, "x", "w1", "b1", "w2", "b2", "res", "g", "beta"), act=act,
        block_rows=128, block_f=128, interpret=True)
    _held(lambda p: ffn_split(a, act, res_ln=True, passes=p), ref)


@pytest.mark.parametrize("din", [128, 256])
def test_dense_split_matches_pallas(din):
    """K2's down pass to z and row pass against the Pallas dense_res_ln in
    interpret mode, Din = H and Din != H."""
    a = _dense_args(_inputs(256, 128, 256, seed=33, din=din))
    ref = fk.dense_res_ln(*_j(a, "x", "w", "b", "res", "g", "beta"),
                          block_rows=128, interpret=True)
    _held(lambda p: dense_split(a, passes=p), ref)


@pytest.mark.parametrize("act", ACTS)
def test_ffn_dropout_split_matches_xla_twin(act):
    """K13: the up pass with the activation mask, the down pass, against
    _xla_ffn_drop given the same mask; 200 rows fill no second row tile."""
    a = _inputs(200, 128, 256, seed=34, masked=True)
    ref = fk._xla_ffn_drop(*_j(a, "x", "w1", "b1", "w2", "b2", "amask"),
                           act)
    _held(lambda p: ffn_split(a, act, passes=p), ref, RATE)


@pytest.mark.parametrize("act", ACTS)
def test_ffn_dropout_res_ln_split_matches_xla_twin(act):
    """K12: both masks, against _xla_ffn_drop_res_ln given the same
    masks."""
    a = _inputs(200, 128, 256, seed=35, masked=True)
    ref = fk._xla_ffn_drop_res_ln(
        *_j(a, "x", "w1", "b1", "w2", "b2", "res", "g", "beta", "amask",
            "omask"), act, EPS)
    _held(lambda p: ffn_split(a, act, res_ln=True, passes=p), ref, RATE)


def test_dense_dropout_split_matches_xla_twin():
    """K11: the output mask before the residual, against
    _xla_dense_drop_res_ln given the same mask."""
    a = _dense_args(_inputs(200, 128, 256, seed=36, masked=True))
    ref = fk._xla_dense_drop_res_ln(
        *_j(a, "x", "w", "b", "res", "g", "beta", "omask"), EPS)
    _held(lambda p: dense_split(a, passes=p), ref, RATE)


@pytest.mark.parametrize("h,f", [(100, 400), (99, 390)])
@pytest.mark.parametrize("act", ACTS)
def test_odd_widths_match_xla(act, h, f):
    """Off the gate's widths: H = 100, F = 400 (multiples of 4, tiles the
    TMA fills with zeros) and H = 99, F = 390 (the wrapper's padding to 100
    and 392); K9 and K3 against the XLA chains without a mask."""
    a = _inputs(130, h, f, seed=37 + h)
    j = _j(a, "x", "w1", "b1", "w2", "b2", "res", "g", "beta")
    ref9 = fk._xla_ffn_drop(*j[:5], None, act)
    _held(lambda p: ffn_split(a, act, passes=p), ref9)
    ref3 = fk._xla_ffn_drop_res_ln(*j, None, None, act, EPS)
    _held(lambda p: ffn_split(a, act, res_ln=True, passes=p), ref3)


@pytest.mark.parametrize("din,h", [(100, 100), (99, 101), (256, 98)])
def test_dense_odd_widths_match_xla(din, h):
    """K2 at widths off the gate, Din and H padded to multiples of 4."""
    a = _dense_args(_inputs(130, h, 4 * h, seed=38 + din, din=din))
    a["omask"] = None
    x, w, b, res, g, beta = _j(a, "x", "w", "b", "res", "g", "beta")
    ref = fk._xla_dense_drop_res_ln(x, w, b, res, g, beta,
                                    jnp.ones((130, h), jnp.float32), EPS)
    _held(lambda p: dense_split(a, passes=p), ref)


@pytest.mark.parametrize("act", ACTS)
def test_padded_columns_stay_zero(act):
    """act(0) = 0 for the four activations: the columns the wrapper pads
    (F 390 to 392, H 99 to 100) are exact zeros in h (with the mask too)
    and in z, and the row pass leaves them out."""
    a = _inputs(64, 99, 390, seed=39, masked=True)
    x, w1, b1, w2, b2 = (_t(a[k]) for k in ("x", "w1", "b1", "w2", "b2"))
    amask = _pad(_t(a["amask"]), 392) + 1.0   # nonzero where padded
    hid = pass_split(_pad(x, 100), _pad(w1, 392, 100), _pad(b1, 392), act,
                     amask)
    z = pass_split(hid, _pad(w2, 100, 392), _pad(b2, 100),
                   res=_pad(_t(a["res"]), 100))
    assert torch.equal(hid[:, 390:], torch.zeros(64, 2))
    assert torch.equal(z[:, 99], torch.zeros(64))
    out = rows_split(z, _pad(_t(a["g"]), 100), _pad(_t(a["beta"]), 100), 99)
    ref = t_ffn.res_ln_rows_plain(z[:, :99], _t(a["g"]), _t(a["beta"]), EPS,
                                  torch.float32)
    assert _worst([out], [ref], TOL) <= 1.0


def test_row_pass_is_mean_then_centred_variance():
    """The row pass's statistics, the mean and then the variance of the
    centred values, against float64 ones on rows with a large common
    offset, where the variance as E[z^2] - mean^2 would lose them."""
    rng = np.random.RandomState(40)
    z = torch.from_numpy((rng.randn(16, 768) * 0.1 + 30.0).astype(
        np.float32))
    g, beta = torch.ones(768), torch.zeros(768)
    zd = z.double()
    d = zd - zd.mean(1, keepdim=True)
    ref = d / torch.sqrt((d * d).mean(1, keepdim=True) + EPS)
    err = (rows_split(z, g, beta, 768).double() - ref).abs().max().item()
    mean = z.mean(1, keepdim=True)
    one_pass = (z - mean) * torch.rsqrt((z * z).mean(1, keepdim=True)
                                        - mean * mean + EPS)
    assert err < 1e-3
    assert (one_pass.double() - ref).abs().max().item() > 10 * err
