"""The bfloat16 forward of K9 / K3 / K13 / K12 as the card runs it, in
passes (ffn_fwd.cu): the up pass forms h = round(act(x @ w1 + b1) * m_a),
the down pass round(h @ w2 + b2) or the f32 sum z = (h @ w2 + b2) * m_o +
res, the row pass LayerNorm(z) * g + beta.  Their plain versions, chained,
against the whole functions' plain versions (the same bits: the same f32
operations in the same order), and against the Pallas ffn_fused /
ffn_fused_res_ln in interpret mode (tolerance 1e-5, the product's order of
summation and XLA's rational erf, as tests/test_torch_kernels.py states).
The CPU wrappers of the passes draw the same masks as the whole dropout
functions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechmix_tpu.ops.pallas import ffn_kernel as fk
from speechmix_tpu_torch.ops.kernels import dropout as t_drop
from speechmix_tpu_torch.ops.kernels import ffn as t_ffn
from torch_threads import one_torch_thread  # noqa: F401

ACTS = ["gelu", "gelu_new", "relu", "silu"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(n, h, f, dtype=torch.float32, seed=0):
    rng = np.random.RandomState(seed)
    mk = lambda *s, sc=1.0: (rng.randn(*s) * sc).astype(np.float32)
    a = dict(x=mk(n, h, sc=0.5), w1=mk(h, f, sc=0.1), b1=mk(f, sc=0.1),
             w2=mk(f, h, sc=0.1), b2=mk(h, sc=0.1), res=mk(n, h),
             g=1.0 + mk(h, sc=0.1), beta=mk(h, sc=0.1))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    for k in ("x", "w1", "w2", "res"):
        t[k] = t[k].to(dtype)
    return a, t


def _chain(t, act, amask=None, omask=None, res=True):
    hid = t_ffn.ffn_up_plain(t["x"], t["w1"], t["b1"], act, amask)
    if not res:
        return t_ffn.ffn_down_plain(hid, t["w2"], t["b2"])
    z = t_ffn.ffn_down_plain(hid, t["w2"], t["b2"], t["res"], omask)
    return t_ffn.res_ln_rows_plain(z, t["g"], t["beta"], 1e-5, t["x"].dtype)


SHAPES = [(200, 128, 256), (77, 256, 384), (128, 128, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "N%d-H%d-F%d" % s)
@pytest.mark.parametrize("act", ACTS)
def test_passes_chain_to_the_whole_functions(act, shape, dtype):
    _, t = _inputs(*shape, dtype=dtype)
    ops = [t[k] for k in ("x", "w1", "b1", "w2", "b2")]
    hid = t_ffn.ffn_up_plain(t["x"], t["w1"], t["b1"], act)
    assert hid.dtype == dtype and hid.shape == (shape[0], shape[2])
    z = t_ffn.ffn_down_plain(hid, t["w2"], t["b2"], t["res"])
    assert z.dtype == torch.float32         # the sum before the LayerNorm
    assert torch.equal(_chain(t, act, res=False),
                       t_ffn.ffn_fused_plain(*ops, act))
    assert torch.equal(_chain(t, act), t_ffn.ffn_res_ln_plain(
        *ops, t["res"], t["g"], t["beta"], act))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("act", ACTS)
def test_passes_chain_to_the_dropout_functions(act, dtype):
    n, h, f = 200, 128, 256
    _, t = _inputs(n, h, f, dtype=dtype, seed=1)
    rng = np.random.RandomState(2)
    amask = torch.from_numpy((rng.rand(n, f) > 0.1).astype(np.float32) / 0.9)
    omask = torch.from_numpy((rng.rand(n, h) > 0.1).astype(np.float32) / 0.9)
    ops = [t[k] for k in ("x", "w1", "b1", "w2", "b2")]
    assert torch.equal(_chain(t, act, amask, res=False),
                       t_ffn.ffn_dropout_plain(*ops, amask, act))
    assert torch.equal(_chain(t, act, amask, omask),
                       t_ffn.ffn_dropout_res_ln_plain(
                           *ops, t["res"], t["g"], t["beta"], amask, omask,
                           act))


@pytest.mark.parametrize("rates", [(0.1, 0.1), (0.1, 0.0), (0.0, 0.1)])
def test_pass_wrappers_draw_the_functions_masks(rates):
    """On the CPU the pass wrappers run their plain versions with the
    generator's masks of (key, stream): chained they give the dropout
    functions' outputs bit for bit."""
    n, h, f = 96, 128, 256
    _, t = _inputs(n, h, f, dtype=torch.bfloat16, seed=3)
    key = t_drop.DropoutKey.from_seed(11)
    act_rate, out_rate = rates
    ops = [t[k] for k in ("x", "w1", "b1", "w2", "b2")]
    hid = t_ffn.ffn_up(t["x"], t["w1"], t["b1"], "gelu", key, act_rate)
    z = t_ffn.ffn_down(hid, t["w2"], t["b2"], t["res"], key, out_rate)
    out = t_ffn.res_ln_rows(z, t["g"], t["beta"], 1e-5)
    assert torch.equal(out, t_ffn.ffn_dropout_res_ln(
        *ops, t["res"], t["g"], t["beta"], key, act_rate, out_rate))
    assert torch.equal(t_ffn.ffn_down(hid, t["w2"], t["b2"]),
                       t_ffn.ffn_dropout(*ops, key, act_rate))
    with pytest.raises(ValueError, match="with res only"):
        t_ffn.ffn_down(hid, t["w2"], t["b2"], None, key, 0.1)


@pytest.mark.parametrize("shape", [(200, 128, 256), (80, 256, 384)],
                         ids=lambda s: "N%d-H%d-F%d" % s)
@pytest.mark.parametrize("act", ACTS)
def test_passes_match_pallas(act, shape):
    n, h, f = shape
    a, t = _inputs(n, h, f, seed=4)
    names = ("x", "w1", "b1", "w2", "b2")
    blocks = dict(block_rows=40, block_f=128, interpret=True)
    ref = fk.ffn_fused(*(jnp.asarray(a[k]) for k in names), act=act,
                       **blocks)
    np.testing.assert_allclose(_chain(t, act, res=False).numpy(),
                               np.asarray(ref), **TOL)
    ref = fk.ffn_fused_res_ln(
        *(jnp.asarray(a[k]) for k in names + ("res", "g", "beta")), act=act,
        eps=1e-5, **blocks)
    np.testing.assert_allclose(_chain(t, act).numpy(), np.asarray(ref),
                               **TOL)
