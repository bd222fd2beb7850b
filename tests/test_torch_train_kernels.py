"""The plain versions and differentiable functions of the port's training
kernels (K7 attention backward, K8 FFN backward, K9 fused FFN, and the
autograd functions around K1, K2, K3 and K6) against the JAX package, on the
CPU.

Same numpy inputs (seeded) on both sides.  The JAX Pallas kernels run in
interpret mode; where the JAX package has no kernel its XLA reference chain
is differentiated with jax.grad.  On the CPU the port's wrappers run their
plain versions, which is also what the CUDA kernels are held against on the
card.

Tolerances.  float32: 1e-5 (absolute and relative) for single kernels, 2e-5
of the largest reference magnitude for gradients that pass through a
LayerNorm backward.  bfloat16: 4e-2 of the largest reference magnitude; the
XLA chains round the pre-activation and every product to bfloat16 where the
port's functions keep float32 until one final rounding, so the two differ by
a few bfloat16 steps (2^-8 each).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechmix_tpu import config as jcfg
from speechmix_tpu.models import seq2seq as j_s2s
from speechmix_tpu.ops import layers as j_layers
from speechmix_tpu.ops.pallas import conv_extractor as j_conv
from speechmix_tpu.ops.pallas import ffn_kernel as fk
from speechmix_tpu.ops.pallas import flash_attention_kernel as fak
from speechmix_tpu.training import freezing as j_freezing
from speechmix_tpu.training import trainer as j_trainer
from speechmix_tpu_torch import config as tcfg
from speechmix_tpu_torch.models import seq2seq as t_s2s
from speechmix_tpu_torch.models import speechmix as t_smx
from speechmix_tpu_torch.ops import layers as t_layers
from speechmix_tpu_torch.ops.kernels import attention as t_attn
from speechmix_tpu_torch.ops.kernels import conv_extractor as t_conv
from speechmix_tpu_torch.ops.kernels import ffn as t_ffn
from speechmix_tpu_torch.training import freezing as t_freezing
from speechmix_tpu_torch.training import trainer as t_trainer
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
ACTS = ["gelu", "gelu_new", "relu", "silu"]
T_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
J_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
REL = {"float32": 2e-5, "bfloat16": 4e-2}


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.detach().float().numpy()


def _close_rel(got, ref, rel, name=""):
    ref = np.asarray(ref, np.float32)
    limit = rel * np.abs(ref).max() + 1e-7
    err = np.abs(_np(got) - ref).max()
    assert err <= limit, f"{name}: {err} > {limit}"


# ------------------------------------------------------------- K7 attention
def _attention_inputs(b=3, t=40, h=2, d=64, seed=1):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(b, t, h, d).astype(np.float32) for _ in range(4))
    lens = np.array([t, t - 9, 0])[:b]        # the last row: no valid key
    mask = np.arange(t)[None, :] < lens[:, None]
    return q, k, v, g, mask, 1.0 / math.sqrt(d)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_bwd_plain_matches_reference(causal, dtype):
    """Ragged mask, causal, and a batch row whose keys are all masked."""
    q, k, v, g, mask, scale = _attention_inputs()
    jd, td = J_DTYPE[dtype], T_DTYPE[dtype]
    ref = fak._attn_ref_bwd(*(jnp.asarray(a, jd) for a in (q, k, v)),
                            jnp.asarray(mask), scale, causal,
                            jnp.asarray(g, jd))
    b, t, h, d = q.shape
    slab = lambda a: _t(a, td).reshape(b, t, h * d)
    out = t_attn.attention_bwd(slab(q), slab(k), slab(v), _t(mask), None,
                               None, slab(g), h, scale, causal)
    for name, o, r in zip(("dq", "dk", "dv"), out, ref):
        r = np.asarray(r.astype(jnp.float32)).reshape(b, t, h * d)
        assert o.dtype == td and torch.isfinite(o).all()
        if dtype == "float32":
            np.testing.assert_allclose(_np(o), r, err_msg=name, **TOL)
        else:
            # one bfloat16 step of the largest value: both sides round p,
            # ds and the result at the same places
            _close_rel(o, r, 2.0 ** -7, name)


def test_attention_lse_plain():
    q, k, v, _, mask, scale = _attention_inputs()
    b, t, h, d = q.shape
    slab = lambda a: _t(a).reshape(b, t, h * d)
    out, lse = t_attn.attention_fwd(slab(q), slab(k), slab(v), _t(mask), h,
                                    scale, True, return_lse=True)
    logits = np.einsum("bqhd,bkhd->bhqk", q, k) * scale
    allowed = mask[:, None, None, :] & np.tril(np.ones((t, t), bool))
    logits = np.where(allowed, logits, np.float32(-1e30))
    top = logits.max(-1)
    ref = top + np.log(np.exp(logits - top[..., None]).sum(-1))
    assert lse.shape == (b, h, t) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        out, t_attn.attention_fwd(slab(q), slab(k), slab(v), _t(mask), h,
                                  scale, True))


@pytest.mark.parametrize("causal", [False, True])
def test_attention_trainable_gradients(causal):
    """The autograd function around K1 / K7 against jax.grad of the JAX
    package's differentiable attention."""
    q, k, v, g, mask, scale = _attention_inputs(seed=4)
    b, t, h, d = q.shape

    def j_loss(q_, k_, v_):
        out = fak.flash_attention_trainable(q_, k_, v_, jnp.asarray(mask),
                                            scale, causal)
        return jnp.sum(out * jnp.asarray(g))
    ref = jax.grad(j_loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                                for a in (q, k, v)))
    leaves = [_t(a).reshape(b, t, h * d).requires_grad_() for a in (q, k, v)]
    out = t_attn.attention_trainable(*leaves, _t(mask), h, scale, causal)
    grads = torch.autograd.grad((out * _t(g).reshape(b, t, h * d)).sum(),
                                leaves)
    for o, r in zip(grads, ref):
        np.testing.assert_allclose(_np(o), np.asarray(r).reshape(b, t, h * d),
                                   **TOL)


# ------------------------------------------------------------ K8, K9: FFN
def _ffn_inputs(n=256, h=128, f=256, seed=0):
    rng = np.random.RandomState(seed)
    mk = lambda *s, sc=1.0: (rng.randn(*s) * sc).astype(np.float32)
    return dict(x=mk(n, h, sc=0.5), w1=mk(h, f, sc=0.1), b1=mk(f, sc=0.1),
                w2=mk(f, h, sc=0.1), b2=mk(h, sc=0.1), res=mk(n, h),
                g=1.0 + mk(h, sc=0.1), beta=mk(h, sc=0.1), dy=mk(n, h),
                w=mk(h, h, sc=0.1))


@pytest.mark.parametrize("act", ACTS)
def test_ffn_fused_plain_matches_pallas(act):
    a = _ffn_inputs()
    names = ("x", "w1", "b1", "w2", "b2")
    ref = fk.ffn_fused(*(jnp.asarray(a[k]) for k in names), act=act,
                       block_rows=128, block_f=128, interpret=True)
    out = t_ffn.ffn_fused(*(_t(a[k]) for k in names), act=act)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("act", ACTS)
def test_ffn_bwd_plain_matches_pallas(act):
    a = _ffn_inputs()
    names = ("x", "dy", "w1", "b1", "w2")
    ref = fk.ffn_fused_bwd(*(jnp.asarray(a[k]) for k in names), act=act,
                           block_rows=128, block_f=128, interpret=True)
    out = t_ffn.ffn_bwd(*(_t(a[k]) for k in names), act=act)
    for name, o, r in zip(("dx", "dw1", "db1", "dw2", "db2"), out, ref):
        assert o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=2e-5, err_msg=name)
    # the two entries on their own give the same parts
    dx = t_ffn.ffn_bwd_dx(*(_t(a[k]) for k in names), act=act)
    dw1, db1, dw2 = t_ffn.ffn_bwd_dw(*(_t(a[k]) for k in names), act=act)
    for o, r in zip((dx, dw1, db1, dw2), out):
        torch.testing.assert_close(o, r)


@pytest.mark.parametrize("act", ACTS)
def test_dact_matches(act):
    """atol 1e-5: at the saturated end 1 + tanh cancels to a few float32
    steps, which the two tanh implementations round differently."""
    a = np.linspace(-6, 6, 241).astype(np.float32)
    np.testing.assert_allclose(t_ffn.dact_f32(act, _t(a)).numpy(),
                               np.asarray(fk._dact_f32(act, jnp.asarray(a))),
                               rtol=1e-5, atol=1e-5)


def test_ln_bwd_matches():
    a = _ffn_inputs()
    ref = fk._ln_bwd(jnp.asarray(a["dy"]), jnp.asarray(a["res"]),
                     jnp.asarray(a["g"]), 1e-5)
    out = t_ffn.ln_bwd(_t(a["dy"]), _t(a["res"]), _t(a["g"]), 1e-5)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=2e-5)


def _grads_vs_jax(j_fn, t_fn, operands, dtype, cast):
    """Gradients of sum(fn(*operands) * dy) for every operand.  `cast` names
    the operands held in the compute dtype (activations); the rest are
    float32 parameters."""
    jd, td = J_DTYPE[dtype], T_DTYPE[dtype]
    names = list(operands)
    dy = operands[names[0]] * 0 + np.random.RandomState(9).randn(
        *operands[names[0]].shape).astype(np.float32)
    j_args = [jnp.asarray(operands[k], jd if k in cast else jnp.float32)
              for k in names]

    def j_loss(*args):
        return jnp.sum(j_fn(*args).astype(jnp.float32) * jnp.asarray(dy))
    ref = jax.grad(j_loss, argnums=tuple(range(len(names))))(*j_args)
    t_args = [_t(operands[k], td if k in cast else torch.float32)
              .requires_grad_() for k in names]
    out = t_fn(*t_args)
    grads = torch.autograd.grad((out.float() * _t(dy)).sum(), t_args)
    for name, o, r, arg in zip(names, grads, ref, t_args):
        assert o.dtype == arg.dtype, name
        _close_rel(o, r.astype(jnp.float32), REL[dtype], name)
    return dict(zip(names, grads))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_ffn_res_ln_function_gradients(act, dtype):
    """All eight operands of K3's autograd function (K9 recompute, ln_bwd,
    K8) against jax.grad of the XLA chain; float32 parameters under a
    bfloat16 compute dtype keep unrounded float32 gradients.  (Smooth
    activations only: relu's derivative jumps where the two sides' rounded
    pre-activations straddle 0.)"""
    a = _ffn_inputs()
    ops = {k: a[k] for k in ("x", "w1", "b1", "w2", "b2", "res", "g", "beta")}
    grads = _grads_vs_jax(
        lambda *args: fk._xla_ffn_res_ln(*args, act, 1e-5),
        lambda *args: t_ffn.ffn_res_ln_trainable(*args, act, 1e-5),
        ops, dtype, cast=("x", "res"))
    for name in ("w1", "w2"):
        assert grads[name].dtype == torch.float32
        assert (grads[name].bfloat16().float() != grads[name]).any(), \
            f"d{name} was rounded to bfloat16"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_res_ln_function_gradients(dtype):
    a = _ffn_inputs()
    ops = {k: a[k] for k in ("x", "w", "b2", "res", "g", "beta")}
    grads = _grads_vs_jax(
        lambda *args: fk._xla_dense_res_ln(*args, 1e-5),
        lambda *args: t_ffn.dense_res_ln_trainable(*args, 1e-5),
        ops, dtype, cast=("x", "res"))
    assert (grads["w"].bfloat16().float() != grads["w"]).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffn_fused_function_gradients(dtype):
    a = _ffn_inputs()
    ops = {k: a[k] for k in ("x", "w1", "b1", "w2", "b2")}
    _grads_vs_jax(lambda *args: fk._xla_ffn(*args, "gelu"),
                  lambda *args: t_ffn.ffn_fused_trainable(*args, "gelu"),
                  ops, dtype, cast=("x",))


def test_functions_take_absent_biases():
    a = _ffn_inputs(n=32, h=16, f=32)
    x = _t(a["x"]).requires_grad_()
    w1, w2 = _t(a["w1"]).requires_grad_(), _t(a["w2"]).requires_grad_()
    out = t_ffn.ffn_res_ln_trainable(x, w1, None, w2, None, x, _t(a["g"]),
                                     _t(a["beta"]))
    ref = t_ffn.ffn_res_ln_plain(x, w1, torch.zeros(32), w2, torch.zeros(16),
                                 x, _t(a["g"]), _t(a["beta"]))
    torch.testing.assert_close(out, ref)
    dx, = torch.autograd.grad(out.sum() + (out * out).sum(), [x])
    dx_ref, = torch.autograd.grad(ref.sum() + (ref * ref).sum(), [x])
    # x is both the FFN input and the residual: two contributions
    torch.testing.assert_close(dx, dx_ref, rtol=1e-4, atol=1e-5)


def test_layers_route_wide_blocks_through_the_functions(monkeypatch):
    """ffn_residual_ln_apply, dense_residual_ln_apply and ffn_apply at the row
    gate against the plain chain below it, values and gradients."""
    a = _ffn_inputs(n=64, h=128, f=256)
    p1 = {"kernel": _t(a["w1"]), "bias": _t(a["b1"])}
    p2 = {"kernel": _t(a["w2"]), "bias": _t(a["b2"])}
    ln = {"scale": _t(a["g"]), "bias": _t(a["beta"])}
    pd = {"kernel": _t(a["w"])}

    def run(gate):
        monkeypatch.setattr(t_layers, "FUSED_MIN_ROWS", gate)
        x = _t(a["x"]).reshape(4, 16, 128).clone().requires_grad_()
        y = t_layers.ffn_residual_ln_apply(p1, p2, ln, x, "gelu",
                                           torch.float32)
        y = t_layers.dense_residual_ln_apply(pd, ln, y, x, torch.float32)
        y = y + t_layers.ffn_apply(p1, p2, y, "silu", torch.float32)
        return y, torch.autograd.grad((y * y).sum(), [x])[0]
    (y0, g0), (y1, g1) = run(10 ** 6), run(1)
    torch.testing.assert_close(y1, y0, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(g1, g0, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------------ K6
@pytest.mark.parametrize("ln_layers", [False, True])
def test_conv_stack_function_gradients(ln_layers):
    rng = np.random.RandomState(5)
    c, kernels = 16, (3, 2)
    x = rng.randn(2, 41, c).astype(np.float32)
    layers = []
    for k in kernels:
        layer = {"conv": {"kernel": (rng.randn(k, c, c) * 0.2)
                          .astype(np.float32),
                          "bias": (rng.randn(c) * 0.1).astype(np.float32)}}
        if ln_layers:
            layer["norm"] = {"scale": 1 + (rng.randn(c) * 0.1)
                             .astype(np.float32),
                             "bias": (rng.randn(c) * 0.1).astype(np.float32)}
        layers.append(layer)

    def j_loss(x_, layers_):
        y = j_conv._xla_stack(x_, layers_, kernels, (2, 2), ln_layers, 1e-5)
        return jnp.sum(y * y)
    ref_x, ref_layers = jax.grad(j_loss, argnums=(0, 1))(
        jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, layers))

    t_x = _t(x).requires_grad_()
    t_layers_ = []
    for layer in layers:
        tl = {"conv": {"kernel": _t(layer["conv"]["kernel"].transpose(2, 1, 0)
                                    .copy()).requires_grad_(),
                       "bias": _t(layer["conv"]["bias"]).requires_grad_()}}
        if ln_layers:
            tl["norm"] = {k: _t(v).requires_grad_()
                          for k, v in layer["norm"].items()}
        t_layers_.append(tl)
    y = t_conv.fused_conv_stack(t_x, t_layers_, ln_layers, 1e-5)
    assert y.grad_fn is not None and "ConvStack" in type(y.grad_fn).__name__
    leaves = [t_x] + [leaf for tl in t_layers_ for part in tl.values()
                      for leaf in part.values()]
    grads = iter(torch.autograd.grad((y * y).sum(), leaves))
    np.testing.assert_allclose(_np(next(grads)), np.asarray(ref_x), rtol=1e-4,
                               atol=1e-5)
    for tl, rl in zip(t_layers_, ref_layers):
        for part in tl:
            for name in tl[part]:
                got, ref = _np(next(grads)), np.asarray(rl[part][name])
                if name == "kernel":
                    got = got.transpose(2, 1, 0)
                np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5,
                                           err_msg=f"{part}/{name}")


# ----------------------------------------------- losses, masks, schedule
def test_cross_entropy_with_ignore():
    rng = np.random.RandomState(2)
    logits = rng.randn(3, 7, 11).astype(np.float32) * 3
    labels = rng.randint(0, 11, size=(3, 7))
    labels[0, 4:] = -100
    labels[2] = -100
    ref = j_layers.cross_entropy_with_ignore(jnp.asarray(logits),
                                             jnp.asarray(labels))
    out = t_layers.cross_entropy_with_ignore(_t(logits), _t(labels))
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6, atol=1e-6)
    none = t_layers.cross_entropy_with_ignore(
        _t(logits), torch.full((3, 7), -100))
    assert none.item() == 0.0


def test_shift_tokens_right():
    labels = np.array([[5, 6, 7, -100], [9, -100, -100, -100]])
    ref = j_s2s.shift_tokens_right(jnp.asarray(labels), 1, 2)
    out = t_s2s.shift_tokens_right(_t(labels), 1, 2)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _mask_by_path(tree):
    """{path without layer indices: value}: the JAX package stacks layers."""
    out = {}
    for path, v in t_freezing.tree_paths(tree):
        parts = path.split("/")
        if "layers" in parts and "feature_extractor" not in parts:
            parts.pop(parts.index("layers") + 1)
        out["/".join(parts)] = float(v)
    return out


@pytest.mark.parametrize("variant,fixed_speech,fixed_nlp,fixed_parameters", [
    ("eed", False, True, False), ("eed", False, True, True),
    ("ed", False, True, False), ("fixed", False, True, False),
    ("fixed", True, False, False), ("fixed", True, True, True)])
def test_variant_trainable_mask(variant, fixed_speech, fixed_nlp,
                                fixed_parameters):
    def build(mod):
        return mod.SpeechMixConfig(
            encoder=mod.SPEECH_ENCODER_PRESETS["tiny-speech"],
            decoder=mod.SEQ2SEQ_PRESETS["tiny-bart-bytes"], down_scale=2,
            variant=variant, fixed_parameters=fixed_parameters)
    jc, tc = build(jcfg), build(tcfg)
    from speechmix_tpu.models import speechmix as j_smx
    j_params = j_smx.init_speechmix(jax.random.PRNGKey(0), jc)
    ref = {k: float(v) for k, v in j_freezing.tree_paths(
        j_freezing.variant_trainable_mask(j_params, jc, fixed_speech,
                                          fixed_nlp))}
    params = t_smx.init_speechmix(tc, torch.Generator().manual_seed(0), "cpu")
    got = _mask_by_path(t_freezing.variant_trainable_mask(
        params, tc, fixed_speech, fixed_nlp))
    assert got == ref
    assert 0.0 in got.values() or (variant == "eed" and not fixed_parameters)
    # apply_grad_mask zeroes exactly the frozen leaves
    ones = t_freezing.tree_map(torch.ones_like, params)
    masked = t_freezing.apply_grad_mask(ones, t_freezing.variant_trainable_mask(
        params, tc, fixed_speech, fixed_nlp))
    for (path, leaf), (_, m) in zip(
            t_freezing.tree_paths(masked), t_freezing.tree_paths(
                t_freezing.variant_trainable_mask(params, tc, fixed_speech,
                                                  fixed_nlp))):
        assert leaf.min().item() == leaf.max().item() == m, path


@pytest.mark.parametrize("schedule,warmup,max_steps", [
    ("linear", 3, 10), ("cosine", 3, 10), ("constant", 3, 10),
    ("linear", 2, 0), ("linear", 0, 5), ("linear", 1, 6)])
def test_lr_schedule(schedule, warmup, max_steps):
    kw = dict(learning_rate=3e-4, warmup_steps=warmup, lr_schedule=schedule,
              max_steps=max_steps)
    ref = j_trainer.make_lr_schedule(j_trainer.TrainConfig(**kw))
    got = t_trainer.make_lr_schedule(t_trainer.TrainConfig(**kw))
    last = max(max_steps, warmup + 1)
    for count in sorted({0, 1, warmup, warmup + 1, last - 1, last, last + 3}):
        np.testing.assert_allclose(got(count), float(ref(count)), rtol=1e-6,
                                   atol=1e-12, err_msg=str(count))
    if warmup:
        assert got(0) == 0.0
