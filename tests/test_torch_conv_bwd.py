"""The backward of K6's extractor stack (csrc/conv_bwd.cu) as its plain
versions on the CPU.

conv_layer_backward_tiled_plain follows the three kernels: the activation
pass in 128-row tiles (products over taps and channel stages, the bias,
LayerNorm's statistics and the row sums of its backward from 128-column
slices added in slice order, exact-erf GELU', gz rounded to x's dtype, the
tiles' column sums added in tile order), the data pass split by the parity
of the input row (dx[2 t] = gz[t] w_0^T + gz[t - 1] w_2^T, dx[2 t + 1] =
gz[t] w_1^T at k = 3), the weight pass over the fixed row ranges of
weight_split_plan added in range order.  The float32 cases take each stage's
product as the tensor cores do, three tf32 products of split operands
(test_torch_f32_split.split_product).  It is held against autograd through
conv_stack_recompute (the library path the kernels replace) and against
jax.vjp of the JAX package's fused_conv_stack_trainable; conv_stack_backward
against the gradients that a frozen x or frozen weights leave wanted.

Tolerances, as the largest error over the largest reference magnitude of
each gradient.  float32: 2e-5, the limit of the port's other gradients
through a LayerNorm backward (test_torch_train_kernels.py), the f32-accurate
products erring by about 2^-21 a product.  bfloat16 (against float32
autograd on the same bf16 inputs): 1e-2, gz and dx each rounded once to
bfloat16 (2^-9 relative) before the products that use them, a few such
steps in a gradient's largest element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechmix_tpu.ops.pallas import conv_extractor as j_conv
from speechmix_tpu_torch.ops.kernels import conv_extractor as t_conv
from test_torch_f32_split import split_product
from torch_threads import one_torch_thread  # noqa: F401

TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
NAMES = ("dx", "kernel", "bias", "scale", "beta")


def _stack(c, kernels, ln, bias, seed, b=2, t_in=83):
    """x (B, T_in, C) and the layers in JAX's layout: kernel (k, C_in,
    C_out)."""
    rng = np.random.RandomState(seed)
    layers = []
    for k in kernels:
        conv = {"kernel": (rng.randn(k, c, c) / np.sqrt(k * c))
                .astype(np.float32)}
        if bias:
            conv["bias"] = (rng.randn(c) * 0.1).astype(np.float32)
        layer = {"conv": conv}
        if ln:
            layer["norm"] = {"scale": (1 + 0.1 * rng.randn(c))
                             .astype(np.float32),
                             "bias": (0.1 * rng.randn(c)).astype(np.float32)}
        layers.append(layer)
    return rng, rng.randn(b, t_in, c).astype(np.float32), layers


def _params(layers, dtype=torch.float32):
    """The port's (kernel (C_out, C_in, k), bias, scale, beta) per layer,
    float32 leaves holding values of `dtype`."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dtype).float()
    out = []
    for layer in layers:
        norm = layer.get("norm", {})
        out.append((t(layer["conv"]["kernel"].transpose(2, 1, 0)),
                    None if "bias" not in layer["conv"]
                    else t(layer["conv"]["bias"]),
                    None if "scale" not in norm else t(norm["scale"]),
                    None if "bias" not in norm else t(norm["bias"])))
    return out


def _product(dtype):
    return split_product if dtype == torch.float32 else None


def _autograd(x, params, ln, grad):
    """(dx, flat grads) of conv_stack_recompute in float32."""
    x = x.float().detach().requires_grad_()
    leaves = [None if t is None else t.detach().requires_grad_()
              for layer in params for t in layer]
    y = t_conv.conv_stack_recompute(x, list(zip(*[iter(leaves)] * 4)), ln,
                                    1e-5)
    wanted = [x] + [t for t in leaves if t is not None]
    got = iter(torch.autograd.grad(y, wanted, grad.float()))
    dx = next(got)
    return dx, [None if t is None else next(got) for t in leaves]


def _worst(got, ref):
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [32, 64, 512])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("ln", [False, True], ids=["noln", "ln"])
@pytest.mark.parametrize("k", [2, 3])
def test_tiled_layer_matches_autograd(k, ln, bias, c, dtype):
    """One layer.  C = 32 and 64 (one block of 64 columns) over T_out = 131
    (a whole and a ragged row tile, two chunks and more of the weight pass's
    rows); C = 512 (four blocks of 128) over T_out = 41.  T_in = 263 / 83
    at k = 3 leaves no row unread, at k = 2 one (its dx row is zero)."""
    t_in = 83 if c == 512 else 263
    _, x, layers = _stack(c, (k,), ln, bias, 10 * k + c + 2 * ln + bias,
                          t_in=t_in)
    params = _params(layers, dtype)
    x = torch.from_numpy(x).to(dtype)
    t_out = (t_in - k) // 2 + 1
    grad = torch.randn(2, t_out, c, generator=torch.Generator().manual_seed(
        k + c)).to(dtype)
    kernel, b_, scale, beta = params[0]
    norm = {"scale": scale, "bias": beta} if ln else None
    got = t_conv.conv_layer_backward_tiled_plain(
        x, kernel.to(dtype), b_, norm, 1e-5, grad, (True, True, bias, ln, ln),
        product=_product(dtype))
    ref_dx, ref = _autograd(x, params, ln, grad)
    assert got[0].dtype == dtype and got[0].shape == x.shape
    assert got[1].dtype == torch.float32 and got[1].shape == kernel.shape
    if k == 2 and t_in % 2:
        assert not got[0][:, -1].any()
    for name, g, r in zip(NAMES, got, [ref_dx] + ref):
        if r is None:
            assert g is None, name
            continue
        assert _worst(g, r) <= TOL[dtype], (name, _worst(g, r))


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("ln", [False, True], ids=["noln", "ln"])
@pytest.mark.parametrize("c", [32, 512])
def test_tiled_stack_matches_jax_vjp(c, ln, bias):
    """Two layers (k = 3, then 2), float32: conv_stack_backward_tiled_plain
    against jax.vjp of fused_conv_stack_trainable (its forward the Pallas
    kernel in interpret mode, its backward the XLA chain)."""
    kernels = (3, 2)
    _, x, layers = _stack(c, kernels, ln, bias, 70 + c + 2 * ln + bias,
                          t_in=91)
    jl = jax.tree_util.tree_map(jnp.asarray, layers)
    y, vjp = jax.vjp(
        lambda x_, l_: j_conv.fused_conv_stack_trainable(
            x_, l_, kernels, (2, 2), ln, 1e-5, True), jnp.asarray(x), jl)
    g = np.random.RandomState(c).randn(*y.shape).astype(np.float32)
    ref_x, ref_layers = vjp(jnp.asarray(g))
    params = _params(layers)
    needs = (True,) + tuple(t is not None for layer in params
                            for t in layer)
    dx, grads = t_conv.conv_stack_backward_tiled_plain(
        torch.from_numpy(x), params, ln, 1e-5, torch.from_numpy(g), needs,
        product=split_product)
    assert _worst(dx, torch.from_numpy(np.array(ref_x))) <= TOL[
        torch.float32]
    for l, rl in enumerate(ref_layers):
        refs = [np.asarray(rl["conv"]["kernel"]).transpose(2, 1, 0),
                np.asarray(rl["conv"]["bias"]) if bias else None,
                np.asarray(rl["norm"]["scale"]) if ln else None,
                np.asarray(rl["norm"]["bias"]) if ln else None]
        for i, ref in enumerate(refs):
            got = grads[4 * l + i]
            if ref is None:
                assert got is None
                continue
            err = _worst(got, torch.from_numpy(np.ascontiguousarray(ref)))
            assert err <= TOL[torch.float32], (l, NAMES[1 + i], err)


@pytest.mark.parametrize("frozen", ["none", "x", "layer1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("ln", [False, True], ids=["noln", "ln"])
@pytest.mark.parametrize("c", [36, 64])
def test_stack_function_matches_recompute(c, ln, dtype, frozen):
    """fused_conv_stack's autograd function on CPU tensors (every layer's
    input kept, conv_stack_backward over the plain layers) against autograd
    through conv_stack_recompute in x's dtype, float32 leaves; C = 36 is a
    width that the card's kernels take padded to 40.  Frozen tensors get
    no gradient."""
    kernels = (3, 2)
    _, x, layers = _stack(c, kernels, ln, True, 130 + c + ln, t_in=91)
    leaves = [t for layer in _params(layers) for t in layer]
    trains = [frozen != "layer1" or i >= 4 for i in range(len(leaves))]
    x = torch.from_numpy(x).to(dtype)
    grad = torch.randn(2, 22, c, generator=torch.Generator().manual_seed(c))

    def grads(run):
        xs = x.clone().requires_grad_(frozen != "x")
        ls = [None if t is None else t.clone().requires_grad_(w)
              for t, w in zip(leaves, trains)]
        y = run(xs, ls)
        wanted = [t for t in [xs] + ls if t is not None and t.requires_grad]
        got = iter(torch.autograd.grad(y, wanted, grad.to(y.dtype)))
        return [next(got) if t is not None and t.requires_grad else None
                for t in [xs] + ls]

    def port(xs, ls):
        return t_conv.fused_conv_stack(xs, [
            {"conv": {"kernel": ls[4 * l], "bias": ls[4 * l + 1]},
             **({"norm": {"scale": ls[4 * l + 2], "bias": ls[4 * l + 3]}}
                if ln else {})} for l in range(len(kernels))], ln, 1e-5)

    def recompute(xs, ls):
        return t_conv.conv_stack_recompute(
            xs, list(zip(*[iter(ls)] * 4)), ln, 1e-5)

    names = ["x"] + [f"{n} {l}" for l in range(2) for n in NAMES[1:]]
    for name, g, r in zip(names, grads(port), grads(recompute)):
        if r is None:
            assert g is None, name
            continue
        assert g.dtype == r.dtype and g.shape == r.shape, name
        assert _worst(g, r) <= TOL[dtype], (name, _worst(g, r))


@pytest.mark.parametrize("frozen", ["x", "weights", "x_and_layer1",
                                    "vectors", "all_but_top"])
def test_stack_backward_wants_only_what_is_needed(frozen):
    """needs_input_grad as the autograd function passes it: the gradients of
    frozen tensors are None, the others those of the full backward, and a
    layer's dx is asked for only where x or a lower layer trains."""
    kernels = (3, 3, 2)
    _, x, layers = _stack(32, kernels, True, True, 90, t_in=61)
    params = _params(layers)
    x = torch.from_numpy(x)
    full = (True,) + (True,) * 12
    needs = {"x": (False,) + (True,) * 12,
             "weights": (True,) + (False, True, True, True) * 3,
             "x_and_layer1": (False,) + (False,) * 4 + (True,) * 8,
             "vectors": (False,) + (False, True, True, True) * 3,
             "all_but_top": (False,) + (False,) * 8 + (True,) * 4}[frozen]
    asked = []

    def layer(x_, *args):
        asked.append(args[-1])
        return t_conv.conv_layer_backward_plain(x_, *args)
    inputs = [x]
    for kernel, b_, scale, beta in params[:-1]:
        inputs.append(t_conv.fused_conv_layer_plain(
            inputs[-1], kernel, b_, {"scale": scale, "bias": beta}))
    grad = torch.randn(2, 7, 32, generator=torch.Generator().manual_seed(1))
    ref_dx, ref = t_conv.conv_stack_backward(inputs, params, True, 1e-5, grad,
                                             full, layer)
    asked.clear()
    dx, grads = t_conv.conv_stack_backward(inputs, params, True, 1e-5, grad,
                                           needs, layer)
    assert (dx is None) == (not needs[0])
    if dx is not None:
        torch.testing.assert_close(dx, ref_dx, rtol=0, atol=0)
    for want, g, r in zip(needs[1:], grads, ref):
        assert (g is None) == (not want)
        if want:
            torch.testing.assert_close(g, r, rtol=0, atol=0)
    # layers walked from the last: layer 3, 2, 1
    dx_asked = [a[0] for a in asked]
    assert dx_asked == {"x": [True, True, False],
                        "weights": [True, True, True],
                        "x_and_layer1": [True, False],
                        "vectors": [True, True, False],
                        "all_but_top": [False]}[frozen]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("ln", [False, True], ids=["noln", "ln"])
@pytest.mark.parametrize("k", [2, 3])
def test_plain_layer_matches_autograd(k, ln, dtype):
    """The untiled plain version (library calls in float32) that chip_smoke
    times beside the kernels, at C = 64, asked (by default) for every
    gradient the layer has."""
    _, x, layers = _stack(64, (k,), ln, True, 110 + k + ln, t_in=100)
    params = _params(layers, dtype)
    x = torch.from_numpy(x).to(dtype)
    grad = torch.randn(2, (100 - k) // 2 + 1, 64,
                       generator=torch.Generator().manual_seed(k)).to(dtype)
    kernel, b_, scale, beta = params[0]
    got = t_conv.conv_layer_backward_plain(
        x, kernel.to(dtype), b_, {"scale": scale, "bias": beta} if ln
        else None, 1e-5, grad)
    ref_dx, ref = _autograd(x, params, ln, grad)
    for name, g, r in zip(NAMES, got, [ref_dx] + ref):
        assert (g is None) == (r is None), name
        if r is not None:
            assert _worst(g, r) <= TOL[dtype], (name, _worst(g, r))


@pytest.mark.parametrize("b,t_out,c,k,dtype,expect", [
    (32, 25599, 512, 3, torch.float32, (11, 2328)),
    (32, 799, 512, 2, torch.float32, (16, 50)),
    (16, 25599, 512, 3, torch.bfloat16, (11, 582)),
    (2, 10, 32, 3, torch.float32, (2, 1)),
    (1, 5, 1024, 3, torch.bfloat16, (1, 1)),
])
def test_weight_split_plan(b, t_out, c, k, dtype, expect):
    """The ranges cover every step once and none is empty; at the flagship's
    layer 1 and 6 (B = 32, f32) and the XL's layer 1 (B = 16, bf16) about
    four blocks an SM."""
    splits, per = t_conv.weight_split_plan(b, t_out, c, k, dtype)
    depth = 64 if dtype == torch.bfloat16 else 32
    steps = b * -(-t_out // depth)
    assert (splits, per) == expect
    assert splits * per >= steps > (splits - 1) * per
