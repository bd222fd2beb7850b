"""The structure of K6's bf16 kernel, fused_conv_layer_tiled_plain, against
the JAX package on the CPU.

fused_conv_layer_tiled_plain follows the kernel: per batch row, tiles of
128 output rows cut at T_out; per tile the f32 sum over the taps, then over
64-channel steps, of the tap's strided rows of x times the tap's weights;
the bias; with LayerNorm the row sums of four 128-column slices added in
slice order, for the mean and then the centred variance; exact-erf GELU.
It is held against the JAX package's fused_conv_stack with one layer in
interpret mode (speechmix_tpu/ops/pallas/conv_extractor.py) and against
the port's fused_conv_layer_plain, at the bf16 kernel's width C = 512,
k = 2 and 3, LayerNorm on and off, odd T_in, B = 2.

Tolerances (float32).  1e-4 against the Pallas kernel, the limit of the
port's other fused-conv tests (the kernel sums 1536 products in its own
blocks); 1e-5 against fused_conv_layer_plain, whose convolution sums the
same products in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechmix_tpu.ops.pallas import conv_extractor as j_conv
from speechmix_tpu_torch.ops.kernels import conv_extractor as t_conv
from torch_threads import one_torch_thread  # noqa: F401

C, B = 512, 2


def _layer(k, ln, seed):
    """x (B, T_in, C) and one layer's parameters, JAX layout: kernel
    (k, C_in, C_out)."""
    rng = np.random.RandomState(seed)
    layer = {"conv": {
        "kernel": (rng.randn(k, C, C) / np.sqrt(k * C)).astype(np.float32),
        "bias": (rng.randn(C) * 0.1).astype(np.float32)}}
    if ln:
        layer["norm"] = {"scale": (1.0 + 0.1 * rng.randn(C)).astype(np.float32),
                         "bias": (0.1 * rng.randn(C)).astype(np.float32)}
    return rng, layer


def _port_args(layer):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    kernel = t(layer["conv"]["kernel"].transpose(2, 1, 0))
    norm = ({n: t(a) for n, a in layer["norm"].items()}
            if "norm" in layer else None)
    return kernel, t(layer["conv"]["bias"]), norm


@pytest.mark.parametrize("t_in", [301, 263])
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("ln", [False, True])
def test_tiled_matches_pallas_layer(ln, k, t_in):
    """T_out = 150 or 131 (k = 2) and 150 or 131 (k = 3): a whole row tile
    and a ragged one per batch row."""
    rng, layer = _layer(k, ln, 30 + k + 2 * ln)
    x = rng.randn(B, t_in, C).astype(np.float32)
    ref = j_conv.fused_conv_stack(
        jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, [layer]), (k,),
        (2,), bt=32, ln_layers=ln, interpret=True)
    kernel, bias, norm = _port_args(layer)
    out = t_conv.fused_conv_layer_tiled_plain(torch.from_numpy(x), kernel,
                                              bias, norm, 1e-5)
    assert out.shape == (B, (t_in - k) // 2 + 1, C)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("t_in", [3, 129, 257, 301])
@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("ln", [False, True])
def test_tiled_matches_untiled_plain(ln, k, t_in):
    """One output row, exactly one tile (T_out = 128 at T_in 257, k = 2 or
    3: 128 and 128), and ragged tiles, against the library convolution."""
    rng, layer = _layer(k, ln, 40 + k)
    x = torch.from_numpy(rng.randn(B, t_in, C).astype(np.float32))
    kernel, bias, norm = _port_args(layer)
    out = t_conv.fused_conv_layer_tiled_plain(x, kernel, bias, norm, 1e-5)
    ref = t_conv.fused_conv_layer_plain(x, kernel, bias, norm, 1e-5)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def test_tiled_rounds_once_to_bfloat16():
    """bf16 input: f32 sums, one rounding of the GELU output, as the
    kernel; against the plain version at one bf16 step (the two round f32
    values that differ in their last bits: 2^-7 relative at most, plus 1e-4
    near zero, chip_smoke.py's K6 limit)."""
    rng, layer = _layer(3, False, 50)
    x = torch.from_numpy(rng.randn(B, 201, C).astype(np.float32)).bfloat16()
    kernel, bias, _ = _port_args(layer)
    out = t_conv.fused_conv_layer_tiled_plain(x, kernel.bfloat16(), bias)
    ref = t_conv.fused_conv_layer_plain(x, kernel.bfloat16(), bias)
    assert out.dtype == torch.bfloat16
    err = (out.float() - ref.float()).abs()
    assert (err <= 1e-4 + 2.0 ** -7 * ref.float().abs()).all()
