"""The precision the reference computes its products in.

``f32``: every product and convolution in float32 with TF32 off (the
reference).  The controls round both operands of every product, forward
and backward, first: ``tf32`` to 10 mantissa bits, round to nearest even
(the step below float32 with TF32 off), ``fp8`` to float8 e4m3 with one
scale per tensor (the step below bfloat16).  The rounding is emulated, so a
control reads the same on the CPU and on the card.
"""

from __future__ import annotations

import torch

MODES = ("f32", "tf32", "fp8")
_E4M3_MAX = 448.0


def _round_mantissa(x, drop_bits):
    i = x.contiguous().view(torch.int32)
    lsb = (i >> drop_bits) & 1
    i = (i + ((1 << (drop_bits - 1)) - 1) + lsb) & ~((1 << drop_bits) - 1)
    return i.view(torch.float32)


def _round(x, mode):
    x = x.float()
    if mode == "tf32":
        return _round_mantissa(x, 13)
    if mode == "fp8":
        scale = x.abs().amax().clamp_min(1e-30) / _E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    return x


class _Operand(torch.autograd.Function):
    """Forward: the operand rounded; backward: the gradient passed on."""

    @staticmethod
    def forward(ctx, x, mode):
        return _round(x, mode)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Output(torch.autograd.Function):
    """Forward: unchanged; backward: the incoming gradient rounded, so the
    backward products take rounded operands too."""

    @staticmethod
    def forward(ctx, y, mode):
        ctx.mode = mode
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.mode), None


class Precision:
    def __init__(self, mode="f32"):
        if mode not in MODES:
            raise ValueError(f"precision {mode!r} not in {MODES}")
        self.mode = mode

    def operand(self, x):
        x = x.float()
        return x if self.mode == "f32" else _Operand.apply(x, self.mode)

    def output(self, y):
        return y if self.mode == "f32" else _Output.apply(y, self.mode)


def full_f32_library():
    """TF32 off for the card's library products and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
