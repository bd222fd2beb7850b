"""The port's dropout generator and K10, the mask kernel.

Every dropout mask of the port comes from one counter-based generator,
Philox-4x32-10, keyed on the element's global coordinates: element
(row, col) of a mask takes word ``col % 4`` of ``philox(counter = (col // 4,
row mod 2^32, row // 2^32, stream), key = DropoutKey.words())``.  An
attention mask over (B, H, Tq, Tk) uses ``row = (b * H + h) * Tq + q``.  The
forward kernels, the backward kernels, K10 and the plain version below
therefore draw the same bit for an element whatever their tiling, and the
backward regenerates the forward's mask instead of keeping it.  The CUDA
side is ``csrc/dropout.cuh``; ``philox4x32`` here repeats its arithmetic
with int64 tensor operations and agrees with it bit for bit.

The TPU package seeds ``pltpu.prng_seed(seed, program_id)``, so its streams
depend on the grid; its keep rule is kept exactly
(``flash_attention_kernel.py: _dropout_scale_from_bits``): keep iff the
word is >= ``min(int(rate * 2^32), 2^32 - 1)``, scale by the float32 value
of ``1 / (1 - rate)``.  The port's streams differ from the TPU's and from
``jax.random``'s; only determinism per (key, coordinates) is promised.

Keys are host integers (``DropoutKey``): splitting and folding in run on the
host, and kernels take the key's two words as launch arguments, so no site
reads the device.

``dropout_mask`` (K10, ``csrc/dropout_mask.cu``) replaces the TPU kernel
``speechmix_tpu/ops/pallas/ffn_kernel.py: dropout_mask``: it writes an
(n, cols) float32 mask for a CUDA device and runs ``dropout_mask_plain`` for
the CPU.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ._cuda import CudaKernel, check_aligned, check_cuda_tensor, \
    resolve_device

M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1
STREAM_ACT = 0   # activation and attention-probability masks
STREAM_OUT = 1   # output masks before a residual
# Philox-4x32 multipliers and Weyl key increments (Random123, curand)
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_SPLIT_DOMAIN = 1 << 32   # split() indices sit above fold_in()'s data

KERNEL = CudaKernel(
    "dropout_mask.cu", "smx_dropout_mask",
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] +
    [ctypes.c_uint32] * 4 + [ctypes.c_float, ctypes.c_int])


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & M64
    return x ^ (x >> 31)


class DropoutKey(NamedTuple):
    """A 64-bit host key.  ``fold_in`` and ``split`` derive new keys by a
    splitmix64 hash, the counterparts of ``jax.random.fold_in`` / ``split``
    in the JAX package's key chain."""
    seed: int

    @classmethod
    def from_seed(cls, seed: int) -> "DropoutKey":
        return cls(_splitmix64(int(seed) & M64))

    def fold_in(self, data: int) -> "DropoutKey":
        """A key for `data` in [0, 2^32), e.g. a step number."""
        return DropoutKey(_splitmix64(self.seed ^ _splitmix64(int(data)
                                                             & M64)))

    def split(self, n: int) -> list:
        return [self.fold_in(_SPLIT_DOMAIN + i) for i in range(n)]

    def words(self):
        return self.seed & M32, self.seed >> 32


def split_or_none(key: Optional[DropoutKey], n: int):
    """key.split(n), or n Nones for the deterministic path."""
    return (None,) * n if key is None else key.split(n)


def check_key(key):
    if key is not None and not isinstance(key, DropoutKey):
        raise TypeError(f"a dropout key must be a DropoutKey or None, got "
                        f"{type(key).__name__}")


def threshold_and_scale(rate: float):
    """The keep threshold and the float32 scale of `rate` in [0, 1)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must lie in [0, 1), got {rate}")
    threshold = min(int(rate * 2 ** 32), 2 ** 32 - 1)
    return threshold, float(np.float32(1.0 / (1.0 - rate)))


def launch_args(key: DropoutKey, rate: float):
    """(k0, k1, threshold, scale): what a kernel takes for one mask."""
    return (*key.words(), *threshold_and_scale(rate))


def _mulhilo(a, m: int):
    """(hi, lo) 32-bit words of a * m for int64 tensors a < 2^32 and a
    constant m < 2^32.  The product does not fit a signed int64, so m is
    split into 16-bit halves: each partial product stays below 2^48."""
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & M32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox-4x32-10 on int64 tensors holding uint32 counter words
    (broadcastable), with a 64-bit key as two words: the four output words,
    as int64 tensors."""
    for i in range(10):
        if i:
            k0 = (k0 + _PHILOX_W0) & M32
            k1 = (k1 + _PHILOX_W1) & M32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, _PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_bits(key: DropoutKey, stream: int, n: int, cols: int,
                 device="cpu"):
    """The (n, cols) Philox words of rows 0 .. n-1, as int64 values in
    [0, 2^32)."""
    rows = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    groups = torch.arange(-(-cols // 4), dtype=torch.int64,
                          device=device)[None, :]
    words = philox4x32(groups, rows & M32, rows >> 32,
                       torch.full((), stream, dtype=torch.int64,
                                  device=device), *key.words())
    return torch.stack(words, dim=-1).reshape(n, -1)[:, :cols]


def dropout_mask_plain(key: DropoutKey, stream: int, n: int, cols: int,
                       rate: float, device="cpu"):
    """The (n, cols) float32 mask of {0, 1/(1-rate)} in plain PyTorch."""
    threshold, scale = threshold_and_scale(rate)
    bits = dropout_bits(key, stream, n, cols, device)
    return torch.where(bits >= threshold, scale, 0.0).to(torch.float32)


def dropout_mask(key: DropoutKey, stream: int, n: int, cols: int,
                 rate: float, device=None):
    """K10: the (n, cols) float32 mask of {0, 1/(1-rate)} on `device` (the
    card by default).  A CUDA device launches the kernel; the CPU runs
    dropout_mask_plain."""
    device = resolve_device(device)
    if device.type == "cpu":
        return dropout_mask_plain(key, stream, n, cols, rate, device)
    threshold, scale = threshold_and_scale(rate)
    out = torch.empty((n, cols), dtype=torch.float32, device=device)
    check_cuda_tensor("out", out)
    if cols % 4 == 0:
        check_aligned("out", out, 16)
    KERNEL.launch(out.data_ptr(), n, cols, *key.words(), stream, threshold,
                  scale, out.device.index)
    return out


def attention_mask_plain(key: DropoutKey, b: int, heads: int, tq: int,
                         tk: int, rate: float, device="cpu"):
    """The (B, H, Tq, Tk) attention-probability mask that K14 and K15 draw
    in the kernel (stream STREAM_ACT, row (b * H + h) * Tq + q)."""
    return dropout_mask_plain(key, STREAM_ACT, b * heads * tq, tk, rate,
                              device).view(b, heads, tq, tk)
