"""Dropout keys and masks of the reference: a frozen copy of the arithmetic
the system under test states for its masks, so that the reference draws the
same element of every mask from the same key.

A mask element (row, col) keeps iff word ``col % 4`` of
``philox4x32-10(counter = (col // 4, row mod 2^32, row // 2^32, stream),
key = the key's two 32-bit words)`` is at least ``min(int(rate * 2^32),
2^32 - 1)``; kept elements are scaled by the float32 value of
``1 / (1 - rate)``.  Keys are 64-bit host integers; ``fold_in`` and
``split`` derive new keys by a splitmix64 hash.  Nothing here reads the
program: the constants are Random123's Philox constants and splitmix64's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1
STREAM_ACT = 0   # activation and attention-probability masks
STREAM_OUT = 1   # output masks before a residual
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_SPLIT_DOMAIN = 1 << 32
# elements of one block of mask rows computed at once (bounds the int64
# temporaries to a few hundred MB)
_BLOCK_ELEMENTS = 1 << 24


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & M64
    return x ^ (x >> 31)


class Key(NamedTuple):
    seed: int

    @classmethod
    def from_seed(cls, seed: int) -> "Key":
        return cls(_splitmix64(int(seed) & M64))

    def fold_in(self, data: int) -> "Key":
        return Key(_splitmix64(self.seed ^ _splitmix64(int(data) & M64)))

    def split(self, n: int) -> list:
        return [self.fold_in(_SPLIT_DOMAIN + i) for i in range(n)]

    def words(self):
        return self.seed & M32, self.seed >> 32


def split(key, n):
    return (None,) * n if key is None else key.split(n)


def step_key(seed: int, step: int) -> Key:
    """The dropout key of step `step` (from 0) of a run seeded `seed`, one
    micro-batch: split(fold_in(key(seed + 0x5EED), step), 1)[0]."""
    return Key.from_seed(seed + 0x5EED).fold_in(step).split(1)[0]


def _mulhilo(a, m: int):
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & M32


def _philox(c0, c1, c2, c3, k0: int, k1: int):
    for i in range(10):
        if i:
            k0 = (k0 + _PHILOX_W0) & M32
            k1 = (k1 + _PHILOX_W1) & M32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, _PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def mask(key: Key, stream: int, n: int, cols: int, rate: float, device):
    """The (n, cols) float32 mask of {0, 1 / (1 - rate)}."""
    threshold = min(int(rate * 2 ** 32), 2 ** 32 - 1)
    scale = float(np.float32(1.0 / (1.0 - rate)))
    out = torch.empty((n, cols), dtype=torch.float32, device=device)
    groups = torch.arange(-(-cols // 4), dtype=torch.int64,
                          device=device)[None, :]
    block = max(1, _BLOCK_ELEMENTS // max(cols, 1))
    stream_t = torch.full((), stream, dtype=torch.int64, device=device)
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        rows = torch.arange(lo, hi, dtype=torch.int64, device=device)[:, None]
        words = _philox(groups, rows & M32, rows >> 32, stream_t,
                        *key.words())
        bits = torch.stack(words, dim=-1).reshape(hi - lo, -1)[:, :cols]
        out[lo:hi] = torch.where(bits >= threshold, scale, 0.0)
    return out


def dropout(x, rate, key, stream=STREAM_ACT):
    """x times the mask of (key, stream), rows the leading dims of x."""
    if key is None or rate <= 0.0:
        return x
    n = x.numel() // x.shape[-1]
    return x * mask(key, stream, n, x.shape[-1], rate, x.device).view(
        x.shape)
