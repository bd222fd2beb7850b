"""Host-side audio preprocessing (port of ``speechmix_tpu.data.audio``):
resample to 16 kHz mono, normalize, and static-shape length buckets.

* polyphase resampling and normalisation by the port's C++ runtime
  (``runtime/native.cpp``, no torchaudio), as the JAX package runs them
  when its library is built; ``resample_plain`` and ``normalize_plain``
  are the numpy versions the tests hold it against;
* zero padding with explicit lengths;
* bucket boundaries in seconds, so that a run sees a handful of shapes.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Optional, Sequence

import numpy as np

from ..runtime import native

TARGET_SR = 16000
# default bucket grid (seconds); the reference filters to 1..20 s
DEFAULT_BUCKETS = (4.0, 8.0, 12.0, 16.0, 20.0)


def _sinc_kernel(cutoff: float, half_width: int) -> np.ndarray:
    """Windowed-sinc low-pass for polyphase resampling."""
    n = np.arange(-half_width, half_width + 1, dtype=np.float64)
    taps = np.sinc(2 * cutoff * n)
    window = np.hamming(len(n))
    taps = taps * window
    taps /= taps.sum()
    return taps.astype(np.float32)


def resample(waveform: np.ndarray, orig_sr: int,
             target_sr: int = TARGET_SR) -> np.ndarray:
    """Rational-ratio polyphase resample (mono float32), by the native
    runtime."""
    if orig_sr == target_sr:
        return waveform.astype(np.float32)
    return native.resample(waveform.astype(np.float32), orig_sr, target_sr)


def resample_plain(waveform: np.ndarray, orig_sr: int,
                   target_sr: int = TARGET_SR) -> np.ndarray:
    """resample's plain version in numpy (the ratio limited to a
    denominator of 1000, as the JAX package's numpy path has it)."""
    if orig_sr == target_sr:
        return waveform.astype(np.float32)
    frac = Fraction(target_sr, orig_sr).limit_denominator(1000)
    up, down = frac.numerator, frac.denominator
    x = np.asarray(waveform, np.float64)
    cutoff = 0.5 / max(up, down)
    half = 10 * max(up, down)
    taps = _sinc_kernel(cutoff, half).astype(np.float64)
    # Direct polyphase form (zero-stuff -> convolve "same" -> decimate):
    # output m sits at up-sampled position p = m * down and draws only on
    # the ~2 * half / up real input samples under the kernel, never
    # materialising the up-sampled buffer or the discarded outputs.
    n_in = len(x)
    n_out = (n_in * up + down - 1) // down
    n_terms = 2 * half // up + 2
    t = np.arange(n_terms)
    out = np.empty(n_out, np.float64)
    for lo in range(0, n_out, 65536):           # bound the (m, terms) block
        m = np.arange(lo, min(lo + 65536, n_out))
        p = m * down
        s0 = -((half - p) // up)                 # ceil((p - half) / up)
        src = s0[:, None] + t[None, :]           # input sample indices
        tap_idx = src * up - p[:, None] + half   # position under the kernel
        valid = (src >= 0) & (src < n_in) & \
            (tap_idx >= 0) & (tap_idx <= 2 * half)
        xg = np.where(valid, x[np.clip(src, 0, n_in - 1)], 0.0)
        tg = np.where(valid, taps[np.clip(tap_idx, 0, 2 * half)], 0.0)
        out[m] = (xg * tg).sum(axis=1) * up
    return out.astype(np.float32)


def to_mono(waveform: np.ndarray) -> np.ndarray:
    if waveform.ndim == 2:
        return waveform.mean(axis=0 if waveform.shape[0] < waveform.shape[1]
                             else 1)
    return waveform


def normalize(waveform: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Zero-mean unit-variance (wav2vec2's do_normalize preprocessing), by
    the native runtime."""
    return native.normalize(waveform, eps)


def normalize_plain(waveform: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """normalize's plain version in numpy (float32 moments)."""
    w = np.ascontiguousarray(waveform, np.float32)
    return (w - w.mean()) / math.sqrt(float(w.var()) + eps)


def bucket_length(num_samples: int, buckets: Sequence[float] = DEFAULT_BUCKETS,
                  sr: int = TARGET_SR) -> Optional[int]:
    """Smallest bucket (in samples) that fits; None if too long."""
    for sec in buckets:
        cap = int(sec * sr)
        if num_samples <= cap:
            return cap
    return None


def pad_to(waveform: np.ndarray, target: int) -> np.ndarray:
    out = np.zeros(target, np.float32)
    out[: len(waveform)] = waveform
    return out
