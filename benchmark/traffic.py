"""The one generator of the benchmark's traffic: a mix file's parameters
turned into a pool of batches on the device, from a seed.

A mix (``traffic/<name>.json``) names the entry point and its shapes:

  entry           "generate" (batched transcription) or "train_step"
  batch           rows per call or step
  padded_seconds  every row's padded length (aligned to whole frames)
  valid_seconds   [lo, hi]: each batch's valid lengths are evenly spaced
                  over it, the same multiset in every batch and seed
  pool            distinct batches made at set-up and cycled
  amplitude       the standard deviation of the noise audio
  max_length      (generate) decode steps
  min_length      (generate) HF's min_length: EOS barred until then
  label_positions, label_lengths [lo, hi]  (train_step) the labels'
                  width and the evenly spaced counts of valid labels
  recipe          (train_step) TrainConfig's fields as run: learning_rate,
                  warmup_steps and max_grad_norm (the reference's recipe
                  too), and any other (e.g. "bf16": true)
  dtype           (generate) the compute dtype

The seed shuffles the order of the lengths within each batch and draws the
samples and label ids; it never changes the sizes, so every seed carries
the same work.
"""

from __future__ import annotations

import torch

SAMPLE_RATE = 16000


def sub_seed(seed: int, what: str) -> int:
    """A seed for one use of the run's seed (weights, traffic, ...)."""
    h = 1469598103934665603
    for ch in f"{seed}:{what}":
        h = ((h ^ ord(ch)) * 1099511628211) % (1 << 64)
    return h % (1 << 63)


def _spaced(lo, hi, n):
    if n == 1:
        return torch.tensor([hi], dtype=torch.float64)
    return torch.linspace(lo, hi, n, dtype=torch.float64)


def make_pool(mix, seed, device, aligned_samples, vocab):
    """[batch dicts] of the mix.  aligned_samples: the configuration's
    padded sample count for a length (whole frames); vocab: the text
    vocabulary size (label ids are drawn from [4, vocab))."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "traffic"))
    cpu = torch.Generator().manual_seed(sub_seed(seed, "order"))
    b = mix["batch"]
    padded = aligned_samples(int(round(mix["padded_seconds"] * SAMPLE_RATE)))
    valid = (_spaced(*mix["valid_seconds"], b) * SAMPLE_RATE).round().long()
    pool = []
    for _ in range(mix["pool"]):
        lengths = valid[torch.randperm(b, generator=cpu)]
        wav = torch.randn((b, padded), generator=gen, device=device) \
            * mix["amplitude"]
        keep = torch.arange(padded, device=device)[None, :] < \
            lengths.to(device)[:, None]
        batch = {"input_values": wav * keep, "lengths": lengths.to(device)}
        if mix["entry"] == "train_step":
            width = mix["label_positions"]
            counts = _spaced(*mix["label_lengths"], b).round().long()
            counts = counts[torch.randperm(b, generator=cpu)]
            ids = torch.randint(4, vocab, (b, width), generator=gen,
                                device=device)
            pos = torch.arange(width, device=device)[None, :]
            batch["labels"] = torch.where(pos < counts.to(device)[:, None],
                                          ids, -100)
        pool.append(batch)
    return pool


def audio_seconds(batch) -> float:
    """The valid audio seconds of a batch (reads its lengths: set-up
    only)."""
    return float(batch["lengths"].sum()) / SAMPLE_RATE
