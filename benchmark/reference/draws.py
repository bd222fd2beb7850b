"""SpecAugment's time spans and LayerDrop's skips of the reference, drawn
from a key as the system under test states it draws them: a CPU
``torch.Generator`` seeded with the key's low 63 bits gives SpecAugment one
shared rounding draw and a (B, T) matrix of start scores, and LayerDrop one
uniform draw per layer.  The span sampler has HF's semantics
(``_compute_mask_indices``): num = floor(prob * L / span + eps), at least
min_masks, capped by the room in the row; the starts are the num highest
scores among the valid starts.
"""

from __future__ import annotations

import torch


def host_generator(key):
    return torch.Generator().manual_seed(key.seed & ((1 << 63) - 1))


def time_mask(key, lengths, size, prob, span, min_masks):
    """(B, size) bool, True where a frame is replaced by masked_spec_embed."""
    gen = host_generator(key)
    eps = torch.rand((), generator=gen)
    b = lengths.shape[0]
    u = torch.rand((b, size), generator=gen)
    # the count in float32, as the sampler states it
    nums = torch.floor(prob * lengths.cpu().float() / span + eps).long()
    out = torch.zeros((b, size), dtype=torch.bool)
    for i, (length, num) in enumerate(zip(lengths.tolist(), nums.tolist())):
        num = max(num, min_masks)
        if num * span > size:
            num = size // span
        room = max(length - (span - 1), 0)
        num = min(num, room)
        if num <= 0:
            continue
        starts = torch.topk(u[i, :room], num).indices
        for s in starts.tolist():
            out[i, s:s + span] = True
    return out.to(lengths.device)


def layer_skips(key, n_layers, rate):
    if rate <= 0.0:
        return [False] * n_layers
    u = torch.rand(n_layers, generator=host_generator(key))
    return [v < rate for v in u.tolist()]
