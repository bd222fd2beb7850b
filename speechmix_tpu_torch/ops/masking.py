"""Mask and length utilities (port of ``speechmix_tpu.ops.masking``).

Padding is zeros, and explicit boolean masks (True = valid) travel with
every padded tensor.  Additive biases use the large finite ``NEG_INF`` so a
fully masked row stays finite in bf16.
"""

from __future__ import annotations

import torch

NEG_INF = -1e9  # large-negative for masked attention logits (safe in bf16)


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) int lengths -> (B, max_len) bool mask, True at valid positions."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return pos < lengths[:, None]


def downscale_lengths(lengths, downloop: int):
    """Lengths through `downloop` stride-2 kernel-2 convs: L -> floor(L/2)
    each time (Conv1d(k=2, s=2): floor((L-2)/2)+1)."""
    for _ in range(downloop):
        lengths = lengths // 2
    return lengths


def attention_bias_from_mask(kv_mask, dtype=torch.float32):
    """(B, S_kv) bool -> (B, 1, 1, S_kv) additive bias."""
    zero = torch.zeros((), dtype=dtype, device=kv_mask.device)
    neg = torch.full((), NEG_INF, dtype=dtype, device=kv_mask.device)
    return torch.where(kv_mask[:, None, None, :], zero, neg)


def causal_attention_bias(q_len, kv_len=None, dtype=torch.float32, offset=0,
                          device=None):
    """(1, 1, q_len, kv_len) additive causal bias.  `offset` shifts query
    positions forward (incremental decoding: the query at absolute position
    offset+i may attend keys <= offset+i)."""
    kv_len = kv_len if kv_len is not None else q_len
    q_pos = torch.arange(q_len, device=device)[:, None] + offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    bias = torch.where(k_pos <= q_pos, 0.0, NEG_INF).to(dtype)
    return bias[None, None, :, :]


def combine_masks_to_bias(q_mask=None, kv_mask=None, causal=False,
                          dtype=torch.float32):
    """Build a (B, 1, q, kv) additive attention bias from boolean masks."""
    bias = None
    if kv_mask is not None:
        bias = attention_bias_from_mask(kv_mask, dtype)
        if causal:
            q_len = (q_mask.shape[-1] if q_mask is not None
                     else kv_mask.shape[-1])
            bias = bias + causal_attention_bias(
                q_len, kv_mask.shape[-1], dtype, device=kv_mask.device)
    elif causal:
        if q_mask is None:
            # no mask carries a length, so the causal bias cannot be sized;
            # dropping it would run the attention bidirectional
            raise ValueError("combine_masks_to_bias(causal=True) needs "
                             "q_mask or kv_mask to size the causal bias")
        bias = causal_attention_bias(q_mask.shape[-1], dtype=dtype,
                                     device=q_mask.device)
    return bias
