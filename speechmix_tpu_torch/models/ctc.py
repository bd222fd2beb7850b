"""CTC head over the speech encoder (port of ``speechmix_tpu.models.ctc``).

speech encoder -> Linear(hidden, vocab) -> float32 logits, trained with the
CTC loss.  The loss is optax's ``ctc_loss`` (the JAX package's) written out
in PyTorch: the same forward recurrence over blank / label states in log
space, with optax's ``log_epsilon`` = -1e5 standing for log(0).  A row with
fewer frames than its labels need therefore gets a large finite loss (about
1e5 per missing frame), as in optax, where
``torch.nn.functional.ctc_loss`` returns inf.  The gradient flows through
the speech encoder's autograd functions (K1 / K7, K3 / K9 + K8, K2, K6).
"""

from __future__ import annotations

import torch

from ..config import SpeechEncoderConfig
from ..ops import layers
from . import speech_encoder as se
from .init import dense_params

# optax.ctc_loss's approximation of log(0)
LOG_EPSILON = -1e5


def init_ctc_model(cfg: SpeechEncoderConfig, vocab_size: int, generator,
                   device, dtype=torch.float32):
    """Random parameters with the JAX package's structure, {"encoder": the
    speech encoder, "lm_head": a (hidden, vocab) dense}, drawn from
    `generator`; matrices in `dtype`, vectors in float32."""
    return {
        "encoder": se.init_speech_encoder(cfg, generator, device, dtype),
        "lm_head": dense_params(generator, device, dtype, cfg.hidden_size,
                                vocab_size),
    }


def _logaddexp_tail(phi, added):
    """phi with phi[:, 1:] replaced by logaddexp(phi[:, 1:], added)."""
    return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)], dim=1)


def ctc_loss(logits, logit_paddings, labels, label_paddings, blank_id=0,
             log_epsilon=LOG_EPSILON):
    """Per-sequence CTC negative log-likelihood (B,), optax.ctc_loss's
    recurrence.  logits: (B, T, K); logit_paddings: (B, T) 1.0 at padded
    frames; labels: (B, N) right-padded; label_paddings: (B, N) 1.0 at
    padded labels.  Computed in float32."""
    b, t_frames, _ = logits.shape
    n = labels.shape[1]
    labels = labels.long()
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    label_lens = n - label_paddings.sum(dim=1).long()
    repeat = (labels[:, :-1] == labels[:, 1:]).float()
    repeat = torch.nn.functional.pad(repeat, (0, 1))
    lp_phi = logprobs[:, :, blank_id].t()[..., None]            # (T, B, 1)
    lp_emit = torch.gather(
        logprobs, 2, labels[:, None, :].expand(b, t_frames, n)
    ).transpose(0, 1)                                            # (T, B, N)
    pads = logit_paddings.float().t()[..., None]                 # (T, B, 1)

    phi = torch.full((b, n + 1), log_epsilon, device=logits.device)
    phi[:, 0] = 0.0
    emit = torch.full((b, n), log_epsilon, device=logits.device)
    eps_repeat = log_epsilon * repeat
    eps_other = log_epsilon * (1.0 - repeat)
    for t in range(t_frames):
        phi_orig = phi
        # emit-to-blank transition, except into a repeated label
        phi = _logaddexp_tail(phi, emit + eps_repeat)
        # blank-to-label and label self-loop
        next_emit = torch.logaddexp(phi[:, :-1] + lp_emit[t],
                                    emit + lp_emit[t])
        # blank self-loop; label-to-blank only before a repeated label
        next_phi = _logaddexp_tail(phi + lp_phi[t],
                                   emit + lp_phi[t] + eps_other)
        pad = pads[t]
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * phi_orig + (1.0 - pad) * next_phi
    phi_last = _logaddexp_tail(phi, emit)
    return -torch.gather(phi_last, 1, label_lens[:, None])[:, 0]


def ctc_apply(params, cfg: SpeechEncoderConfig, input_values, lengths=None,
              labels=None, label_lengths=None, blank_id: int = 0,
              dtype=torch.float32):
    """Forward and, with labels, the CTC loss (the mean over the batch of
    ctc_loss).  labels: (B, L) padded with blank_id beyond label_lengths
    (default: the count of non-blank labels per row).  Returns
    dict(logits (B, T, V) float32, frame_lengths, frame_mask[, loss])."""
    enc = se.speech_encoder_apply(params["encoder"], cfg, input_values,
                                  lengths, dtype=dtype)
    logits = layers.dense(params["lm_head"], enc["last_hidden_state"],
                          dtype).float()
    out = {"logits": logits, "frame_lengths": enc["frame_lengths"],
           "frame_mask": enc["frame_mask"]}
    if labels is not None:
        logit_pad = 1.0 - enc["frame_mask"].float()
        if label_lengths is None:
            label_lengths = (labels != blank_id).sum(dim=-1)
        label_pad = (torch.arange(labels.shape[1], device=labels.device)[None]
                     >= label_lengths[:, None]).float()
        out["loss"] = ctc_loss(logits, logit_pad, labels, label_pad,
                               blank_id).mean()
    return out


def ctc_greedy_decode(logits, frame_mask, blank_id: int = 0):
    """Best-path decode: argmax per frame over the valid frames, repeats
    collapsed, blanks dropped.  Returns a list of Python int lists (one
    read-back to the host)."""
    ids = logits.argmax(dim=-1).cpu().numpy()
    counts = frame_mask.sum(dim=-1).cpu().numpy()
    outs = []
    for row, m in zip(ids, counts):
        prev, seq = -1, []
        for t in row[: int(m)]:
            if t != prev and t != blank_id:
                seq.append(int(t))
            prev = t
        outs.append(seq)
    return outs
