"""WER / CER scoring (port of ``speechmix_tpu.metrics``).

Corpus-level error rate = total edit distance over total reference length,
word-level for WER and character-level for CER, the semantics of the
reference's eval metric (``asrp.cer`` / ``asrp.wer``).  The edit distance
is the two-row Levenshtein DP of the port's C++ runtime
(``runtime/native.cpp``), over tokens mapped to int ids as the JAX package
maps them; ``_edit_distance_plain`` is its numpy version.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .runtime import native


def _edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance by the native runtime, each distinct token an
    int id."""
    vocab = {}

    def ids(seq):
        return [vocab.setdefault(t, len(vocab)) for t in seq]
    return native.edit_distance(ids(ref), ids(hyp))


def _edit_distance_plain(ref: Sequence, hyp: Sequence) -> int:
    """_edit_distance's plain version: the two-row DP in numpy."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = np.arange(m + 1, dtype=np.int32)
    cur = np.empty(m + 1, dtype=np.int32)
    for i in range(1, n + 1):
        cur[0] = i
        r = ref[i - 1]
        for j in range(1, m + 1):
            cost = 0 if r == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev, cur = cur, prev
    return int(prev[m])


def wer(references: List[str], hypotheses: List[str]) -> float:
    """Corpus word error rate."""
    total_err, total_len = 0, 0
    for ref, hyp in zip(references, hypotheses):
        r, h = ref.split(), hyp.split()
        total_err += _edit_distance(r, h)
        total_len += len(r)
    return total_err / max(total_len, 1)


def cer(references: List[str], hypotheses: List[str]) -> float:
    """Corpus character error rate."""
    total_err, total_len = 0, 0
    for ref, hyp in zip(references, hypotheses):
        r, h = list(ref), list(hyp)
        total_err += _edit_distance(r, h)
        total_len += len(r)
    return total_err / max(total_len, 1)


def compute_metrics(pred_ids, label_ids, tokenizer) -> dict:
    """The reference's eval hook: strip -100 positions, decode skipping
    special tokens, score CER and WER."""
    preds, labels = [], []
    for p in pred_ids:
        p = np.asarray(p)
        preds.append(tokenizer.decode(p[p != -100], skip_special_tokens=True))
    for l in label_ids:
        l = np.asarray(l)
        labels.append(tokenizer.decode(l[l != -100], skip_special_tokens=True))
    return {"cer": cer(labels, preds), "wer": wer(labels, preds)}
