"""WER / CER scoring (port of ``speechmix_tpu.metrics``).

Corpus-level error rate = total edit distance over total reference length,
word-level for WER and character-level for CER, the semantics of the
reference's eval metric (``asrp.cer`` / ``asrp.wer``).  One path: the
two-row Levenshtein DP in numpy (the JAX package also has a C++ inner loop
in ``runtime/native.cpp``, not carried here; the distances are the same
integers).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def _edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance with a two-row DP."""
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
