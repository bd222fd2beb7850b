"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference (``benchmark/reference``), which gets the same
seeded weights and inputs and works out everything else again.

Transcription: one row of each window call, drawn from the seed (every row
serves all its steps: the mix bars EOS until the last), at most 16 of them;
the reference runs its full decoder forward over each row's served tokens
(up to and including the first EOS).  Two numbers are compared, each
over the largest reference logit at the served positions: "score_err",
the largest error of the scores the decode loop returned against the
reference's logits, and "served_gap", the widest gap by which a served
token's reference logit lies below the reference's best.  A token that is
the argmax of scores within score_err of the reference lies at most twice
that below the best, so served_gap's limit is twice score_err's: it
catches a served token that is not the argmax of its own scores (the
scores' error cannot see one at the last position), while the control,
which flips no token where no two lie near a tie, is score_err's to catch.

Training: the first three steps that set-up ran through the window's own
step; the reference follows them.  Numbers compared: the largest relative
gap of a step's loss, and over the leaves of the JAX layout the worst gap
of the first gradient's norm (as the optimizer took it), and the worst
and the median leaf's gap of the change over the three steps (the worst
catches a leaf left unmoved or moved double, the median is steady from
seed to seed), each against the reference's norm of that leaf or of the
median leaf, whichever is larger; leaves whose reference gradient is
under a thousandth of the median leaf's (a key projection's bias under
softmax) move by round-off alone and are left out.  LayerDrop's skips of
each step must be the reference's.
"""

from __future__ import annotations

import random
import statistics

import torch

from . import traffic, weights
from .reference import model
from .reference import train as ref_train
from .reference.precision import Precision, full_f32_library

SAMPLE_ROWS = 16
ROW_BLOCK = 8
ZERO_GRAD = 1e-3


def served_lengths(tokens, eos):
    """Tokens served per row: up to and including the first EOS."""
    hit = tokens == eos
    first = torch.where(hit.any(1), hit.float().argmax(1) + 1,
                        torch.full_like(tokens[:, 0], tokens.shape[1]))
    return first


def _min_length(logits, min_length, eos):
    """HF's min_length processor on (B, L, V) logits: EOS is barred at
    position t while t + 1 (the tokens so far, the start token counted)
    is under min_length."""
    barred = torch.arange(logits.shape[1], device=logits.device) + 1 \
        < min_length
    logits[:, barred, eos] = float("-inf")
    return logits


def _ref_scale(ref, valid):
    """The largest finite |ref| over the served positions."""
    finite = torch.isfinite(ref) & valid[..., None]
    return torch.where(finite, ref.abs(), 0.0).amax()


def _score_err(scores, ref, valid):
    """max |scores - ref| over the served positions' finite entries, over
    the largest |ref| there."""
    finite = torch.isfinite(ref) & valid[..., None]
    err = torch.where(finite, (scores - ref).abs(), 0.0).amax()
    return float(err / _ref_scale(ref, valid))


def transcribe_numbers(session, seed, precisions=("f32",)):
    """The numbers of the kept rows (one per window call; at most
    SAMPLE_ROWS of them, drawn from the seed): "served_gap", the widest gap
    of a served token's logit below the float32 reference's best, and
    "score_err", the program's scores against the reference's logits, both
    over the largest reference logit (see the module docstring).  For
    a control precision the same two of the control's logits (the gap of
    the token the control puts first).  Returns ({precision: {number:
    value}}, served tokens)."""
    cfg = session.cfg
    d = cfg["decoder"]
    kept = session.kept
    if len(kept) > SAMPLE_ROWS:
        rng = random.Random(traffic.sub_seed(seed, "sample"))
        kept = rng.sample(kept, SAMPLE_ROWS)
    min_length = session.mix.get("min_length", 0)
    params = weights.make(cfg, traffic.sub_seed(seed, "weights"),
                          session.device)
    out = {p: {"served_gap": 0.0, "score_err": 0.0} for p in precisions}
    served = 0
    for lo in range(0, len(kept), ROW_BLOCK):
        block = kept[lo:lo + ROW_BLOCK]
        wav = torch.stack([session.pool[j]["input_values"][r]
                           for j, r, _, _ in block])
        lens = torch.stack([session.pool[j]["lengths"][r]
                            for j, r, _, _ in block])
        toks = torch.stack([t for _, _, t, _ in block])
        scores = torch.stack([s for _, _, _, s in block])
        n = served_lengths(toks, d["eos_token_id"])
        valid = torch.arange(toks.shape[1], device=toks.device)[None] < \
            n[:, None]
        served += int(valid.sum())
        ref = _min_length(model.served_logits(params, cfg, wav, lens, toks),
                          min_length, d["eos_token_id"])
        best = ref.max(-1).values
        for p in precisions:
            if p == "f32":
                chosen, logits = toks, scores
            else:
                logits = _min_length(model.served_logits(
                    params, cfg, wav, lens, toks, Precision(p)), min_length,
                    d["eos_token_id"])
                chosen = logits.argmax(-1)
            gap = best - ref.gather(-1, chosen[..., None]).squeeze(-1)
            o = out[p]
            o["served_gap"] = max(o["served_gap"], float(
                gap[valid].max() / _ref_scale(ref, valid)))
            o["score_err"] = max(o["score_err"],
                                 _score_err(logits, ref, valid))
        del ref
    return out, served


def gaps(run, ref):
    """The training numbers of one run's readings against the reference's
    (see the module docstring)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(run["loss"], ref["loss"]))
    g_ref = ref["grad_norm"]
    g_med = statistics.median(g_ref.values())
    kept = [n for n in g_ref if g_ref[n] >= ZERO_GRAD * g_med]

    def worst(key):
        r = ref[key]
        med = statistics.median(r[n] for n in kept)
        return max((abs(run[key][n] - r[n]) / max(r[n], med), n)
                   for n in kept)
    def median(key):
        r = ref[key]
        med = statistics.median(r[n] for n in kept)
        return statistics.median(abs(run[key][n] - r[n]) / max(r[n], med)
                                 for n in kept)
    grad, grad_leaf = worst("grad_norm")
    delta, delta_leaf = worst("delta_norm")
    skips = sum(a != b for a, b in zip(run["skipped"], ref["skipped"]))
    return {"loss_gap": loss, "grad_gap": grad, "delta_gap_worst": delta,
            "delta_gap_median": median("delta_norm"),
            "layerdrop_mismatch": float(skips)}, {
                "grad_gap": grad_leaf, "delta_gap_worst": delta_leaf,
                "excluded": sorted(set(g_ref) - set(kept))}


def train_reference(session, seed, precision="f32"):
    params = weights.make(session.cfg, traffic.sub_seed(seed, "weights"),
                          session.device)
    batches = [session.batch(i) for i in range(len(session.readings["loss"]))]
    return ref_train.run_steps(params, session.cfg, batches,
                               session.dropout_seed, session.recipe,
                               precision)


def numbers(session, seed):
    """{name: value} of this run, and details for standard error."""
    full_f32_library()
    if session.train:
        ref = train_reference(session, seed)
        return gaps(session.readings, ref)
    out, served = transcribe_numbers(session, seed)
    return dict(out["f32"]), {"served_tokens": served}


def judge(values, limits):
    """(correct, [[name, value, limit]]): every number at or under its
    limit; a number that is not finite fails."""
    compared = []
    ok = True
    for name, value in values.items():
        limit = limits[name]
        fine = value == value and value <= limit
        ok = ok and fine
        compared.append([name, value, limit])
    return ok, compared
