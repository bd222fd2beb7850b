"""The port's HF logits-processor stack, sampling filters and constraint
tables against the JAX package's (``speechmix_tpu.generation``), on seeded
random (N, V) float32 scores and token histories, no model: -inf in the same
places, finite values within 1e-6; each processor alone at several steps,
then all of them together; the constraint tables and their state updates
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechmix_tpu import config as jcfg
from speechmix_tpu import generation as j_gen
from speechmix_tpu_torch import config as tcfg
from speechmix_tpu_torch import generation as t_gen
from torch_threads import one_torch_thread  # noqa: F401

JD = jcfg.SEQ2SEQ_PRESETS["tiny-bart-bytes"]
TD = tcfg.SEQ2SEQ_PRESETS["tiny-bart-bytes"]
N, V, MAX_LEN = 6, 50, 12        # rows, vocabulary, generated tokens
START, PAD, EOS = TD.decoder_start_token_id, TD.pad_token_id, TD.eos_token_id


def _assert_same(out, ref, atol=1e-6):
    out, ref = out.numpy(), np.asarray(ref)
    assert out.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_array_equal(np.isneginf(out), np.isneginf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(out), fin)
    np.testing.assert_allclose(out[fin], ref[fin], rtol=0, atol=atol)


def _scores(seed, neg_share=0.05):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(N, V) * 2).astype(np.float32)
    logits[rng.rand(N, V) < neg_share] = -np.inf     # filtered before
    return logits


def _history(seed, step):
    """[decoder_start] + `step` tokens from a small alphabet (so n-grams
    repeat), pad past them, as the decode loops keep it."""
    rng = np.random.RandomState(seed + 100)
    hist = np.full((N, MAX_LEN + 1), PAD, np.int32)
    hist[:, 0] = START
    hist[:, 1: step + 1] = rng.randint(0, 8, size=(N, step))
    return hist


def _prefix_fn(batch_id, seq):
    """Allowed tokens that depend on the batch row and on the sequence."""
    assert seq.dtype == np.int32 and seq[0] == START
    return [int(t) % V for t in
            range(3 * batch_id + int(seq.sum()), 3 * batch_id
                  + int(seq.sum()) + 7)] + [EOS]


ENC_IDS = np.random.RandomState(7).randint(0, 8, size=(N, 9)).astype(
    np.int32)

PROCESSORS = {
    "repetition_penalty>1": dict(repetition_penalty=1.3),
    "repetition_penalty<1": dict(repetition_penalty=0.7),
    "no_repeat_1": dict(no_repeat_ngram_size=1),
    "no_repeat_2": dict(no_repeat_ngram_size=2),
    "no_repeat_3": dict(no_repeat_ngram_size=3),
    "encoder_no_repeat_2": dict(encoder_no_repeat_ngram_size=2,
                                encoder_input_ids=ENC_IDS),
    "encoder_no_repeat_3": dict(encoder_no_repeat_ngram_size=3,
                                encoder_input_ids=ENC_IDS),
    "bad_words": dict(bad_words_ids=[[5], [EOS], [3, 4], [1, 2, 3],
                                     [6, 7, 0]]),
    "min_length": dict(min_length=5),
    "prefix_fn": dict(prefix_allowed_tokens_fn=_prefix_fn, prefix_beams=2),
    "forced_bos": dict(forced_bos_token_id=7),
    "forced_eos": dict(forced_eos_token_id=9),
    "suppress": dict(suppress_tokens=[1, 4, 4]),
    "begin_suppress": dict(begin_suppress_tokens=[0, 3]),
}
ALL = {k: v for kw in PROCESSORS.values() for k, v in kw.items()
       if k != "repetition_penalty"}
ALL.update(repetition_penalty=1.3, no_repeat_ngram_size=3,
           encoder_no_repeat_ngram_size=2)
PROCESSORS["all together"] = ALL


def _run_both(kw, step, seed):
    logits, hist = _scores(seed), _history(seed, step)
    jkw = dict(kw)
    tkw = dict(kw)
    if "encoder_input_ids" in kw:
        jkw["encoder_input_ids"] = jnp.asarray(kw["encoder_input_ids"])
        tkw["encoder_input_ids"] = torch.from_numpy(kw["encoder_input_ids"])
    ref = j_gen._process_logits_hf(jnp.asarray(logits), JD, step, MAX_LEN,
                                   fullbuf=jnp.asarray(hist), **jkw)
    out = t_gen._process_logits_hf(torch.from_numpy(logits), TD, step,
                                   MAX_LEN, fullbuf=torch.from_numpy(
                                       hist).long(), **tkw)
    return out, ref


@pytest.mark.parametrize("step", [0, 1, 4, MAX_LEN - 1])
@pytest.mark.parametrize("name", list(PROCESSORS))
def test_processor_matches_jax(name, step):
    out, ref = _run_both(PROCESSORS[name], step, seed=step)
    _assert_same(out, ref)


def test_processors_change_what_they_should():
    """The comparisons above are not vacuous: each processor alone changes
    the scores at some step, and the stack leaves them alone when off."""
    for name, kw in PROCESSORS.items():
        changed = False
        for step in (0, 1, 4, MAX_LEN - 1):
            out, _ = _run_both(kw, step, seed=step)
            changed |= not np.array_equal(out.numpy(), _scores(step))
        assert changed, name
    logits = torch.from_numpy(_scores(0))
    assert t_gen._process_logits_hf(logits, TD, 3, MAX_LEN) is logits


def test_prefix_fn_with_an_empty_allowed_list_raises():
    """HF's ValueError (the JAX package raises it inside its callback)."""
    with pytest.raises(ValueError, match="empty list"):
        t_gen._process_logits_hf(
            torch.from_numpy(_scores(0)), TD, 2, MAX_LEN,
            fullbuf=torch.from_numpy(_history(0, 2)).long(),
            prefix_allowed_tokens_fn=lambda b, s: [])


@pytest.mark.parametrize("kw", [
    dict(), dict(repetition_penalty=1.2), dict(no_repeat_ngram_size=2),
    dict(bad_words_ids=[[3]]), dict(bad_words_ids=[[3], [4, 5]]),
    dict(encoder_no_repeat_ngram_size=2),
    dict(prefix_allowed_tokens_fn=_prefix_fn), dict(min_length=3)])
def test_needs_history_matches_jax(kw):
    assert t_gen._needs_history(**kw) == j_gen._needs_history(**kw)


# ---------------------------------------------------------------------------
# sampling filters
# ---------------------------------------------------------------------------

FILTERS = [dict(top_k=1), dict(top_k=5), dict(top_k=100000),
           dict(top_p=0.0), dict(top_p=0.3), dict(top_p=0.9),
           dict(typical_p=0.2), dict(typical_p=0.95),
           dict(top_k=10, top_p=0.8, typical_p=0.9)]


@pytest.mark.parametrize("kw", FILTERS)
@pytest.mark.parametrize("neg_share", [0.0, 0.3])
def test_sample_filter_matches_jax(kw, neg_share):
    logits = _scores(11, neg_share) / np.float32(0.7)
    ref = j_gen.sample_filter_logits(jnp.asarray(logits), **kw)
    out = t_gen.sample_filter_logits(torch.from_numpy(logits), **kw)
    _assert_same(out, ref)


@pytest.mark.parametrize("kw", FILTERS)
def test_sample_filter_keeps_ties_at_the_threshold(kw):
    """Values in {0, 1, 2}: every tie at a filter's threshold survives, as
    in the JAX package's value cuts."""
    logits = np.random.RandomState(12).randint(0, 3, size=(N, V)).astype(
        np.float32)
    ref = j_gen.sample_filter_logits(jnp.asarray(logits), **kw)
    out = t_gen.sample_filter_logits(torch.from_numpy(logits), **kw)
    _assert_same(out, ref)


def test_sample_filter_clamps():
    """top_k above V keeps everything; top_p = 0 keeps the best token."""
    logits = torch.from_numpy(_scores(13, 0.0))
    assert torch.equal(t_gen.sample_filter_logits(logits, top_k=100000),
                       logits)
    kept = torch.isfinite(t_gen.sample_filter_logits(logits, top_p=0.0))
    assert (kept.sum(-1) == 1).all()
    assert kept.gather(1, logits.argmax(-1, keepdim=True)).all()


# ---------------------------------------------------------------------------
# constraint tables
# ---------------------------------------------------------------------------

CONSTRAINTS = [[[4, 5]], [[4, 5], [[7], [8, 9]]],
               [[[3, 4, 5], [3, 6], [9]], [6, 6], [2, 3]],
               [[1], [[5, 6, 7], [5, 8]]]]


def _assert_state(out, ref):
    for name in ref:
        np.testing.assert_array_equal(out[name].numpy(),
                                      np.asarray(ref[name]), err_msg=name)


@pytest.mark.parametrize("words", CONSTRAINTS)
def test_constraint_tables_match_jax(words):
    ref, out = j_gen._build_constraint_tables(words), \
        t_gen._build_constraint_tables(words)
    for name in ("edges_tok", "edges_next", "edges_leaf", "roots",
                 "c_seqlen", "node_depth"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    assert (out.max_seqlen, out.n_constraints, out.adv_width) == \
        (ref.max_seqlen, ref.n_constraints, ref.adv_width)


@pytest.mark.parametrize("words", [[], [[]], [[3, -1]], [[[4, 5], [4]]],
                                   "abc"])
def test_constraint_tables_refuse_what_jax_refuses(words):
    with pytest.raises(ValueError):
        j_gen._build_constraint_tables(words)
    with pytest.raises(ValueError):
        t_gen._build_constraint_tables(words)


@pytest.mark.parametrize("words", CONSTRAINTS)
def test_constraint_state_updates_match_jax(words):
    """Twelve tokens fed to 5 x 4 states (tokens mostly from the tries, so
    constraints advance, complete and reset): add_token, the bank and the
    advance tokens after each, exact."""
    jt, tt = j_gen._build_constraint_tables(words), \
        t_gen._build_constraint_tables(words)
    rng = np.random.RandomState(len(words))
    jst = j_gen._ct_init_state(jt, (5, 4))
    tst = t_gen._ct_init_state(tt, (5, 4))
    _assert_state(tst, jst)
    for _ in range(12):
        tok = rng.randint(1, 10, size=(5, 4)).astype(np.int32)
        jst = j_gen._ct_add_token(jt, jst, jnp.asarray(tok))
        tst = t_gen._ct_add_token(tt, tst, torch.from_numpy(tok).long())
        _assert_state(tst, jst)
        np.testing.assert_array_equal(t_gen._ct_bank(tt, tst).numpy(),
                                      np.asarray(j_gen._ct_bank(jt, jst)))
        np.testing.assert_array_equal(
            t_gen._ct_advance_tokens(tt, tst).numpy(),
            np.asarray(j_gen._ct_advance_tokens(jt, jst)))
    assert np.asarray(jst["completed"]).any()
