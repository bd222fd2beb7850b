"""The modes of generate() beyond plain greedy and beam search, the port
against the JAX package on the CPU in float32, on the tiny presets with the
same numpy weights: sampled greedy, the HF processors, the prefix function,
early_stop, beam-sample, group beam search and constrained beam search
(also with int8 cross K/V and on logits tied on purpose).  Tokens and
lengths exact, scores within 1e-4.

The port runs each mode through its generate(); the JAX package runs the
mode's decode function (jitted, so that a mode's tests share one compile)
on the port's text-encoder output, which test_torch_slice pins against the
JAX encoder.  One case runs the JAX generate() end to end.  Sampling is
pinned by feeding the port JAX's own draws for fold_in(rng, step) in place
of its generator's (``_gumbel``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechmix_tpu import config as jcfg
from speechmix_tpu import generation as j_gen
from speechmix_tpu_torch import config as tcfg
from speechmix_tpu_torch import convert
from speechmix_tpu_torch import generation as t_gen
from speechmix_tpu_torch.models import seq2seq as t_s2s
from speechmix_tpu_torch.models import speechmix as t_smx
from torch_threads import one_torch_thread  # noqa: F401

L = 10                  # max_length
SEED = 3
WORDS = [[40, 41], [[50], [60, 61]]]    # a phrase and a disjunctive set


def _cfg(m):
    return m.SpeechMixConfig(
        encoder=m.SPEECH_ENCODER_PRESETS["tiny-speech"],
        decoder=m.SEQ2SEQ_PRESETS["tiny-bart-bytes"], down_scale=2)


JC, TC = _cfg(jcfg), _cfg(tcfg)


def _redraw(tree, seed=1, weight_std=0.1):
    """Matrices at `weight_std` and the decoder's position table at 3.0, so
    the decoded tokens depend on the input."""
    rng = np.random.RandomState(seed)

    def redraw(path, a):
        name = jax.tree_util.keystr(path)
        if "decoder" in name and "embed_positions" in name:
            return (rng.randn(*a.shape) * 3.0).astype(np.float32)
        if a.ndim >= 2 and "layer_norm" not in name:
            return (rng.randn(*a.shape) * weight_std).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(redraw, tree)


def _with_nlp(tree, **leaves):
    nlp = dict(tree["nlp"])
    nlp.update(leaves)
    return dict(tree, nlp=nlp)


@pytest.fixture(scope="module")
def setup():
    tree = _redraw(convert.tree_to_jax_layout(t_smx.init_speechmix(
        TC, torch.Generator().manual_seed(0), "cpu")))
    rng = np.random.RandomState(0)
    wav = (rng.randn(2, 6000) * 0.1).astype(np.float32)
    wav[1, 4500:] = 0.0
    lens = np.array([6000, 4500], np.int32)
    return tree, wav, lens


class Case:
    """One weight set: the port's params, the JAX decoder params and the
    port's text-encoder output (what its generate() decodes from)."""

    def __init__(self, tree, wav, lens):
        self.tree, self.wav, self.lens = tree, wav, lens
        self.tp = convert.params_from_jax(tree, TC)
        emb, mask = t_smx.encode_speech(self.tp, TC, torch.from_numpy(wav),
                                        torch.from_numpy(lens))
        enc = t_s2s.encode(self.tp["nlp"], TC.decoder, inputs_embeds=emb,
                           attention_mask=mask)["last_hidden_state"]
        self.jnlp = jax.tree_util.tree_map(jnp.asarray, tree["nlp"])
        self.enc = jnp.asarray(enc.numpy())
        self.mask = jnp.asarray(mask.numpy())

    def port(self, max_length=L, **kw):
        return t_gen.generate(self.tp, TC, self.wav, self.lens,
                              max_length=max_length, device="cpu", **kw)

    def jax(self, fn, tile=1):
        rep = lambda x: jnp.repeat(x, tile, axis=0)  # noqa: E731
        return fn(self.jnlp, rep(self.enc), rep(self.mask))


@pytest.fixture(scope="module")
def case(setup):
    return Case(*setup)


def _eos_biased(setup, bias):
    tree, wav, lens = setup
    fb = np.array(tree["nlp"]["final_logits_bias"], np.float32)
    fb[..., JC.decoder.eos_token_id] = bias
    return Case(_with_nlp(tree, final_logits_bias=fb), wav, lens)


def _assert_out(out, ref, scores=True):
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    if scores:
        got, want = out[2].numpy(), np.asarray(ref[2])
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# JAX's draws
# ---------------------------------------------------------------------------

def _jax_gumbel(key):
    """The noise of jax.random.categorical(fold_in(key, step), logits)."""
    return lambda rng, step, shape: torch.from_numpy(np.asarray(
        jax.random.gumbel(jax.random.fold_in(key, step), tuple(shape),
                          jnp.float32)))


def _jax_beam_gumbel(key):
    """The noise of the JAX package's beam-sample step (generation.py:640)."""
    def noise(rng, step, shape):
        u = jax.random.uniform(jax.random.fold_in(key, step), tuple(shape),
                               minval=1e-20, maxval=1.0)
        return torch.from_numpy(np.asarray(-jnp.log(-jnp.log(u + 1e-20))))
    return noise


def test_jax_categorical_is_argmax_of_its_gumbel_draws():
    """The identity the sampling pins rest on: on the installed JAX,
    categorical(key, logits) is argmax(logits + gumbel(key)), also with
    -inf (filtered) logits."""
    rng = np.random.RandomState(0)
    logits = rng.randn(6, 384).astype(np.float32) * 3
    logits[:, ::3] = -np.inf
    for step in range(4):
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), step)
        want = np.asarray(jax.random.categorical(key, jnp.asarray(logits)))
        noise = np.asarray(jax.random.gumbel(key, logits.shape, jnp.float32))
        got = torch.argmax(torch.from_numpy(logits + noise), dim=-1).numpy()
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# greedy modes
# ---------------------------------------------------------------------------

SAMPLE = dict(do_sample=True, temperature=0.7, top_k=20, top_p=0.9,
              typical_p=0.95)


def test_sampled_greedy_matches_jax(case, monkeypatch):
    """temperature, top_k, top_p and typical_p, two sequences per input
    (each input tiled), the post-warp scores; JAX's draws fed in."""
    monkeypatch.setattr(t_gen, "_gumbel",
                        _jax_gumbel(jax.random.PRNGKey(SEED)))
    ref = case.jax(jax.jit(lambda n, e, m: j_gen.greedy_decode(
        n, JC.decoder, e, m, L, rng=jax.random.PRNGKey(SEED),
        output_scores=True, **SAMPLE)), tile=2)
    out = case.port(num_return_sequences=2, output_scores=True, rng=SEED,
                    **SAMPLE)
    assert out[0].shape == (4, L)
    _assert_out(out, ref)
    assert not np.array_equal(out[0][0].numpy(), out[0][1].numpy())


PROCESSORS = dict(repetition_penalty=1.3, no_repeat_ngram_size=2,
                  min_length=5, bad_words_ids=[[7], [2], [9, 11], [3, 4, 5]],
                  suppress_tokens=[12, 13], begin_suppress_tokens=[14],
                  forced_bos_token_id=20, forced_eos_token_id=21,
                  encoder_no_repeat_ngram_size=2)


def test_processors_on_greedy_match_jax(case):
    """Every processor of the stack at once, with encoder_input_ids for the
    encoder no-repeat ban; the processed scores too."""
    enc_ids = np.random.RandomState(4).randint(3, 40, size=(2, 12))
    ref = case.jax(jax.jit(lambda n, e, m: j_gen.greedy_decode(
        n, JC.decoder, e, m, L, output_scores=True,
        encoder_input_ids=jnp.asarray(enc_ids), **PROCESSORS)))
    out = case.port(output_scores=True, encoder_input_ids=enc_ids,
                    **PROCESSORS)
    _assert_out(out, ref)
    tok = out[0].numpy()
    assert (tok[:, 0] == 20).all()
    assert np.isin(tok[:, L - 1], [21, TC.decoder.pad_token_id]).all()
    assert not np.isin(tok, [7, 12, 13]).any()


def _prefix_fn(batch_id, seq):
    """Allowed next tokens: a window that moves with the batch row and the
    sequence length, and EOS after three tokens."""
    assert seq.dtype == np.int32
    assert seq[0] == TC.decoder.decoder_start_token_id
    base = 30 + 7 * batch_id + 3 * len(seq)
    allowed = list(range(base, base + 5))
    return allowed + [TC.decoder.eos_token_id] if len(seq) > 3 else allowed


def test_prefix_allowed_tokens_fn_matches_jax(case):
    ref = case.jax(jax.jit(lambda n, e, m: j_gen.greedy_decode(
        n, JC.decoder, e, m, L, prefix_allowed_tokens_fn=_prefix_fn)))
    out = case.port(prefix_allowed_tokens_fn=_prefix_fn)
    _assert_out(out, ref, scores=False)
    for row in range(2):
        seq = [TC.decoder.decoder_start_token_id]
        for t in out[0][row].tolist()[: int(out[1][row])]:
            assert t in _prefix_fn(row, np.asarray(seq, np.int32))
            seq.append(t)


def test_early_stop_matches_jax_and_the_fixed_loop(setup, monkeypatch):
    """Rows end at different steps; the loop stops one step after the last
    EOS (its flag is read _EARLY_STOP_LAG steps late) with the tokens of the
    fixed-length loop and of the JAX package's early-exit loop."""
    case, max_length = _eos_biased(setup, 0.77), 14
    ref = case.jax(jax.jit(lambda n, e, m: j_gen.greedy_decode(
        n, JC.decoder, e, m, max_length, early_stop=True)))
    fixed = case.port(max_length)
    steps = []
    decode = t_s2s.decode
    monkeypatch.setattr(t_s2s, "decode",
                        lambda *a, **k: steps.append(1) or decode(*a, **k))
    out = case.port(max_length, early_stop=True)
    _assert_out(out, ref, scores=False)
    _assert_out(out, fixed, scores=False)
    lengths = out[1].numpy()
    assert (out[0].numpy() == TC.decoder.eos_token_id).any(axis=1).all()
    assert len(set(lengths.tolist())) == 2
    assert len(steps) == lengths.max() + t_gen._EARLY_STOP_LAG - 1
    assert len(steps) < max_length


# ---------------------------------------------------------------------------
# beam modes
# ---------------------------------------------------------------------------

def test_beam_sample_matches_jax(case, monkeypatch):
    """HF beam-sample (do_sample, 3 beams) with min_length, no_repeat and a
    repetition penalty; JAX's draws fed in."""
    kw = dict(num_beams=3, num_return_sequences=2, output_scores=True,
              min_length=4, no_repeat_ngram_size=2, repetition_penalty=1.2,
              do_sample=True, temperature=0.8, top_k=8, top_p=0.95)
    monkeypatch.setattr(t_gen, "_gumbel",
                        _jax_beam_gumbel(jax.random.PRNGKey(SEED)))
    ref = case.jax(jax.jit(lambda n, e, m: j_gen.beam_search(
        n, JC.decoder, e, m, L, rng=jax.random.PRNGKey(SEED), **kw)))
    _assert_out(case.port(rng=SEED, **kw), ref)


GROUP = dict(num_beams=4, num_beam_groups=2, diversity_penalty=0.5,
             num_return_sequences=2, output_scores=True, length_penalty=0.8,
             bad_words_ids=[[7], [9, 11]], suppress_tokens=[12])


def _group_prefix_fn(batch_id, seq):
    return list(range(20 + 5 * batch_id, 60)) + [TC.decoder.eos_token_id]


@functools.lru_cache(maxsize=None)
def _jax_group():
    return jax.jit(lambda n, e, m: j_gen.group_beam_search(
        n, JC.decoder, e, m, L, prefix_allowed_tokens_fn=_group_prefix_fn,
        **GROUP))


@functools.lru_cache(maxsize=None)
def _jax_constrained(kv_int8):
    return jax.jit(lambda n, e, m: j_gen.constrained_beam_search(
        n, JC.decoder, e, m, L, WORDS, num_beams=4, num_return_sequences=2,
        output_scores=True, kv_int8=kv_int8, no_repeat_ngram_size=3))


def test_group_beam_matches_jax(case):
    """Two groups of two beams, the Hamming penalty, processors and a prefix
    function whose batch_id counts kg = 2 rows per input."""
    out = case.port(prefix_allowed_tokens_fn=_group_prefix_fn, **GROUP)
    _assert_out(out, case.jax(_jax_group()))
    assert out[0].shape == (4, L)


def _has_constraints(seq):
    seq = list(seq)
    phrase = any(seq[i: i + 2] == [40, 41] for i in range(len(seq) - 1))
    return phrase and (50 in seq or any(seq[i: i + 2] == [60, 61]
                                        for i in range(len(seq) - 1)))


def _each_input_has_a_constrained_output(tokens, nret=2):
    """An input with fewer complete beams than nret at max_length also
    returns incomplete ones (HF's finalize), so only one is required."""
    rows = tokens.reshape(-1, nret, tokens.shape[-1]).tolist()
    assert all(any(_has_constraints(s) for s in per_input)
               for per_input in rows)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_constrained_beam_matches_jax(case, kv_int8):
    out = case.port(num_beams=4, num_return_sequences=2, output_scores=True,
                    kv_int8=kv_int8, no_repeat_ngram_size=3,
                    force_words_ids=WORDS)
    _assert_out(out, case.jax(_jax_constrained(kv_int8)))
    _each_input_has_a_constrained_output(out[0])


@pytest.fixture(scope="module")
def tied(setup):
    """Logits tied on purpose: with the token embeddings at zero the logits
    are the final bias alone, whose entries repeat every third token, so the
    candidates of every step tie in score within and across beams."""
    tree, wav, lens = setup
    v = JC.decoder.vocab_size
    fb = -(np.arange(v) % 3).astype(np.float32)
    fb[JC.decoder.eos_token_id] = -6.0
    emb = np.zeros_like(tree["nlp"]["shared"]["embedding"])
    return Case(_with_nlp(tree, final_logits_bias=fb,
                          shared=dict(tree["nlp"]["shared"], embedding=emb)),
                wav, lens)


def test_tie_order_of_group_and_constrained_search(tied):
    """Exact score ties in every selection: the port must pick what
    jax.lax.top_k and the JAX package's stable sorts pick."""
    out = tied.port(prefix_allowed_tokens_fn=_group_prefix_fn, **GROUP)
    _assert_out(out, tied.jax(_jax_group()))
    out = tied.port(num_beams=4, num_return_sequences=2, output_scores=True,
                    no_repeat_ngram_size=3, force_words_ids=WORDS)
    _assert_out(out, tied.jax(_jax_constrained(False)))
    _each_input_has_a_constrained_output(out[0])


# ---------------------------------------------------------------------------
# generate() end to end and its surface
# ---------------------------------------------------------------------------

def test_generate_end_to_end_matches_jax_generate(setup, monkeypatch):
    """The JAX generate() itself: sampling with two sequences per input,
    the processors and the draws of rng=SEED."""
    tree, wav, lens = setup
    kw = dict(max_length=L, num_return_sequences=2, no_repeat_ngram_size=2,
              min_length=3, **SAMPLE)
    ref = j_gen.generate(jax.tree_util.tree_map(jnp.asarray, tree), JC,
                         jnp.asarray(wav), jnp.asarray(lens),
                         rng=jax.random.PRNGKey(SEED), **kw)
    monkeypatch.setattr(t_gen, "_gumbel",
                        _jax_gumbel(jax.random.PRNGKey(SEED)))
    out = t_gen.generate(convert.params_from_jax(tree, TC), TC, wav, lens,
                         rng=SEED, device="cpu", **kw)
    _assert_out(out, ref, scores=False)


def test_encoder_no_repeat_without_ids_warns_and_does_nothing(case):
    with pytest.warns(UserWarning, match="encoder_no_repeat_ngram_size"):
        out = case.port(encoder_no_repeat_ngram_size=2)
    _assert_out(out, case.port(), scores=False)


def test_sampling_is_reproducible_by_seed(case):
    """The port's own draws: one seed gives the same tokens, a generator is
    used as given, and another seed differs."""
    kw = dict(do_sample=True, temperature=2.0)
    a, b = case.port(rng=5, **kw), case.port(rng=5, **kw)
    _assert_out(a, b, scores=False)
    c = case.port(rng=torch.Generator().manual_seed(5), **kw)
    _assert_out(a, c, scores=False)
    assert not np.array_equal(a[0].numpy(), case.port(rng=6, **kw)[0].numpy())
