"""generate() of SpeechMix with a T5 / ByT5 decoder family, the port
against the JAX package in float32 on the CPU: greedy, greedy with int8
cross K/V and beam-4 token-exact (beam scores within 1e-5), and, port only,
the other modes with T5's token ids (pad 0, eos 1, start 0).

Configurations as in test_torch_t5, the matrices redrawn at std 0.2 so
that the tokens depend on the input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechmix_tpu import generation as j_gen
from speechmix_tpu_torch import convert
from speechmix_tpu_torch import generation as t_gen
from test_torch_t5 import smx_cfgs, smx_tree
from test_torch_train import _j
from torch_threads import one_torch_thread  # noqa: F401

MAX_LEN = 10


def _redraw(tree, std, seed=2):
    """The matrices of a tree redrawn at `std` (position tables kept)."""
    rng = np.random.RandomState(seed)

    def redraw(path, a):
        name = jax.tree_util.keystr(path)
        if a.ndim >= 2 and "layer_norm" not in name and "rel_bias" not in name:
            return (rng.randn(*a.shape) * std).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(redraw, tree)


@pytest.fixture(scope="module", params=["t5", "byt5"])
def gen_setup(request):
    jc, tc = smx_cfgs(request.param)
    tree = _redraw(smx_tree(jc), 0.2)
    rng = np.random.RandomState(0)
    wav = (rng.randn(2, 16000) * 0.1).astype(np.float32)
    wav[1, 11000:] = 0.0
    lens = np.array([16000, 11000], np.int32)
    return jc, tc, _j(tree), convert.params_from_jax(tree, tc), wav, lens


@pytest.mark.parametrize("kw", [
    dict(),
    dict(kv_int8=True),
    dict(num_beams=4, num_return_sequences=2, output_scores=True),
], ids=["greedy", "greedy-int8", "beam-4"])
def test_generate_matches_jax(gen_setup, kw):
    jc, tc, jp, tp, wav, lens = gen_setup
    ref = j_gen.generate(jp, jc, jnp.asarray(wav), jnp.asarray(lens),
                         max_length=MAX_LEN, **kw)
    out = t_gen.generate(tp, tc, wav, lens, max_length=MAX_LEN,
                         device="cpu", **kw)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    if "output_scores" in kw:
        np.testing.assert_allclose(out[2].numpy(), np.asarray(ref[2]),
                                   rtol=0, atol=1e-5)
    # the tokens depend on the speech: not one sequence for both inputs
    assert not torch.equal(out[0][0], out[0][-1])


@pytest.mark.parametrize("kw", [
    dict(do_sample=True, temperature=0.7, top_k=20, top_p=0.9, rng=3),
    dict(repetition_penalty=1.3, no_repeat_ngram_size=2, min_length=4,
         bad_words_ids=[[7], [8, 9]], suppress_tokens=[10],
         begin_suppress_tokens=[1], forced_eos_token_id=1),
    dict(early_stop=True),
    dict(num_beams=4, num_beam_groups=2, diversity_penalty=0.5,
         num_return_sequences=2),
    dict(num_beams=4, force_words_ids=[[40, 41]]),
    dict(num_beams=4, do_sample=True, top_k=20, rng=5),
], ids=["sample", "processors", "early-stop", "group-beam", "constrained",
        "beam-sample"])
def test_generate_modes_run_with_t5_ids(gen_setup, kw):
    """Every other mode with T5's ids: each row ends in EOS (1) or runs to
    max_length, pad (0) only after its EOS, lengths counting the rest."""
    _, tc, _, tp, wav, lens = gen_setup
    tok, length = t_gen.generate(tp, tc, wav, lens, max_length=MAX_LEN,
                                 device="cpu", **kw)[:2]
    assert tok.shape == (2 * kw.get("num_return_sequences", 1), MAX_LEN)
    for row, n in zip(tok.tolist(), length.tolist()):
        assert all(t != 0 for t in row[:n]) and all(t == 0 for t in row[n:])
        assert 1 not in row[:n - 1]
    if "force_words_ids" in kw:
        for row in tok.tolist():
            assert any(row[i:i + 2] == [40, 41] for i in range(MAX_LEN - 1))
