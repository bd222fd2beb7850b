"""The port's beam search against the JAX package's, on the CPU in float32:
the cache reorder (K5's plain version against the Pallas kernel in interpret
mode, exact), the tie order of the top-k selections, and generate(num_beams=4)
on the tiny presets, token-, length- and score-exact (scores within 1e-4).

Beams finish at different steps (some rows at one or two tokens, some at
max_length; in two cases the EOS logit is raised through final_logits_bias),
so the finished set, the length penalty and the early-stop heuristic all take
part.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechmix_tpu import config as jcfg
from speechmix_tpu import generation as j_gen
from speechmix_tpu.ops.pallas import beam_gather as j_bg
from speechmix_tpu_torch import config as tcfg
from speechmix_tpu_torch import convert
from speechmix_tpu_torch import generation as t_gen
from speechmix_tpu_torch.models import seq2seq as t_s2s
from speechmix_tpu_torch.ops.kernels import beam_gather as t_bg
from test_torch_slice import _tree
from torch_threads import one_torch_thread  # noqa: F401


# ---------------------------------------------------------------------------
# K5 beam gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_beam_gather_plain_matches_pallas(dtype):
    rng = np.random.RandomState(0)
    shape = (3, 8, 4, 2, 64)                 # (L, N, T, H, D)
    key = jnp.asarray(rng.randn(*shape)).astype(dtype)
    value = jnp.asarray(rng.randn(*shape)).astype(dtype)
    src = np.array([1, 1, 0, 3, 6, 5, 4, 7], np.int32)  # repeats, identity
    ref_k, ref_v = j_bg.beam_gather(key, value, jnp.asarray(src),
                                    interpret=True)
    to_t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.float32 if dtype is np.float32 else torch.bfloat16)
    out_k, out_v = t_bg.beam_gather(to_t(key), to_t(value),
                                    torch.from_numpy(src))
    assert out_k.dtype == to_t(key).dtype
    np.testing.assert_array_equal(out_k.float().numpy(),
                                  np.asarray(ref_k, np.float32))
    np.testing.assert_array_equal(out_v.float().numpy(),
                                  np.asarray(ref_v, np.float32))


def test_beam_gather_writes_into_given_buffers():
    rng = np.random.RandomState(1)
    key = torch.from_numpy(rng.randn(2, 4, 6).astype(np.float32))
    value = torch.from_numpy(rng.randn(2, 4, 6).astype(np.float32))
    src = torch.tensor([3, 0, 0, 2], dtype=torch.int32)
    spare = (torch.empty_like(key), torch.empty_like(value))
    out = t_bg.beam_gather(key, value, src, out=spare)
    assert out[0] is spare[0] and out[1] is spare[1]
    assert torch.equal(out[0], key[:, src.long()])
    assert torch.equal(out[1], value[:, src.long()])


def test_gather_cache_reorders_only_self_kv():
    rng = np.random.RandomState(2)
    mk = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    b, k = 2, 3
    self_kv = t_s2s.KVCache(mk(2, b * k, 5, 2, 4), mk(2, b * k, 5, 2, 4), 3)
    cache = t_s2s.DecoderCache(self_kv, mk(2, b, 7, 2, 4), mk(2, b, 7, 2, 4))
    spare = (torch.empty_like(self_kv.key), torch.empty_like(self_kv.value))
    idx = torch.tensor([[2, 0, 0], [1, 1, 2]])
    new, new_spare = t_gen._gather_cache(cache, idx, b, k, spare)
    flat = torch.tensor([2, 0, 0, 4, 4, 5])
    assert torch.equal(new.self_kv.key, self_kv.key[:, flat])
    assert torch.equal(new.self_kv.value, self_kv.value[:, flat])
    assert new.self_kv.index == 3
    assert new.cross_k is cache.cross_k and new.cross_v is cache.cross_v
    assert new_spare[0] is self_kv.key and new_spare[1] is self_kv.value


# ---------------------------------------------------------------------------
# tie order of the selections
# ---------------------------------------------------------------------------

def _assert_topk_equal(scores3, k2):
    ref_v, ref_i = j_gen._topk_over_beams(jnp.asarray(scores3), k2)
    out_v, out_i = t_gen._topk_over_beams(torch.from_numpy(scores3), k2)
    np.testing.assert_array_equal(out_v.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(out_i.numpy(), np.asarray(ref_i))


@pytest.mark.parametrize("b,k,v,k2", [(3, 4, 50, 8), (2, 1, 40, 2),
                                      (2, 4, 6, 8), (1, 3, 384, 6)])
def test_topk_over_beams_matches_jax(b, k, v, k2):
    rng = np.random.RandomState(3)
    _assert_topk_equal(rng.randn(b, k, v).astype(np.float32), k2)


def test_topk_over_beams_crafted_ties():
    """Equal values must come out in flat-index order, as jax.lax.top_k
    gives them: a few distinct values over many columns, the first beam
    step's collapse of beams 1.. onto exactly -1e9, and an all-equal row."""
    rng = np.random.RandomState(4)
    few = rng.randint(0, 3, size=(3, 4, 50)).astype(np.float32)
    _assert_topk_equal(few, 8)
    logp = np.log(rng.dirichlet(np.ones(50), size=(2, 4))).astype(np.float32)
    first = logp + np.array([0.0, -1e9, -1e9, -1e9], np.float32)[None, :, None]
    first[:, 0, 5:] = -1e9        # fewer live candidates than 2K
    _assert_topk_equal(first, 8)
    _assert_topk_equal(np.zeros((2, 4, 50), np.float32), 8)
    out_v, out_i = t_gen._topk_over_beams(torch.zeros(1, 4, 50), 8)
    assert out_i.tolist() == [list(range(8))]


@pytest.mark.parametrize("k", [1, 3, 5])
def test_topk_selections_prefer_the_lowest_index(k):
    x = torch.tensor([[1.0, 2.0, 2.0, -1e9, 2.0, 1.0, -1e9, 1.0]])
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(x.numpy()), k)
    for fn in (t_gen._topk_stable, t_gen._topk_lowest_index):
        vals, idx = fn(x, k)
        np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_v))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))


# ---------------------------------------------------------------------------
# generate(num_beams=4) end to end
# ---------------------------------------------------------------------------

MAX_LEN = 12


@pytest.fixture(scope="module")
def setup():
    mk = lambda m: m.SpeechMixConfig(
        encoder=m.SPEECH_ENCODER_PRESETS["tiny-speech"],
        decoder=m.SEQ2SEQ_PRESETS["tiny-bart-bytes"], down_scale=2)
    jc, tc = mk(jcfg), mk(tcfg)
    tree = _tree(jc, 0.3, seed=1)
    rng = np.random.RandomState(0)
    wav = (rng.randn(2, 16000) * 0.1).astype(np.float32)
    wav[1, 11000:] = 0.0
    lens = np.array([16000, 11000], np.int32)
    return jc, tc, tree, wav, lens


def _params(setup, eos_bias=0.0):
    jc, tc, tree, wav, lens = setup
    tree = dict(tree, nlp=dict(tree["nlp"]))
    bias = np.array(tree["nlp"]["final_logits_bias"], np.float32)
    bias[..., jc.decoder.eos_token_id] = eos_bias
    tree["nlp"]["final_logits_bias"] = bias
    return (jc, tc, jax.tree_util.tree_map(jnp.asarray, tree),
            convert.params_from_jax(tree, tc), wav, lens)


@pytest.mark.parametrize(
    "eos_bias,length_penalty,early_stopping,nret,kv_int8", [
        (0.0, 1.0, False, 2, False),
        (0.0, 2.0, True, 2, False),
        (0.0, 0.6, "never", 1, False),
        (0.0, 1.0, False, 2, True),
        (3.0, 2.0, "never", 2, False),
        (3.0, 0.6, True, 1, True),
    ])
def test_generate_beam_matches_jax(setup, eos_bias, length_penalty,
                                   early_stopping, nret, kv_int8):
    jc, tc, jp, tp, wav, lens = _params(setup, eos_bias)
    kw = dict(max_length=MAX_LEN, num_beams=4, length_penalty=length_penalty,
              early_stopping=early_stopping, num_return_sequences=nret,
              kv_int8=kv_int8, output_scores=True)
    ref_tok, ref_len, ref_sc = j_gen.generate(jp, jc, jnp.asarray(wav),
                                              jnp.asarray(lens), **kw)
    tok, length, scores = t_gen.generate(tp, tc, wav, lens, device="cpu",
                                         **kw)
    assert tok.shape == (2 * nret, MAX_LEN)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_array_equal(length.numpy(), np.asarray(ref_len))
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_sc), rtol=0,
                               atol=1e-4)
    assert np.all(np.asarray(ref_sc) > -1e8)     # every row finished


def test_generate_beam_without_scores_and_beam_one(setup):
    jc, tc, jp, tp, wav, lens = _params(setup)
    out = t_gen.generate(tp, tc, wav, lens, device="cpu", max_length=6,
                         num_beams=2)
    assert len(out) == 2 and out[0].shape == (2, 6)
    with pytest.raises(ValueError, match="must be <= num_beams"):
        t_gen.generate(tp, tc, wav, lens, device="cpu", max_length=6,
                       num_beams=2, num_return_sequences=3)
    with pytest.raises(ValueError, match="requires num_beams > 1"):
        t_gen.generate(tp, tc, wav, lens, device="cpu", max_length=6,
                       num_return_sequences=2)
