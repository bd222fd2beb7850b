"""The port's greedy generate end to end against the JAX package's, on the
tiny presets with two utterances of different lengths: tokens and lengths
must be exact.  float32 on the CPU; the JAX side runs its XLA path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from speechmix_tpu import config as jcfg
from speechmix_tpu import generation as j_gen
from speechmix_tpu.models import speechmix as j_smx
from speechmix_tpu_torch import config as tcfg
from speechmix_tpu_torch import convert
from speechmix_tpu_torch import generation as t_gen
from torch_threads import one_torch_thread  # noqa: F401


def _tree(jc, weight_std, seed):
    """JAX init, with matrices redrawn at `weight_std` and the decoder's
    position table at 3.0 so the greedy output depends on the input."""
    tree = jax.tree_util.tree_map(
        np.asarray, j_smx.init_speechmix(jax.random.PRNGKey(0), jc))
    rng = np.random.RandomState(seed)

    def redraw(path, a):
        name = jax.tree_util.keystr(path)
        if "decoder" in name and "embed_positions" in name:
            return (rng.randn(*a.shape) * 3.0).astype(np.float32)
        if a.ndim >= 2 and "layer_norm" not in name:
            return (rng.randn(*a.shape) * weight_std).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(redraw, tree)


@pytest.mark.parametrize("weight_std,prompt", [(0.3, False), (0.02, True)])
def test_generate_token_exact(weight_std, prompt):
    jc = jcfg.SpeechMixConfig(
        encoder=jcfg.SPEECH_ENCODER_PRESETS["tiny-speech"],
        decoder=jcfg.SEQ2SEQ_PRESETS["tiny-bart-bytes"], down_scale=2)
    tc = tcfg.SpeechMixConfig(
        encoder=tcfg.SPEECH_ENCODER_PRESETS["tiny-speech"],
        decoder=tcfg.SEQ2SEQ_PRESETS["tiny-bart-bytes"], down_scale=2)
    tree = _tree(jc, weight_std, seed=1)
    rng = np.random.RandomState(0)
    wav = (rng.randn(2, 16000) * 0.1).astype(np.float32)
    wav[1, 11000:] = 0.0
    lens = np.array([16000, 11000], np.int32)
    prompt_ids = np.array([5, 9, 77], np.int32) if prompt else None

    ref_tok, ref_len = j_gen.generate(
        jax.tree_util.tree_map(jnp.asarray, tree), jc, jnp.asarray(wav),
        jnp.asarray(lens),
        None if prompt_ids is None else jnp.asarray(prompt_ids),
        max_length=20)
    tok, length = t_gen.generate(convert.params_from_jax(tree, tc), tc, wav,
                                 lens, prompt_ids, max_length=20,
                                 device="cpu")
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_array_equal(length.numpy(), np.asarray(ref_len))
    assert tok.shape == (2, 20)
