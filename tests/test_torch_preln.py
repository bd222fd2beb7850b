"""The pre-LN ("stable layer norm") speech encoder of the port against the
JAX package, float32 on the CPU: tiny-speech with the -large presets'
switches (pre-LN layers, LayerNorm in every extractor layer, conv biases).
last_hidden_state and every hidden_states entry (the last one after the
encoder LayerNorm, as HF's Wav2Vec2EncoderStableLayerNorm appends it), the
training forward with the weighted sum on, greedy generate token-exact, and
one Adafactor train step.

Tolerances: hidden states, loss and logits 1e-4 absolute; the train step as
test_torch_adafactor.py holds it.  With the row gate lowered to 1 every
pre-LN FFN runs ffn_fused_trainable (K9 forward, K8 backward; their plain
versions on the CPU) and the text model's blocks their kernels' functions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechmix_tpu import config as jcfg
from speechmix_tpu import generation as j_gen
from speechmix_tpu.models import speech_encoder as j_se
from speechmix_tpu.models import speechmix as j_smx
from speechmix_tpu.training import trainer as j_trainer
from speechmix_tpu_torch import config as tcfg
from speechmix_tpu_torch import convert
from speechmix_tpu_torch import generation as t_gen
from speechmix_tpu_torch.models import speech_encoder as t_se
from speechmix_tpu_torch.models import speechmix as t_smx
from speechmix_tpu_torch.ops import layers as t_layers
from speechmix_tpu_torch.training import trainer as t_trainer
from test_torch_adafactor import _assert_params_close
from test_torch_slice import _tree as _generate_tree
from test_torch_train import LR, _batch, _j, _t_batch, _tree
from torch_threads import one_torch_thread  # noqa: F401


def _cfgs(weighted_sum=True, extractor_impl="auto", num_layers=2):
    def build(mod, impl):
        enc = dataclasses.replace(
            mod.SPEECH_ENCODER_PRESETS["tiny-speech"], num_layers=num_layers,
            do_stable_layer_norm=True, feat_extract_norm="layer",
            conv_bias=True, extractor_impl=impl)
        return mod.SpeechMixConfig(
            encoder=enc, decoder=mod.SEQ2SEQ_PRESETS["tiny-bart-bytes"],
            down_scale=2, weighted_sum=weighted_sum)
    return build(jcfg, "auto"), build(tcfg, extractor_impl)


def _weights_sum(tree, n):
    """A weighted sum that is not uniform, so each entry counts."""
    return dict(tree, weights_sum=np.linspace(-1.0, 1.0, n).astype(
        np.float32))


@pytest.mark.parametrize("extractor_impl", ["conv", "fused"])
def test_hidden_states_match_jax(extractor_impl):
    jc, tc = _cfgs(extractor_impl=extractor_impl)
    tree, batch = _tree(jc), _batch()
    ref = j_se.speech_encoder_apply(
        _j(tree["speech_encoder"]), jc.encoder,
        jnp.asarray(batch["input_values"]), jnp.asarray(batch["lengths"]),
        output_hidden_states=True)
    tb = _t_batch(batch)
    out = t_se.speech_encoder_apply(
        convert.params_from_jax(tree, tc)["speech_encoder"], tc.encoder,
        tb["input_values"], tb["lengths"], output_hidden_states=True)
    hidden = out["hidden_states"]
    assert hidden.shape == (3,) + tuple(out["last_hidden_state"].shape)
    np.testing.assert_allclose(out["last_hidden_state"].numpy(),
                               np.asarray(ref["last_hidden_state"]), rtol=0,
                               atol=1e-4)
    for i in range(hidden.shape[0]):
        np.testing.assert_allclose(hidden[i].numpy(),
                                   np.asarray(ref["hidden_states"][i]),
                                   rtol=0, atol=1e-4, err_msg=f"entry {i}")
    # the last entry is the state after the encoder LayerNorm
    assert torch.equal(hidden[-1], out["last_hidden_state"])
    np.testing.assert_array_equal(out["frame_lengths"].numpy(),
                                  np.asarray(ref["frame_lengths"]))


def test_forward_with_weighted_sum_matches_jax():
    jc, tc = _cfgs()
    tree, batch = _weights_sum(_tree(jc), jc.num_weighted_sum), _batch()
    ref = j_smx.speechmix_forward(
        _j(tree), jc, jnp.asarray(batch["input_values"]),
        jnp.asarray(batch["lengths"]), labels=jnp.asarray(batch["labels"]))
    tb = _t_batch(batch)
    out = t_smx.speechmix_forward(
        convert.params_from_jax(tree, tc), tc, tb["input_values"],
        tb["lengths"], labels=tb["labels"])
    np.testing.assert_allclose(out["logits"].numpy(),
                               np.asarray(ref["logits"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(out["loss"].item(), float(ref["loss"]),
                               rtol=0, atol=1e-4)


def test_greedy_generate_token_exact():
    jc, tc = _cfgs(weighted_sum=False, num_layers=4)
    tree = _generate_tree(jc, 0.3, seed=2)
    rng = np.random.RandomState(0)
    wav = (rng.randn(2, 16000) * 0.1).astype(np.float32)
    wav[1, 11000:] = 0.0
    lens = np.array([16000, 11000], np.int32)
    ref_tok, ref_len = j_gen.generate(
        jax.tree_util.tree_map(jnp.asarray, tree), jc, jnp.asarray(wav),
        jnp.asarray(lens), max_length=16)
    tok, length = t_gen.generate(convert.params_from_jax(tree, tc), tc, wav,
                                 lens, max_length=16, device="cpu")
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_array_equal(length.numpy(), np.asarray(ref_len))
    assert len(set(map(tuple, tok.tolist()))) == 2   # the input matters


@pytest.mark.parametrize("min_rows", [1024, 1],
                         ids=["plain-chain", "kernel-functions"])
def test_train_step_matches_jax(min_rows, monkeypatch):
    """One Adafactor step, gradient accumulation 2, weighted sum on."""
    monkeypatch.setattr(t_layers, "FUSED_MIN_ROWS", min_rows)
    monkeypatch.setattr(t_layers, "FUSED_WIDTH", 1)
    jc, tc = _cfgs()
    tree = _weights_sum(_tree(jc), jc.num_weighted_sum)
    batch = _batch()
    kw = dict(learning_rate=LR, warmup_steps=0, max_grad_norm=1.0,
              grad_accum=2, dropout=False)
    j_tc = j_trainer.TrainConfig(use_flash=False, **kw)
    t_tc = t_trainer.TrainConfig(**kw)
    j_params = _j(tree)
    j_state = j_trainer.TrainState(
        j_params, j_trainer.make_optimizer(j_tc).init(j_params),
        jnp.zeros((), jnp.int32))
    j_state, j_metrics = j_trainer.make_train_step(jc, j_tc, j_params)(
        j_state, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.float32(0.0))
    params = convert.params_from_jax(tree, tc)
    t_state = t_trainer.TrainState(
        params, t_trainer.make_optimizer(t_tc).init(params), 0)
    t_state, t_metrics = t_trainer.make_train_step(
        tc, t_tc, params, device="cpu")(t_state, _t_batch(batch))
    for name in ("loss", "grad_norm"):
        ref = float(j_metrics[name])
        assert abs(t_metrics[name].item() - ref) <= 1e-4 * abs(ref) + 1e-6, \
            (name, t_metrics[name].item(), ref)
    _assert_params_close(t_state.params, j_state.params, 1)
