"""Per-module parity of the PyTorch port against the JAX package, float32 on
the CPU, at the tiny-speech + tiny-bart-bytes presets.

Both sides get the same numpy inputs; the JAX parameters are converted with
speechmix_tpu_torch.convert.params_from_jax.  The JAX side runs its XLA path
(use_flash=False); the port runs on the CPU, so its kernel wrappers run their
plain versions.  Tolerance: 1e-4 abs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechmix_tpu import config as jcfg
from speechmix_tpu.models import seq2seq as j_s2s
from speechmix_tpu.models import speech_encoder as j_se
from speechmix_tpu.models import speechmix as j_smx
from speechmix_tpu.ops import layers as j_layers
from speechmix_tpu_torch import config as tcfg
from speechmix_tpu_torch import convert
from speechmix_tpu_torch.models import seq2seq as t_s2s
from speechmix_tpu_torch.models import speech_encoder as t_se
from speechmix_tpu_torch.models import speechmix as t_smx
from speechmix_tpu_torch.ops import layers as t_layers
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-4


def _cfgs(**kw):
    j = jcfg.SpeechMixConfig(
        encoder=jcfg.SPEECH_ENCODER_PRESETS["tiny-speech"],
        decoder=jcfg.SEQ2SEQ_PRESETS["tiny-bart-bytes"], down_scale=2, **kw)
    t = tcfg.SpeechMixConfig(
        encoder=tcfg.SPEECH_ENCODER_PRESETS["tiny-speech"],
        decoder=tcfg.SEQ2SEQ_PRESETS["tiny-bart-bytes"], down_scale=2, **kw)
    return j, t


def _models(**kw):
    jc, tc = _cfgs(**kw)
    params = j_smx.init_speechmix(jax.random.PRNGKey(0), jc)
    tree = jax.tree_util.tree_map(np.asarray, params)
    if "weights_sum" in tree:
        tree["weights_sum"] = np.random.RandomState(3).randn(
            *tree["weights_sum"].shape).astype(np.float32)
        params = jax.tree_util.tree_map(jnp.asarray, tree)
    return jc, tc, params, convert.params_from_jax(tree, tc)


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.fixture(scope="module")
def wave():
    rng = np.random.RandomState(0)
    wav = (rng.randn(2, 16000) * 0.1).astype(np.float32)
    wav[1, 11000:] = 0.0
    return wav, np.array([16000, 11000], np.int32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0,
                               atol=atol)


def test_extract_features(models, wave):
    jc, tc, jp, tp = models
    wav, lens = wave
    ref = j_se.extract_features(jp["speech_encoder"], jc.encoder,
                                jnp.asarray(wav), jnp.asarray(lens))
    out = t_se.extract_features(tp["speech_encoder"], tc.encoder,
                                torch.from_numpy(wav),
                                torch.from_numpy(lens))
    _close(out, ref)


def test_speech_encoder_apply_hidden_states(models, wave):
    jc, tc, jp, tp = models
    wav, lens = wave
    ref = j_se.speech_encoder_apply(jp["speech_encoder"], jc.encoder,
                                    jnp.asarray(wav), jnp.asarray(lens),
                                    output_hidden_states=True)
    out = t_se.speech_encoder_apply(tp["speech_encoder"], tc.encoder,
                                    torch.from_numpy(wav),
                                    torch.from_numpy(lens),
                                    output_hidden_states=True)
    _close(out["last_hidden_state"], ref["last_hidden_state"])
    _close(out["hidden_states"], ref["hidden_states"])
    assert out["hidden_states"].shape[0] == jc.encoder.num_layers + 1
    np.testing.assert_array_equal(out["frame_lengths"].numpy(),
                                  np.asarray(ref["frame_lengths"]))
    np.testing.assert_array_equal(out["frame_mask"].numpy(),
                                  np.asarray(ref["frame_mask"]))


def test_truncate_layers(models):
    jc, tc, jp, tp = models
    out = t_se.truncate_layers(tp["speech_encoder"], 2)
    assert len(out["layers"]) == 2
    assert len(tp["speech_encoder"]["layers"]) == jc.encoder.num_layers


@pytest.mark.parametrize("variant", ["plain", "weighted_hf",
                                     "weighted_s3prl", "prompt"])
def test_encode_speech(variant, wave):
    kw = {}
    if variant.startswith("weighted"):
        kw = dict(weighted_sum=True,
                  weighted_sum_convention=variant.split("_")[1])
    jc, tc, jp, tp = _models(**kw)
    wav, lens = wave
    prompt = (np.array([5, 9, 77], np.int32) if variant == "prompt"
              else None)
    ref_h, ref_m, _ = j_smx.encode_speech(
        jp, jc, jnp.asarray(wav), jnp.asarray(lens),
        None if prompt is None else jnp.asarray(prompt))
    h, m = t_smx.encode_speech(
        tp, tc, torch.from_numpy(wav), torch.from_numpy(lens),
        None if prompt is None else torch.from_numpy(prompt))
    _close(h, ref_h)
    np.testing.assert_array_equal(m.numpy(), np.asarray(ref_m))


def _text_inputs(models, wave):
    jc, tc, jp, tp = models
    wav, lens = wave
    h, m, _ = j_smx.encode_speech(jp, jc, jnp.asarray(wav),
                                  jnp.asarray(lens))
    return np.array(h), np.array(m)


def test_seq2seq_encode(models, wave):
    jc, tc, jp, tp = models
    h, m = _text_inputs(models, wave)
    ref = j_s2s.encode(jp["nlp"], jc.decoder, inputs_embeds=jnp.asarray(h),
                       attention_mask=jnp.asarray(m),
                       output_hidden_states=True)
    out = t_s2s.encode(tp["nlp"], tc.decoder,
                       inputs_embeds=torch.from_numpy(h),
                       attention_mask=torch.from_numpy(m),
                       output_hidden_states=True)
    _close(out["last_hidden_state"], ref["last_hidden_state"])
    _close(out["hidden_states"], ref["hidden_states"])


def test_cached_decode_steps(models, wave):
    """Two cached single-token steps: logits, self K/V cache and cross K/V
    (the JAX package stores cross K/V batch-minor; the port (L, B, T, H, D))."""
    jc, tc, jp, tp = models
    h, m = _text_inputs(models, wave)
    cap = 6
    jcache = j_s2s.init_decoder_cache(jp["nlp"], jc.decoder, jnp.asarray(h),
                                      2, cap)
    tcache = t_s2s.init_decoder_cache(tp["nlp"], tc.decoder,
                                      torch.from_numpy(h), 2, cap)
    _close(tcache.cross_k, np.transpose(np.asarray(jcache.cross_k),
                                        (0, 4, 1, 2, 3)))
    _close(tcache.cross_v, np.transpose(np.asarray(jcache.cross_v),
                                        (0, 4, 1, 2, 3)))
    for ids in ([[2], [2]], [[40], [7]]):
        ids = np.array(ids, np.int32)
        jo = j_s2s.decode(jp["nlp"], jc.decoder, jnp.asarray(ids),
                          encoder_mask=jnp.asarray(m), cache=jcache)
        to = t_s2s.decode(tp["nlp"], tc.decoder, torch.from_numpy(ids),
                          torch.from_numpy(m), tcache)
        jcache, tcache = jo["cache"], to["cache"]
        _close(to["logits"], jo["logits"])
        _close(tcache.self_kv.key, jcache.self_kv.key)
        _close(tcache.self_kv.value, jcache.self_kv.value)
        assert tcache.self_kv.index == int(jcache.self_kv.index)


@pytest.mark.parametrize("block", ["ffn", "dense"])
def test_residual_ln_blocks_at_kernel_rows(block):
    """Blocks of >= 1024 rows take the fused-kernel dispatch (the plain
    version of K3 / K2 on the CPU); they match the JAX XLA chain."""
    rng = np.random.RandomState(4)
    b, t, h, f = 2, 520, 128, 256
    mk = lambda *s, sc=0.1: (rng.randn(*s) * sc).astype(np.float32)
    p1 = {"kernel": mk(h, f), "bias": mk(f)}
    p2 = {"kernel": mk(f, h), "bias": mk(h)}
    p_ln = {"scale": 1.0 + mk(h), "bias": mk(h)}
    x, res = mk(b, t, h, sc=1.0), mk(b, t, h, sc=1.0)
    jt = lambda p: jax.tree_util.tree_map(jnp.asarray, p)
    tt = lambda p: {k: torch.from_numpy(v) for k, v in p.items()}
    if block == "ffn":
        ref = j_layers.ffn_residual_ln_apply(
            jt(p1), jt(p2), jt(p_ln), jnp.asarray(x), "gelu", jnp.float32)
        out = t_layers.ffn_residual_ln_apply(
            tt(p1), tt(p2), tt(p_ln), torch.from_numpy(x), "gelu",
            torch.float32)
    else:
        ref = j_layers.dense_residual_ln_apply(
            jt(p2), jt(p_ln), jnp.asarray(np.tile(x, 2)), jnp.asarray(res),
            jnp.float32)
        out = t_layers.dense_residual_ln_apply(
            tt(p2), tt(p_ln), torch.from_numpy(np.tile(x, 2)),
            torch.from_numpy(res), torch.float32)
    _close(out, ref)


def test_config_copy_matches_jax():
    """The port's config classes and presets equal the JAX package's."""
    for name in ("wav2vec2-base", "tiny-speech"):
        assert dataclasses.asdict(tcfg.SPEECH_ENCODER_PRESETS[name]) == \
            dataclasses.asdict(jcfg.SPEECH_ENCODER_PRESETS[name])
    for name in ("bart-base", "tiny-bart-bytes"):
        assert dataclasses.asdict(tcfg.SEQ2SEQ_PRESETS[name]) == \
            dataclasses.asdict(jcfg.SEQ2SEQ_PRESETS[name])
    jc, tc = _cfgs()
    assert tc.downloop == jc.downloop
    assert tc.encoder.aligned_samples(256000) == \
        jc.encoder.aligned_samples(256000)
    n = np.array([16000, 11000])
    np.testing.assert_array_equal(tc.encoder.feature_lengths(n),
                                  jc.encoder.feature_lengths(n))
