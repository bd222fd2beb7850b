"""The port's twelve API classes against speechmix_tpu.api, on the CPU in
float32: construction and bookkeeping of every class, forward (logits, loss,
predictions, model details) and generate (greedy, beam with scores, the dict
forms) on the same weights, save_pretrained / from_pretrained both ways
between the packages, and the reference-checkpoint paths
(export_reference_state_dict -> from_reference_checkpoint, and
load_hf_checkpoint from separate backbone files)."""

import ast
import dataclasses
import json
import os
import pathlib

import jax
import numpy as np
import pytest
import torch

import speechmix_tpu
import speechmix_tpu_torch
from speechmix_tpu_torch import api as t_api
from speechmix_tpu_torch import convert
from chip_smoke import hf_config_dicts
from speechmix_tpu_torch.training.freezing import tree_paths
from test_torch_slice import _tree
from torch_threads import one_torch_thread  # noqa: F401

CLASSES = ["SpeechMixEED", "HFSpeechMixEED", "SpeechMixED", "HFSpeechMixED",
           "SpeechMixFixed", "HFSpeechMixFixed", "SpeechMixAdapter",
           "HFSpeechMixAdapter", "SpeechMixSelf", "HFSpeechMixSelf",
           "SpeechMixGAN", "HFSpeechMixGAN"]


def _make(pkg, cls_name, **kw):
    kw.setdefault("speech_model_config", "tiny-speech")
    kw.setdefault("nlp_model_config", "tiny-bart-bytes")
    if pkg is speechmix_tpu_torch:
        kw.setdefault("device", "cpu")
    return getattr(pkg, cls_name)(**kw)


def _jax_path(path):
    """A port path in the JAX tree: the index of a stacked layer dropped
    (the transformer stacks and the adapters)."""
    parts = path.split("/")
    return "/".join(
        p for i, p in enumerate(parts)
        if not (p.isdigit() and "feature_extractor" not in parts and
                (parts[i - 1] == "layers" or parts[0] == "adapters")))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _same_weights(j_model, t_model, seed=1):
    """The JAX model's weights redrawn (tests/test_torch_slice.py's _tree),
    loaded into both."""
    tree = _tree(j_model.config, 0.3, seed)
    j_model.params = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    t_model.params = convert.params_from_jax(tree, t_model.config)


def test_no_module_imports_transformers_or_safetensors_at_import():
    """The card has neither package: the port imports them only inside the
    functions that need them."""
    root = pathlib.Path(speechmix_tpu_torch.__file__).parent
    for path in sorted(root.rglob("*.py")):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in (
                    "transformers", "safetensors"), f"{path} imports {name}"


def test_the_twelve_names_are_exported():
    assert speechmix_tpu_torch._API_NAMES == set(CLASSES)
    for name in CLASSES:
        assert getattr(speechmix_tpu_torch, name) is getattr(t_api, name)
    with pytest.raises(AttributeError):
        speechmix_tpu_torch.NotAClass


@pytest.mark.parametrize("cls_name", CLASSES)
def test_construction_and_bookkeeping_match_jax(cls_name):
    kw = dict(share_layer_ratio=0.5, down_scale=4, weighted_sum=True)
    if "Fixed" in cls_name:
        kw.update(fixed_speech=True, fixed_nlp=False)
    if cls_name.endswith("EED"):
        kw["fixed_parameters"] = True
    j = _make(speechmix_tpu, cls_name, **kw)
    t = _make(speechmix_tpu_torch, cls_name, **kw)
    assert dataclasses.asdict(t.config) == dataclasses.asdict(j.config)
    assert t.speech_encoder_layer == j.speech_encoder_layer == 2
    assert t.nlp_encoder_layer == j.nlp_encoder_layer
    assert tuple(t.weights_sum.shape) == tuple(j.weights_sum.shape)
    # the same tensors trainable, each port layer named by its index
    assert {_jax_path(p) for p in t.list_grad} == set(j.list_grad)
    assert {_jax_path(p) for p in t.list_no_grad} == set(j.list_no_grad)
    want_shapes = {jax.tree_util.keystr(kp, simple=True, separator="/"):
                   tuple(v.shape) for kp, v in
                   jax.tree_util.tree_flatten_with_path(j.params)[0]}
    got = convert.tree_to_jax_layout(t.params)
    got_shapes = {p: tuple(v.shape) for p, v in
                  convert.flatten_with_paths(got)}
    assert got_shapes == want_shapes


def test_the_card_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        speechmix_tpu_torch.SpeechMixEED("tiny-speech", "tiny-bart-bytes")


@pytest.mark.parametrize("cls_name,kw", [
    ("HFSpeechMixEED", dict(share_layer_ratio=0.5, down_scale=4,
                            weighted_sum=True)),
    ("SpeechMixED", dict())])
def test_forward_matches_jax(cls_name, kw):
    j = _make(speechmix_tpu, cls_name, **kw)
    t = _make(speechmix_tpu_torch, cls_name, **kw)
    _same_weights(j, t)
    rng = np.random.RandomState(0)
    wavs = [rng.randn(16000).astype(np.float32) * 0.1,
            rng.randn(11000).astype(np.float32) * 0.1]
    labels = np.array([t.tokenizer.encode("hello"),
                       t.tokenizer.encode("world")])
    want = j(wavs, labels=labels, return_model_detail=True,
             decoder_text_prompt="hi")
    got = t(wavs, labels=labels, return_model_detail=True,
            decoder_text_prompt="hi")
    assert sorted(got) == sorted(want)
    ref = np.asarray(want["logits"])
    np.testing.assert_allclose(got["logits"].numpy(), ref, rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got["predictions"].numpy(),
                                  np.asarray(want["predictions"]))
    for key in ("shape_before_length_adapter",
                "shape_before_enc_dec_projector",
                "shape_after_enc_dec_projector"):
        assert tuple(got[key]) == tuple(want[key])
    if "weighted_sum" in want:
        np.testing.assert_allclose(got["weighted_sum"].numpy(),
                                   np.asarray(want["weighted_sum"]),
                                   rtol=1e-6)


@pytest.mark.parametrize("kwargs", [
    dict(max_new_tokens=8, decoder_text_prompt="ab", kv_int8=True),
    dict(max_length=10, num_beams=3, num_return_sequences=2,
         output_scores=True),
    dict(max_length=10, output_scores=True, return_dict_in_generate=True,
         no_repeat_ngram_size=2, encoder_input_ids=[5, 6, 7],
         encoder_no_repeat_ngram_size=2)])
def test_generate_matches_jax(kwargs):
    j = _make(speechmix_tpu, "SpeechMixEED", down_scale=2)
    t = _make(speechmix_tpu_torch, "SpeechMixEED", down_scale=2)
    _same_weights(j, t)
    rng = np.random.RandomState(2)
    wavs = [rng.randn(12000).astype(np.float32) * 0.1,
            rng.randn(16000).astype(np.float32) * 0.1]
    want = j.generate(wavs, **kwargs)
    got = t.generate(wavs, **kwargs)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        np.testing.assert_array_equal(got["sequences"].numpy(),
                                      np.asarray(want["sequences"]))
        for key in set(want) - {"sequences"}:
            ref = np.asarray(want[key])
            scale = np.abs(ref[np.isfinite(ref)]).max()
            np.testing.assert_allclose(got[key].numpy(), ref, rtol=0,
                                       atol=1e-5 * scale)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _assert_params_equal(t_params, j_params):
    want = {jax.tree_util.keystr(kp, simple=True, separator="/"):
            np.asarray(v) for kp, v in
            jax.tree_util.tree_flatten_with_path(j_params)[0]}
    got = dict(convert.flatten_with_paths(
        convert.tree_to_jax_layout(t_params)))
    assert sorted(got) == sorted(want)
    for path, a in want.items():
        np.testing.assert_array_equal(got[path], a, err_msg=path)


def test_save_pretrained_round_trips_between_the_packages(tmp_path):
    kw = dict(down_scale=4, fixed_speech=True, fixed_nlp=False)
    j = _make(speechmix_tpu, "SpeechMixFixed", **kw)
    t = _make(speechmix_tpu_torch, "SpeechMixFixed", **kw)
    _same_weights(j, t, seed=3)
    # JAX writes, the port reads
    j.save_pretrained(str(tmp_path / "jax"))
    t2 = t_api.SpeechMixFixed.from_pretrained(str(tmp_path / "jax"),
                                              device="cpu")
    _assert_params_equal(t2.params, j.params)
    assert t2.list_no_grad == t.list_no_grad and t2.list_grad == t.list_grad
    assert dataclasses.asdict(t2.config) == dataclasses.asdict(j.config)
    # the port writes, JAX reads
    t.save_pretrained(str(tmp_path / "port"))
    assert json.load(open(tmp_path / "port" / "model_kwargs.json")) == \
        {"fixed_speech": True, "fixed_nlp": False}
    j2 = speechmix_tpu.SpeechMixFixed.from_pretrained(str(tmp_path / "port"))
    _assert_params_equal(t.params, j2.params)
    assert sorted(j2.list_no_grad) == sorted(j.list_no_grad)
    # load_weights into a fresh model
    t3 = _make(speechmix_tpu_torch, "SpeechMixFixed", **kw)
    t3.load_weights(str(tmp_path / "jax" / "weights.npz"))
    _assert_params_equal(t3.params, j.params)


def test_reference_checkpoint_paths(tmp_path):
    """export_reference_state_dict -> from_reference_checkpoint in the port
    and in JAX on the same directory; load_hf_checkpoint from the two
    backbones' files."""
    t = _make(speechmix_tpu_torch, "HFSpeechMixEED", down_scale=2)
    _same_weights(_make(speechmix_tpu, "HFSpeechMixEED", down_scale=2), t,
                  seed=4)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "config.json").write_text(json.dumps(hf_config_dicts(t.config)))
    sd = t.export_reference_state_dict(str(ckpt / "pytorch_model.bin"))
    assert "nlp_emb.weight" in sd and "length_adapters.0.weight" in sd
    t2 = t_api.HFSpeechMixEED.from_reference_checkpoint(
        str(ckpt), down_scale=2, device="cpu")
    j2 = speechmix_tpu.HFSpeechMixEED.from_reference_checkpoint(
        str(ckpt), down_scale=2)
    _assert_params_equal(t2.params, j2.params)
    rng = np.random.RandomState(5)
    wavs = [rng.randn(16000).astype(np.float32) * 0.1]
    np.testing.assert_array_equal(t2.generate(wavs, max_length=8).numpy(),
                                  t.generate(wavs, max_length=8).numpy())
    for name, prefix in (("speech", "encoder_model."),
                         ("nlp", "decoder_model.")):
        os.makedirs(tmp_path / name)
        torch.save({k[len(prefix):]: torch.from_numpy(v)
                    for k, v in sd.items() if k.startswith(prefix)},
                   str(tmp_path / name / "pytorch_model.bin"))
    t3 = _make(speechmix_tpu_torch, "HFSpeechMixEED", down_scale=2, seed=9)
    t3.params["enc_to_dec_proj"] = t.params["enc_to_dec_proj"]
    t3.params["length_adapter"] = t.params["length_adapter"]
    t3.load_hf_checkpoint(str(tmp_path / "speech"), str(tmp_path / "nlp"))
    _assert_params_equal(t3.params, j2.params)
    with pytest.raises(ValueError, match="composite"):
        (tmp_path / "single").mkdir()
        (tmp_path / "single" / "config.json").write_text(
            json.dumps(hf_config_dicts(t.config)["decoder"]))
        t_api.HFSpeechMixEED.from_reference_checkpoint(
            str(tmp_path / "single"), device="cpu")
