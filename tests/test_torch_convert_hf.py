"""The port's checkpoint loaders, config derivation and export against the
JAX package's, on the CPU: tiny HF models built in process from
`transformers` configs (wav2vec2, HuBERT, UniSpeechSAT, a fairseq-layout
wav2vec2, BART, T5, gated ByT5) and whole reference-layout SpeechMix state
dicts composed from them (HFSpeechMixEED, HFSpeechMixED).  Every loader's
parameters must equal params_from_jax of the JAX loader's tree bit for bit;
config_from_hf and export_speechmix must equal the JAX package's."""

import argparse
import dataclasses
import json
import re
import sys
import warnings

import jax
import numpy as np
import pytest
import torch
import transformers

from speechmix_tpu import config as jcfg
from speechmix_tpu import convert as j_convert
from speechmix_tpu_torch import config as tcfg
from speechmix_tpu_torch import convert as t_convert
from speechmix_tpu_torch.training.freezing import tree_paths
from test_torch_quantize import assert_trees_equal
from torch_threads import one_torch_thread  # noqa: F401

SPEECH_KW = dict(
    vocab_size=32, hidden_size=32, num_hidden_layers=2,
    num_attention_heads=2, intermediate_size=64, conv_dim=(16, 16, 16),
    conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=2,
    do_stable_layer_norm=False, feat_extract_norm="group")
SPEECH_MODELS = {
    "wav2vec2": (transformers.Wav2Vec2Config, transformers.Wav2Vec2Model),
    "hubert": (transformers.HubertConfig, transformers.HubertModel),
    "unispeech_sat": (transformers.UniSpeechSatConfig,
                      transformers.UniSpeechSatModel),
}


def _speech(family="wav2vec2", seed=0):
    torch.manual_seed(seed)
    config_cls, model_cls = SPEECH_MODELS[family]
    hf_cfg = config_cls(**SPEECH_KW)
    return hf_cfg, model_cls(hf_cfg).eval()


def _seq2seq(arch, seed=1):
    torch.manual_seed(seed)
    if arch == "bart":
        hf_cfg = transformers.BartConfig(
            vocab_size=128, d_model=32, encoder_layers=2, decoder_layers=2,
            encoder_attention_heads=2, decoder_attention_heads=2,
            encoder_ffn_dim=64, decoder_ffn_dim=64,
            max_position_embeddings=64, pad_token_id=1, bos_token_id=0,
            eos_token_id=2, decoder_start_token_id=2)
        return hf_cfg, transformers.BartForConditionalGeneration(hf_cfg)
    gated = arch == "byt5"
    hf_cfg = transformers.T5Config(
        vocab_size=128, d_model=32, num_layers=2, num_decoder_layers=1,
        num_heads=2, d_kv=16, d_ff=64,
        feed_forward_proj="gated-gelu" if gated else "relu",
        pad_token_id=0, eos_token_id=1, decoder_start_token_id=0,
        tie_word_embeddings=not gated)
    return hf_cfg, transformers.T5ForConditionalGeneration(hf_cfg)


def _cfg(pkg, hf_dict):
    return pkg.config_from_hf(hf_dict)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _save(tmp_path, name, obj):
    path = str(tmp_path / name)
    torch.save(obj, path)
    return path


@pytest.mark.parametrize("family", sorted(SPEECH_MODELS))
def test_speech_encoder_loaders_match_jax(family, tmp_path):
    hf_cfg, hf = _speech(family)
    path = _save(tmp_path, "pytorch_model.bin", hf.state_dict())
    jc = _cfg(j_convert, hf_cfg.to_dict())
    tc = _cfg(t_convert, hf_cfg.to_dict())
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for num_layers in (None, 1):
        want = t_convert.speech_encoder_from_jax(
            _np(j_convert.load_speech_encoder(path, jc, num_layers)))
        # the directory form finds pytorch_model.bin
        got = t_convert.load_speech_encoder(str(tmp_path), tc, num_layers)
        assert_trees_equal(got, want)
        assert len(got["layers"]) == (num_layers or 2)
    sd = j_convert._strip_prefix(j_convert.load_state_dict(path))
    assert_trees_equal(t_convert.speech_encoder_from_state_dict(
        hf.state_dict(), tc), t_convert.speech_encoder_from_jax(
            _np(j_convert.speech_encoder_from_state_dict(sd, jc))))


def _fairseq_name(k):
    """HF wav2vec2 key -> fairseq / s3prl key (tests/test_hf_parity.py's
    renaming)."""
    k = re.sub(r"feature_extractor\.conv_layers\.(\d+)\.conv\.",
               r"feature_extractor.conv_layers.\1.0.", k)
    k = re.sub(r"feature_extractor\.conv_layers\.0\.layer_norm\.",
               r"feature_extractor.conv_layers.0.2.", k)
    k = k.replace("feature_projection.layer_norm.", "layer_norm.")
    k = k.replace("feature_projection.projection.", "post_extract_proj.")
    for old in ("encoder.pos_conv_embed.conv.parametrizations.weight.original0",
                "encoder.pos_conv_embed.conv.weight_g"):
        k = k.replace(old, "encoder.pos_conv.0.weight_g")
    for old in ("encoder.pos_conv_embed.conv.parametrizations.weight.original1",
                "encoder.pos_conv_embed.conv.weight_v"):
        k = k.replace(old, "encoder.pos_conv.0.weight_v")
    k = k.replace("encoder.pos_conv_embed.conv.bias",
                  "encoder.pos_conv.0.bias")
    k = re.sub(r"encoder\.layers\.(\d+)\.attention\.",
               r"encoder.layers.\1.self_attn.", k)
    k = re.sub(r"encoder\.layers\.(\d+)\.layer_norm\.",
               r"encoder.layers.\1.self_attn_layer_norm.", k)
    k = k.replace(".feed_forward.intermediate_dense.", ".fc1.")
    k = k.replace(".feed_forward.output_dense.", ".fc2.")
    return k.replace("masked_spec_embed", "mask_emb")


@pytest.mark.parametrize("prefix", ["", "w2v_encoder.w2v_model."])
def test_fairseq_layout_matches_jax_and_hf_layout(prefix, tmp_path):
    hf_cfg, hf = _speech("wav2vec2", seed=2)
    fsd = {prefix + _fairseq_name(k): v for k, v in hf.state_dict().items()}
    path = _save(tmp_path, "fairseq.pt", {
        "args": argparse.Namespace(arch="wav2vec2"), "model": fsd})
    jc = _cfg(j_convert, hf_cfg.to_dict())
    tc = _cfg(t_convert, hf_cfg.to_dict())
    with pytest.warns(UserWarning, match="fairseq.pt"):
        want = t_convert.speech_encoder_from_jax(
            _np(j_convert.load_speech_encoder(path, jc)))
    with pytest.warns(UserWarning, match="fairseq.pt"):
        got = t_convert.load_speech_encoder(path, tc)
    assert_trees_equal(got, want)
    assert_trees_equal(got, t_convert.speech_encoder_from_state_dict(
        hf.state_dict(), tc))
    assert_trees_equal(
        t_convert.speech_encoder_from_fairseq_state_dict(fsd, tc), want)


@pytest.mark.parametrize("arch", ["bart", "t5", "byt5"])
def test_seq2seq_loaders_match_jax(arch, tmp_path):
    hf_cfg, hf = _seq2seq(arch)
    path = _save(tmp_path, "model.bin", hf.state_dict())
    jc = _cfg(j_convert, hf_cfg.to_dict())
    tc = _cfg(t_convert, hf_cfg.to_dict())
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    want = t_convert.seq2seq_from_jax(_np(j_convert.load_seq2seq(path, jc)))
    got = t_convert.load_seq2seq(path, tc)
    assert_trees_equal(got, want)
    if arch == "byt5":
        assert "fc_gate" in got["decoder"]["layers"][0] and "lm_head" in got
    assert_trees_equal(t_convert.seq2seq_from_state_dict(
        t_convert._strip_prefix(hf.state_dict()), tc), want)


def _composite(weighted_sum=False, down_scale=4):
    """A reference HFSpeechMixEED-layout state dict (torch tensors) of a
    wav2vec2 and a BART built in process, and the configs of both
    packages."""
    speech_cfg, speech = _speech("wav2vec2", seed=3)
    nlp_cfg, nlp = _seq2seq("bart", seed=4)
    gen = torch.Generator().manual_seed(5)
    sd = {f"encoder_model.{k}": v for k, v in speech.state_dict().items()}
    sd.update({f"decoder_model.{k}": v for k, v in nlp.state_dict().items()})
    sd["nlp_emb.weight"] = nlp.state_dict()["model.shared.weight"]
    sd["enc_to_dec_proj.weight"] = torch.randn(32, 32, generator=gen)
    sd["enc_to_dec_proj.bias"] = torch.randn(32, generator=gen)
    for i in range(int(np.log2(down_scale))):
        sd[f"length_adapters.{i}.weight"] = torch.randn(32, 32, 2,
                                                        generator=gen)
        sd[f"length_adapters.{i}.bias"] = torch.randn(32, generator=gen)
    if weighted_sum:
        sd["weights_sum"] = torch.randn(2, generator=gen)
    composite = {"model_type": "speechmix",
                 "encoder": speech_cfg.to_dict(),
                 "decoder": nlp_cfg.to_dict()}
    cfgs = []
    for pkg, cfg_mod in ((j_convert, jcfg), (t_convert, tcfg)):
        enc, dec = pkg.config_from_hf(composite)
        cfgs.append(cfg_mod.SpeechMixConfig(
            encoder=enc, decoder=dec, down_scale=down_scale,
            weighted_sum=weighted_sum, weighted_sum_convention="s3prl"))
    return sd, composite, cfgs[0], cfgs[1]


@pytest.mark.parametrize("weighted_sum", [False, True])
def test_speechmix_state_dict_and_export_match_jax(weighted_sum):
    sd, _, jc, tc = _composite(weighted_sum)
    jtree = j_convert.load_speechmix(sd, jc)
    want = t_convert.params_from_jax(_np(jtree), tc)
    got = t_convert.load_speechmix(sd, tc)
    assert_trees_equal(got, want)
    j_sd = j_convert.export_speechmix(jtree, jc)
    t_sd = t_convert.export_speechmix(got, tc)
    assert sorted(t_sd) == sorted(j_sd)
    for k, v in j_sd.items():
        assert t_sd[k].dtype == np.float32, k
        np.testing.assert_array_equal(t_sd[k], v, err_msg=k)
    # the export loads back to the same parameters (the positional conv's
    # weight norm rebuilt from g and v within rounding)
    back = dict(tree_paths(t_convert.load_speechmix(t_sd, tc)))
    for path, a in tree_paths(got):
        np.testing.assert_allclose(back[path].numpy(), a.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=path)


def test_speechmix_ed_layout_matches_jax():
    """The HFSpeechMixED layout: model.encoder.* a Wav2Vec2Model,
    model.decoder.* a BartForCausalLM, with and without
    model.enc_to_dec_proj."""
    speech_cfg, speech = _speech("wav2vec2", seed=6)
    nlp_cfg, nlp = _seq2seq("bart", seed=7)
    torch.manual_seed(8)
    causal = transformers.BartForCausalLM(nlp_cfg)
    sd = {f"model.encoder.{k}": v for k, v in speech.state_dict().items()}
    sd.update({f"model.decoder.{k}": v
               for k, v in causal.state_dict().items()})
    for with_proj in (False, True):
        if with_proj:
            sd["model.enc_to_dec_proj.weight"] = torch.randn(32, 32)
            sd["model.enc_to_dec_proj.bias"] = torch.randn(32)
        cfgs = [cfg_mod.SpeechMixConfig(
            encoder=pkg.config_from_hf(speech_cfg.to_dict()),
            decoder=pkg.config_from_hf(nlp_cfg.to_dict()), variant="ed",
            down_scale=1) for pkg, cfg_mod in ((j_convert, jcfg),
                                               (t_convert, tcfg))]
        want = t_convert.params_from_jax(
            _np(j_convert.load_speechmix_ed(sd, cfgs[0])), cfgs[1])
        assert_trees_equal(t_convert.load_speechmix_ed(sd, cfgs[1]), want)


def test_config_from_hf_matches_jax(tmp_path):
    _, composite, _, _ = _composite()
    (tmp_path / "config.json").write_text(json.dumps(composite))
    (tmp_path / "generation_config.json").write_text(
        json.dumps({"max_length": 77}))
    want = j_convert.config_from_hf(str(tmp_path))
    got = t_convert.config_from_hf(str(tmp_path))
    assert [dataclasses.asdict(c) for c in got] == \
        [dataclasses.asdict(c) for c in want]
    assert got[1].max_length == 77
    # a checkpoint directory stands in for a preset name
    (tmp_path / "bart").mkdir()
    (tmp_path / "bart" / "config.json").write_text(
        json.dumps(composite["decoder"]))
    assert dataclasses.asdict(tcfg.seq2seq_config(str(tmp_path / "bart"))) \
        == dataclasses.asdict(jcfg.seq2seq_config(str(tmp_path / "bart")))
    with pytest.raises(ValueError):
        tcfg.speech_encoder_config(str(tmp_path / "bart"))
    for bad in ({"model_type": "gpt2"},
                {"model_type": "bart", "encoder_attention_heads": 4,
                 "decoder_attention_heads": 2}):
        with pytest.raises(ValueError):
            t_convert.config_from_hf(bad)


@pytest.mark.parametrize("kind,name", [
    ("speech_encoder", "wav2vec2-base"),
    ("seq2seq", "facebook/bart-base")])
def test_preset_name_wins_over_a_directory_of_that_name(tmp_path,
                                                         monkeypatch, kind,
                                                         name):
    """A checkpoint directory named like a preset, in the working
    directory: both packages give the preset, as the JAX package checks
    the presets first."""
    _, composite, _, _ = _composite()
    (tmp_path / name).mkdir(parents=True)
    (tmp_path / name / "config.json").write_text(json.dumps(
        composite["encoder" if kind == "speech_encoder" else "decoder"]))
    monkeypatch.chdir(tmp_path)
    presets = (tcfg.SPEECH_ENCODER_PRESETS if kind == "speech_encoder"
               else tcfg.SEQ2SEQ_PRESETS)
    got = getattr(tcfg, f"{kind}_config")(name)
    want = getattr(jcfg, f"{kind}_config")(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got == presets[name]
    # a directory under another name still goes through config_from_hf
    (tmp_path / name).rename(tmp_path / "local")
    assert getattr(tcfg, f"{kind}_config")("local") != presets[name]


def test_load_state_dict_pickle_gate(tmp_path):
    """tests/test_api.py's pins on the JAX loader, for the port's."""
    clean = _save(tmp_path, "clean.bin", {"w": torch.zeros(2)})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sd = t_convert.load_state_dict(clean)
    assert sd["w"].shape == (2,)
    dirty = _save(tmp_path, "fairseq.pt", {
        "args": argparse.Namespace(arch="wav2vec2"),
        "model": {"w": torch.ones(3)}})
    with pytest.warns(UserWarning, match="fairseq.pt"):
        sd = t_convert.load_state_dict(dirty)
    assert sd["w"].shape == (3,)
    with pytest.raises(Exception):
        t_convert.load_state_dict(dirty, allow_pickle=False)
    with pytest.raises((FileNotFoundError, OSError, RuntimeError)):
        t_convert.load_state_dict(str(tmp_path / "missing.bin"))


def test_safetensors_without_the_package_names_the_file(tmp_path,
                                                        monkeypatch):
    path = str(tmp_path / "model.safetensors")
    open(path, "wb").close()
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "safetensors.numpy", None)
    with pytest.raises(ImportError, match="model.safetensors"):
        t_convert.load_state_dict(str(tmp_path))
