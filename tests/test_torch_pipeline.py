"""The port's TranscriptionPipeline against the JAX package's, on the CPU in
float32, on the same weights: transcripts of a mixed batch (two buckets,
padding by repetition, long audio chunked, too-short inputs, resampling)
equal to the JAX pipeline's, with float32 and int16 transfer; split_long's
cut points; the int16 conversion with mixed loudness; min_length passed on;
fuse_qkv token-exact; the refusals (mesh, generate_kwargs, arguments)."""

import jax
import numpy as np
import pytest
import torch

import speechmix_tpu
import speechmix_tpu_torch
from speechmix_tpu import pipeline as j_pipe
from speechmix_tpu_torch import convert
from speechmix_tpu_torch import generation as t_gen
from speechmix_tpu_torch import pipeline as t_pipe
from test_torch_slice import _tree
from torch_threads import one_torch_thread  # noqa: F401

BUCKETS = (0.5, 1.0)
KW = dict(batch_size=2, max_length=6, buckets_sec=(1.0, 0.5, 1.0))


@pytest.fixture(scope="module")
def models():
    j = speechmix_tpu.HFSpeechMixEED("tiny-speech", "tiny-bart-bytes",
                                     down_scale=2)
    t = speechmix_tpu_torch.HFSpeechMixEED("tiny-speech", "tiny-bart-bytes",
                                           down_scale=2, device="cpu")
    tree = _tree(j.config, 0.3, seed=2)
    j.params = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    t.params = convert.params_from_jax(tree, t.config)
    return j, t


def _waveforms():
    """Lengths over both buckets (one partial batch), 2.3 s to chunk, one
    input shorter than a conv frame, one empty, and loud beside quiet."""
    rng = np.random.RandomState(0)
    lens = [12000, 5000, 16000, 36800, 30, 0, 7000, 9000]
    gains = [0.1, 0.1, 2.5, 0.1, 0.1, 0.1, 0.001, 0.1]
    return [rng.randn(n).astype(np.float32) * g for n, g in zip(lens, gains)]


@pytest.mark.parametrize("transfer_dtype", ["float32", "int16"])
def test_transcripts_match_jax(models, transfer_dtype, monkeypatch):
    j, t = models
    shapes = []
    real_generate = t_gen.generate

    def spy(params, cfg, batch, lengths, **kw):
        shapes.append(tuple(batch.shape))
        return real_generate(params, cfg, batch, lengths, **kw)
    monkeypatch.setattr(t_pipe.gen_lib, "generate", spy)
    pipe = t_pipe.TranscriptionPipeline(t, transfer_dtype=transfer_dtype,
                                        **KW)
    assert pipe.buckets_sec == BUCKETS
    wavs = _waveforms()
    rates = [16000] * (len(wavs) - 1) + [22050]
    got = pipe(wavs, rates)
    assert got == j_pipe.TranscriptionPipeline(
        j, transfer_dtype=transfer_dtype, **KW)(wavs, rates)
    assert got[4] == "" and got[5] == ""
    align = t.config.encoder.aligned_samples
    assert set(shapes) == {(2, align(8000)), (2, align(16000))}
    # the chunked input is the join of its chunks' transcripts
    parts = pipe(pipe.split_long(wavs[3]))
    assert got[3] == " ".join(p for p in parts if p).strip()


def test_split_long_cut_points_match_jax(models):
    j, t = models
    rng = np.random.RandomState(3)
    wav = rng.randn(int(4.3 * 16000)).astype(np.float32) * 0.1
    wav[15000:15500] = 0.0           # a silence inside the search window
    for kw in (dict(), dict(long_audio_search_sec=0.2)):
        want = j_pipe.TranscriptionPipeline(j, buckets_sec=BUCKETS,
                                            **kw).split_long(wav)
        got = t_pipe.TranscriptionPipeline(t, buckets_sec=BUCKETS,
                                           **kw).split_long(wav)
        assert [len(s) for s in got] == [len(s) for s in want]
        np.testing.assert_array_equal(np.concatenate(got), wav)
    assert len(got[0]) < 16000 and len(got) >= 5


def test_int16_transfer_scales_each_row(models, monkeypatch):
    """The waveform generate() receives: each row's 16-bit codes times its
    own peak / 32767, computed as the JAX package computes it."""
    _, t = models
    seen = []
    monkeypatch.setattr(t_pipe.gen_lib, "generate",
                        lambda params, cfg, batch, lengths, **kw:
                        seen.append(batch) or (torch.zeros(
                            (batch.shape[0], 6), dtype=torch.long), None))
    rng = np.random.RandomState(4)
    wavs = [rng.randn(8000).astype(np.float32) * g for g in (3.0, 1e-3)]
    t_pipe.TranscriptionPipeline(t, batch_size=2, max_length=6,
                                 buckets_sec=BUCKETS,
                                 transfer_dtype="int16")(wavs)
    batch = np.zeros((2, t.config.encoder.aligned_samples(8000)), np.float32)
    for i, w in enumerate(wavs):
        batch[i, :len(w)] = w
    scale = np.maximum(np.abs(batch).max(axis=1), 1e-9).astype(np.float32)
    codes = np.clip(np.round(batch * (32767.0 / scale[:, None])), -32767,
                    32767).astype(np.int16)
    want = codes.astype(np.float32) * (scale[:, None] / np.float32(32767.0))
    np.testing.assert_array_equal(seen[0].numpy(), want)
    # the quiet row keeps its resolution: relative error of a 16-bit code
    err = np.abs(seen[0].numpy()[1, :8000] - wavs[1]).max()
    assert err <= scale[1] / 32767.0


def test_min_length_and_fuse_qkv(models, monkeypatch):
    _, t = models
    wavs = _waveforms()[:3]
    seen = []
    real_generate = t_gen.generate
    monkeypatch.setattr(t_pipe.gen_lib, "generate",
                        lambda *a, **kw: seen.append(kw["min_length"]) or
                        real_generate(*a, **kw))
    t_pipe.TranscriptionPipeline(t, min_length=5, **KW)(wavs)
    assert seen and set(seen) == {5}
    plain = t_pipe.TranscriptionPipeline(t, **KW)
    fused = t_pipe.TranscriptionPipeline(t, fuse_qkv=True, **KW)
    assert fused(wavs) == plain(wavs)
    attn = fused._run_params()["speech_encoder"]["layers"][0]["attention"]
    assert "qkv_proj" in attn and "q_proj" not in attn
    assert fused._run_params() is fused._run_params()   # made once


def test_edge_inputs_and_warmup(models, monkeypatch):
    _, t = models
    calls = []
    real_generate = t_gen.generate
    monkeypatch.setattr(t_pipe.gen_lib, "generate",
                        lambda *a, **kw: calls.append(kw["max_length"]) or
                        real_generate(*a, **kw))
    pipe = t_pipe.TranscriptionPipeline(t, **KW)
    # nothing long enough for a frame: no decode at all
    assert pipe([np.zeros(0, np.float32), np.ones(30, np.float32)]) == \
        ["", ""]
    assert pipe([]) == [] and calls == []
    assert pipe.warmup() is pipe and calls == [2, 2]


def test_refusals(models):
    _, t = models
    # serving over a mesh is ported: the one-rank mesh gives the same
    # transcripts (meshes of several ranks: test_torch_parallel_serving)
    from speechmix_tpu_torch.parallel import mesh as t_mesh
    wavs = _waveforms()[:3]
    assert t_pipe.TranscriptionPipeline(
        t, mesh=t_mesh.make_mesh(device="cpu"), **KW)(wavs) == \
        t_pipe.TranscriptionPipeline(t, **KW)(wavs)
    with pytest.raises(ValueError, match="not supported"):
        t_pipe.TranscriptionPipeline(
            t, generate_kwargs={"num_return_sequences": 2})
    with pytest.raises(ValueError, match="num_beams"):
        t_pipe.TranscriptionPipeline(
            t, generate_kwargs={"force_words_ids": [[5]]})
    for bad in (dict(transfer_dtype="float16"), dict(long_audio="drop"),
                dict(buckets_sec=()), dict(buckets_sec=(1.0, -2.0))):
        with pytest.raises(ValueError):
            t_pipe.TranscriptionPipeline(t, **bad)
    pipe = t_pipe.TranscriptionPipeline(
        t, num_beams=2, generate_kwargs={"no_repeat_ngram_size": 2,
                                         "bad_words_ids": [[7]]}, **KW)
    assert len(pipe(_waveforms()[:1])) == 1
