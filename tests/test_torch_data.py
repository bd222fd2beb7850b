"""The port's data pipeline against the JAX package's, on the CPU: the same
numpy inputs from a seed through both.

Everything here is exact (bit for bit, or equal integers and strings): the
synthetic corpus, the numpy resampler and normalisation (the port's plain
versions against the JAX package's numpy path; the port's C++ runtime
against the JAX package's, where built, to 1e-6 as the JAX package's own
test holds it; tests/test_torch_native.py holds the runtime against the
plain versions), the byte tokenizer, WER / CER, collated
batches and the BucketBatcher's order over two epochs, the prepared
examples and the datasets' batches, and the teacher's (text ids, labels)
pairs on tiny-bart-bytes in float32.  The prefetcher stages in order,
raises the source's error and stops its worker on an early exit.
"""

import csv
import threading
import time
import types
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechmix_tpu import config as jcfg
from speechmix_tpu import metrics as j_metrics
from speechmix_tpu.data import audio as j_audio
from speechmix_tpu.data import collator as j_coll
from speechmix_tpu.data import datasets as j_ds
from speechmix_tpu.data import teacher as j_teacher
from speechmix_tpu.data import tokenizer as j_tok
from speechmix_tpu.runtime import native
from speechmix_tpu_torch import config as tcfg
from speechmix_tpu_torch import convert
from speechmix_tpu_torch import metrics as t_metrics
from speechmix_tpu_torch.data import audio as t_audio
from speechmix_tpu_torch.data import collator as t_coll
from speechmix_tpu_torch.data import datasets as t_ds
from speechmix_tpu_torch.data import prefetch as t_prefetch
from speechmix_tpu_torch.data import teacher as t_teacher
from speechmix_tpu_torch.data import tokenizer as t_tok
from test_torch_slice import _tree as _slice_tree
from torch_threads import one_torch_thread  # noqa: F401

BART_IDS = dict(pad_token_id=1, eos_token_id=2, bos_token_id=0)


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                          err_msg=k)
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k


@pytest.mark.parametrize("kw", [dict(), dict(min_sec=4.0, max_sec=16.0,
                                             min_words=8, max_words=40)])
def test_synthetic_corpus_bit_identical(kw):
    got = t_ds.synthetic_corpus(6, seed=3, **kw)
    want = j_ds.synthetic_corpus(6, seed=3, **kw)
    for g, w in zip(got, want):
        assert g["text"] == w["text"]
        assert g["audio"].dtype == w["audio"].dtype == np.float32
        np.testing.assert_array_equal(g["audio"], w["audio"])


@pytest.mark.parametrize("sr", [44100, 22050, 8000, 16000])
def test_resample_and_normalize_bit_identical(sr, monkeypatch):
    rng = np.random.RandomState(5)
    x = (rng.randn(sr // 4) * 0.1).astype(np.float32)
    if native.available():
        # the JAX package's C++ kernel: the same samples to 1e-6
        native_out = j_audio.resample(x, sr, 16000)
        got = t_audio.resample(x, sr, 16000)
        n = min(len(got), len(native_out))
        np.testing.assert_allclose(got[:n], native_out[:n], rtol=0,
                                   atol=1e-6)
    monkeypatch.setattr(native, "available", lambda: False)
    np.testing.assert_array_equal(t_audio.resample_plain(x, sr, 16000),
                                  j_audio.resample(x, sr, 16000))
    np.testing.assert_array_equal(t_audio.normalize_plain(x),
                                  j_audio.normalize(x))
    stereo = np.stack([x, x * 0.5])
    np.testing.assert_array_equal(t_audio.to_mono(stereo),
                                  j_audio.to_mono(stereo))
    for n in (100, 64000, 64001, 400000):
        assert t_audio.bucket_length(n) == j_audio.bucket_length(n)
    np.testing.assert_array_equal(t_audio.pad_to(x, len(x) + 7),
                                  j_audio.pad_to(x, len(x) + 7))


def test_byte_tokenizer_and_load_tokenizer():
    text = "the quick brown fox, naïve café"
    for kw in (dict(), BART_IDS, dict(vocab_size=50265)):
        t, j = t_tok.ByteTokenizer(**kw), j_tok.ByteTokenizer(**kw)
        for special in (True, False):
            assert t.encode(text, special) == j.encode(text, special)
            assert t(text, special) == j(text, special)
        ids = t.encode(text) + [0, 1, 2, 5, 383, 384, 50000]
        assert t.decode(ids) == j.decode(ids) == text
        assert t.batch_decode([ids, ids[:3]]) == j.batch_decode([ids,
                                                                  ids[:3]])
    dec_t = tcfg.SEQ2SEQ_PRESETS["tiny-bart-bytes"]
    dec_j = jcfg.SEQ2SEQ_PRESETS["tiny-bart-bytes"]
    t, j = (t_tok.load_tokenizer("tiny-bart-bytes", dec_t),
            j_tok.load_tokenizer("tiny-bart-bytes", dec_j))
    assert (t.pad_token_id, t.eos_token_id, t.bos_token_id) == \
        (j.pad_token_id, j.eos_token_id, j.bos_token_id) == (1, 2, 0)
    # no local HF tokenizer: the byte fallback with the decoder's ids
    with pytest.warns(UserWarning, match="falling back"):
        t = t_tok.load_tokenizer("/nonexistent/tokenizer", dec_t)
    assert isinstance(t, t_tok.ByteTokenizer) and t.eos_token_id == 2


def test_hf_tokenizer_adapter_matches(tmp_path):
    """A tokenizer built in process and saved locally, through both
    adapters."""
    tokenizers = pytest.importorskip("tokenizers")
    transformers = pytest.importorskip("transformers")
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3, "the": 4,
             "quick": 5, "fox": 6}
    tk = tokenizers.Tokenizer(tokenizers.models.WordLevel(vocab, "<unk>"))
    tk.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    fast = transformers.PreTrainedTokenizerFast(
        tokenizer_object=tk, bos_token="<s>", eos_token="</s>",
        pad_token="<pad>", unk_token="<unk>")
    fast.save_pretrained(tmp_path)
    t = t_tok.HFTokenizerAdapter(str(tmp_path))
    j = j_tok.HFTokenizerAdapter(str(tmp_path))
    assert (t.pad_token_id, t.eos_token_id, t.bos_token_id, t.vocab_size) \
        == (j.pad_token_id, j.eos_token_id, j.bos_token_id, j.vocab_size)
    assert t.encode("the quick fox") == j.encode("the quick fox")
    assert t.decode([4, 5, 2, 1]) == j.decode([4, 5, 2, 1])


def test_wer_cer_equal():
    rng = np.random.RandomState(0)
    words = "a bb ccc dd e fff".split()
    refs, hyps = [], []
    for _ in range(12):
        refs.append(" ".join(rng.choice(words, rng.randint(0, 7))))
        hyps.append(" ".join(rng.choice(words, rng.randint(0, 7))))
    assert t_metrics.wer(refs, hyps) == j_metrics.wer(refs, hyps)
    assert t_metrics.cer(refs, hyps) == j_metrics.cer(refs, hyps)
    assert t_metrics.wer(["a b c"], ["a x c d"]) == 2 / 3
    tok = t_tok.ByteTokenizer(**BART_IDS)
    preds = rng.randint(120, 260, (3, 9))
    labels = rng.randint(120, 260, (3, 9))
    labels[1, 5:] = -100
    assert t_metrics.compute_metrics(preds, labels, tok) == \
        j_metrics.compute_metrics(preds, labels, j_tok.ByteTokenizer(
            **BART_IDS))


def _examples(rng, n=11, text=True):
    out = []
    for i in range(n):
        sec = rng.choice([0.3, 0.7, 1.1, 3.0])
        ex = {"input_values": (rng.randn(int(sec * 16000))
                               * 0.1).astype(np.float32),
              "labels": [0] + list(rng.randint(3, 300, rng.randint(1, 14))),
              "lengths": 0}
        if text:
            ex["text_input_ids"] = list(rng.randint(3, 300,
                                                    rng.randint(1, 14)))
        out.append(ex)
    return out


@pytest.mark.parametrize("group_by_length,drop,text", [
    (True, True, True), (False, False, False)])
def test_collate_and_bucket_batcher_two_epochs(group_by_length, drop, text):
    """Equal batches in equal order over two shuffled epochs: buckets,
    filler rows and example_mask, BOS strip, EOS re-append on truncation,
    aligned bucket lengths, too-long examples dropped or kept."""
    examples = _examples(np.random.RandomState(1), text=text)
    enc = tcfg.SPEECH_ENCODER_PRESETS["tiny-speech"]
    kw = dict(buckets_sec=(0.5, 1.0, 2.0), max_label_length=8,
              max_text_length=6, pad_token_id=1, bos_token_id=0,
              eos_token_id=2, align_samples=enc.aligned_samples)
    t = t_coll.BucketBatcher(t_coll.CollatorConfig(**kw), 3,
                             drop_too_long=drop, shuffle_seed=7,
                             group_by_length=group_by_length)
    j = j_coll.BucketBatcher(j_coll.CollatorConfig(**kw), 3,
                             drop_too_long=drop, shuffle_seed=7,
                             group_by_length=group_by_length)
    for _ in range(2):
        got, want = list(t(examples)), list(j(examples))
        _assert_batches_equal(got, want)
    assert t.epoch == j.epoch == 2
    assert any(not b["example_mask"].all() for b in got)
    assert any((b["labels"][:, -1] == 2).any() for b in got)
    one = t_coll.collate(examples[:2], t_coll.CollatorConfig(**kw), 20000)
    _assert_batches_equal([one], [j_coll.collate(
        examples[:2], j_coll.CollatorConfig(**kw), 20000)])


def test_prepare_filter_cache_and_build_datasets(tmp_path, monkeypatch):
    """prepare_examples on transcripts, length_filter, the cache round trip
    and key, and build_datasets' synthetic batches over two epochs."""
    tc_cfg = tcfg.SpeechMixConfig(
        encoder=tcfg.SPEECH_ENCODER_PRESETS["tiny-speech"],
        decoder=tcfg.SEQ2SEQ_PRESETS["tiny-bart-bytes"], down_scale=2)
    jc_cfg = jcfg.SpeechMixConfig(
        encoder=jcfg.SPEECH_ENCODER_PRESETS["tiny-speech"],
        decoder=jcfg.SEQ2SEQ_PRESETS["tiny-bart-bytes"], down_scale=2)
    t_model = types.SimpleNamespace(config=tc_cfg, params=None,
                                    tokenizer=t_tok.ByteTokenizer(**BART_IDS))
    j_model = types.SimpleNamespace(config=jc_cfg, params=None,
                                    tokenizer=j_tok.ByteTokenizer(**BART_IDS))
    raw = t_ds.synthetic_corpus(5, seed=2)
    for workers in (1, 2):
        got = t_ds.prepare_examples(raw, t_model, "Say: ", False,
                                    workers=workers)
        want = j_ds.prepare_examples(raw, j_model, "Say: ", False,
                                     workers=workers)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            np.testing.assert_array_equal(g.pop("input_values"),
                                          w.pop("input_values"))
            assert g == w
    got = t_ds.prepare_examples(raw, t_model, "", False)
    kept = t_ds.length_filter(got, 2.2)
    assert [e["lengths"] for e in kept] == [
        e["lengths"] for e in j_ds.length_filter(got, 2.2)]
    path = str(tmp_path / "c" / "ex.npz")
    t_ds.save_examples(path, kept)
    for a, b in zip(j_ds.load_examples(path), t_ds.load_examples(path)):
        np.testing.assert_array_equal(a.pop("input_values"),
                                      b.pop("input_values"))
        assert a == b
    parts = ["synthetic", "tiny-speech", "tiny-bart-bytes", None, "train"]
    assert t_ds._cache_key(parts) == j_ds._cache_key(parts)

    args = types.SimpleNamespace(
        batch=8, grad_accum=1, prompt="", synthetic=True, dataset=None,
        custom_set=None, field=None, train_split=None, test_split=None,
        seed=4, cache=False, max_input_length_in_sec=4.5, worker=1,
        group_by_length=True, multihost=False)
    t_train, t_eval = t_ds.build_datasets(args, t_model, device="cpu")
    j_train, j_eval = j_ds.build_datasets(args, j_model)
    for _ in range(2):
        _assert_batches_equal(list(t_train()), list(j_train()))
    _assert_batches_equal(list(t_eval()), list(j_eval()))
    # multihost (ported): one process holds the one data rank, and its
    # batches are the JAX package's multihost batches on one process
    args.multihost = True
    t_train, t_eval = t_ds.build_datasets(args, t_model, device="cpu")
    j_train, j_eval = j_ds.build_datasets(args, j_model)
    _assert_batches_equal(list(t_train()), list(j_train()))
    _assert_batches_equal(list(t_eval()), list(j_eval()))


def _write_wav(path, data, sr, width, channels=1):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(data.tobytes())


def test_custom_csv_and_wave_reader(tmp_path, monkeypatch):
    """_load_custom_csv's seeded split and resampling over WAV files read
    by the standard library's wave (8-, 16-, 24- and 32-bit, stereo)."""
    monkeypatch.setitem(__import__("sys").modules, "soundfile", None)
    # both packages' numpy resamplers, bit for bit (the C++ runtimes are
    # held against them in test_resample_and_normalize_bit_identical)
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(t_audio, "resample", t_audio.resample_plain)
    rng = np.random.RandomState(3)
    rows = []
    for i, (width, channels, sr) in enumerate(
            [(1, 1, 8000), (2, 2, 22050), (3, 1, 16000), (4, 1, 44100),
             (2, 1, 16000)]):
        n = sr // 5 * channels
        if width == 1:
            data = rng.randint(0, 256, n).astype(np.uint8)
        elif width == 3:
            data = rng.randint(0, 256, n * 3).astype(np.uint8)
        else:
            dtype = {2: np.int16, 4: np.int32}[width]
            data = rng.randint(-2 ** 15, 2 ** 15, n).astype(dtype)
        path = tmp_path / f"a{i}.wav"
        _write_wav(path, data, sr, width, channels)
        rows.append({"path": str(path), "text": f"utterance {i}"})
        got, got_sr = t_ds._read_audio(str(path))
        want, want_sr = j_ds._read_audio(str(path))
        assert got_sr == want_sr == sr
        np.testing.assert_array_equal(got, want)
    csv_path = tmp_path / "set.csv"
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["path", "text"])
        writer.writeheader()
        writer.writerows(rows)
    for workers in (1, 2):
        got = t_ds._load_custom_csv(str(csv_path), seed=1, workers=workers)
        want = j_ds._load_custom_csv(str(csv_path), seed=1, workers=workers)
        for g_split, w_split in zip(got, want):
            assert [e["text"] for e in g_split] == [e["text"]
                                                    for e in w_split]
            for g, w in zip(g_split, w_split):
                np.testing.assert_array_equal(g["audio"], w["audio"])


def test_teacher_pairs_exact():
    """create_self_decoder_inputs_batched: the port's pairs are the JAX
    package's on tiny-bart-bytes float32 weights through params_from_jax
    (two chunks, the second padded; text buckets 16 and 32).  The EOS
    logit is raised so that some rows end early: labels of 1, 2, 12 and 13
    tokens (the emitted EOS stripped, the tokenizer's appended)."""
    jc = jcfg.SpeechMixConfig(
        encoder=jcfg.SPEECH_ENCODER_PRESETS["tiny-speech"],
        decoder=jcfg.SEQ2SEQ_PRESETS["tiny-bart-bytes"], down_scale=2)
    tc = tcfg.SpeechMixConfig(
        encoder=tcfg.SPEECH_ENCODER_PRESETS["tiny-speech"],
        decoder=tcfg.SEQ2SEQ_PRESETS["tiny-bart-bytes"], down_scale=2)
    tree = _slice_tree(jc, 0.3, seed=2)
    tree["nlp"]["final_logits_bias"] = tree["nlp"]["final_logits_bias"].copy()
    tree["nlp"]["final_logits_bias"][2] = 7.75
    sentences = ["the fox", "a lazy dog jumps over it", "hi",
                 "seven wizards toast bright coffee", "near azure hills",
                 "q"]
    want = j_teacher.create_self_decoder_inputs_batched(
        jax.tree_util.tree_map(jnp.asarray, tree["nlp"]), jc.decoder,
        j_tok.ByteTokenizer(**BART_IDS), sentences, max_length=12,
        batch_size=4)
    params = convert.params_from_jax(tree, tc)
    got = t_teacher.create_self_decoder_inputs_batched(
        params["nlp"], tc.decoder, t_tok.ByteTokenizer(**BART_IDS),
        sentences, max_length=12, batch_size=4, device="cpu")
    assert got == want
    assert sorted({len(labels) for _, labels in got}) == [1, 2, 12, 13]
    assert all(labels[-1] == 2 for _, labels in got)
    assert t_teacher._text_bucket(17) == j_teacher._text_bucket(17) == 32


def _batches(n, b=4):
    for i in range(n):
        yield {"input_values": np.full((b, 16), float(i), np.float32),
               "lengths": np.full((b,), 16, np.int32)}


def test_prefetch_order_values_and_types():
    out = list(t_prefetch.prefetch_to_device(_batches(5), "cpu", depth=2))
    assert len(out) == 5
    for i, batch in enumerate(out):
        assert isinstance(batch["input_values"], torch.Tensor)
        assert batch["input_values"].dtype == torch.float32
        assert batch["lengths"].dtype == torch.int32
        assert float(batch["input_values"][0, 0]) == float(i)


def test_prefetch_error_propagates():
    def bad():
        yield {"input_values": np.zeros((4, 16), np.float32)}
        raise RuntimeError("boom")

    it = t_prefetch.prefetch_to_device(bad(), "cpu", depth=2)
    next(it)
    with pytest.raises(RuntimeError, match="boom"):
        list(it)


def test_prefetch_early_exit_stops_worker():
    def alive():
        return [t for t in threading.enumerate()
                if t.name == "smx-device-prefetch"]
    before = len(alive())
    it = t_prefetch.prefetch_to_device(_batches(100), "cpu", depth=1)
    next(it)
    assert len(alive()) == before + 1
    it.close()
    deadline = time.time() + 5
    while len(alive()) > before and time.time() < deadline:
        time.sleep(0.05)
    assert len(alive()) == before


def test_load_librispeech_dir(tmp_path, monkeypatch):
    """A LibriSpeech-style tree (transcripts beside the audio files, read
    here by the wave reader) loads as the JAX package loads it, sorted by
    utterance id, with max_utts and a thread pool."""
    monkeypatch.setitem(__import__("sys").modules, "soundfile", None)
    # both packages' numpy resamplers, bit for bit (the C++ runtimes are
    # held against them in test_resample_and_normalize_bit_identical)
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(t_audio, "resample", t_audio.resample_plain)
    rng = np.random.RandomState(4)
    for spk, chapter, n in (("19", "198", 3), ("7", "11", 2)):
        d = tmp_path / spk / chapter
        d.mkdir(parents=True)
        lines = []
        for u in range(n):
            utt = f"{spk}-{chapter}-{u:04d}"
            sr = 16000 if u % 2 else 22050
            _write_wav(d / f"{utt}.flac",
                       rng.randint(-2 ** 15, 2 ** 15, sr // 10).astype(
                           np.int16), sr, 2)
            lines.append(f"{utt} WORDS OF {utt}")
        lines.append(f"{spk}-{chapter}-9999 NO AUDIO FILE")
        (d / f"{spk}-{chapter}.trans.txt").write_text("\n".join(lines))
    for kw in (dict(workers=1), dict(workers=3, max_utts=4)):
        got = t_ds.load_librispeech_dir(str(tmp_path), **kw)
        want = j_ds.load_librispeech_dir(str(tmp_path), **kw)
        assert [e["text"] for e in got] == [e["text"] for e in want]
        assert len(got) == kw.get("max_utts", 5)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["audio"], w["audio"])
