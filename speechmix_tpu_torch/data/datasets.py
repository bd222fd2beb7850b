"""Dataset construction (port of ``speechmix_tpu.data.datasets``): HF
datasets, a custom CSV, a LibriSpeech directory, or a synthetic corpus
(offline).

As in the JAX package:
  * one seeded train / test split for a custom CSV;
  * prepared examples cached to disk, keyed on everything that changes
    them;
  * the reference's 1 s < length < max_sec filter;
  * teacher targets from one batched decode per chunk on the card
    (``data/teacher.py``);
  * a synthetic path (deterministic pseudo-speech and transcripts), so a
    run needs no network.

The builders read only ``model.config``, ``model.params`` and
``model.tokenizer`` of the model they are given.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Callable, List, Optional, Tuple

import numpy as np

from . import audio as audio_lib
from .collator import BucketBatcher, CollatorConfig
from .teacher import create_self_decoder_inputs_batched


# ----------------------------------------------------------------------------
# synthetic corpus (offline tests / smoke training)
# ----------------------------------------------------------------------------

_WORDS = ("the quick brown fox jumps over a lazy dog while seven wizards "
          "toast bright vivid morning coffee near azure hills").split()


def synthetic_corpus(n: int, seed: int = 0, min_sec=1.2, max_sec=6.0,
                     min_words=2, max_words=5, vocab_size=10):
    """Deterministic pseudo-speech and transcripts, the JAX package's bit for
    bit.  Each vocabulary word maps to a fixed two-tone signature (no
    salted hash(), so every process makes the same audio for the same
    text); an utterance of k words lasts 0.5 + 0.35 k s, clipped to
    [min_sec, max_sec]."""
    rng = np.random.RandomState(seed)
    sr = 16000
    vocab = min(vocab_size, len(_WORDS))
    out = []
    for i in range(n):
        k = rng.randint(min_words, max_words + 1)
        idxs = rng.randint(vocab, size=k)
        words = [_WORDS[j] for j in idxs]
        text = " ".join(words)
        dur = float(np.clip(0.5 + 0.35 * k, min_sec, max_sec))
        t = np.arange(int(dur * sr)) / sr
        sig = np.zeros_like(t, np.float32)
        seg = len(t) // max(k, 1)
        for j, widx in enumerate(idxs):
            f1 = 150.0 + 90.0 * widx          # word-indexed fundamentals
            f2 = 2000.0 + 130.0 * widx
            sl = slice(j * seg, (j + 1) * seg)
            tt = t[sl]
            sig[sl] = (0.25 * np.sin(2 * np.pi * f1 * tt) +
                       0.15 * np.sin(2 * np.pi * f2 * tt)).astype(np.float32)
        sig += 0.01 * rng.randn(len(t)).astype(np.float32)
        out.append({"audio": sig, "text": text})
    return out


# ----------------------------------------------------------------------------
# example preparation
# ----------------------------------------------------------------------------

def prepare_examples(raw: List[dict], model, input_text_prompt: str = "",
                     use_teacher_targets: bool = True,
                     teacher_batch: int = 16, workers: int = 1,
                     device=None) -> List[dict]:
    """raw: [{'audio': 1-D float32 at 16 kHz, 'text': str}] ->
    [{'input_values', 'lengths', 'input_text_prompt', 'text_input_ids',
    'labels'}].

    Labels are the frozen NLP teacher's greedy output on the lower-cased
    transcript plus EOS (on `device`, default the card); with
    use_teacher_targets=False, the tokenized transcript plus EOS.
    workers > 1 tokenizes on a thread pool."""
    tok = model.tokenizer
    texts = [input_text_prompt + ex["text"].lower() for ex in raw]
    if use_teacher_targets:
        pairs = create_self_decoder_inputs_batched(
            model.params["nlp"], model.config.decoder, tok, texts,
            batch_size=teacher_batch, device=device)
    else:
        def tokenize_one(t):
            ids = tok.encode(t, add_special_tokens=True)
            labels = list(ids)
            if not labels or labels[-1] != tok.eos_token_id:
                labels.append(tok.eos_token_id)
            return ids, labels

        if workers > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=workers) as pool:
                pairs = list(pool.map(tokenize_one, texts))
        else:
            pairs = [tokenize_one(t) for t in texts]

    out = []
    for ex, (text_ids, labels) in zip(raw, pairs):
        wav = np.asarray(ex["audio"], np.float32)
        out.append({
            "input_values": wav,
            "lengths": len(wav),
            "input_text_prompt": input_text_prompt,
            "text_input_ids": text_ids,
            "labels": labels,
        })
    return out


def length_filter(examples: List[dict], max_sec: float, min_sec: float = 1.0,
                  sr: int = 16000) -> List[dict]:
    """Keep min_sec < length < max_sec."""
    return [ex for ex in examples
            if min_sec * sr < ex["lengths"] < max_sec * sr]


# ----------------------------------------------------------------------------
# caching
# ----------------------------------------------------------------------------

def _cache_key(parts) -> str:
    return hashlib.sha1("|".join(str(p) for p in parts).encode()).hexdigest()[:16]


def save_examples(path: str, examples: List[dict]):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(
        path,
        audio=np.array([ex["input_values"] for ex in examples],
                       dtype=object),
        meta=json.dumps([{k: v for k, v in ex.items()
                          if k != "input_values"} for ex in examples]))


def load_examples(path: str) -> List[dict]:
    data = np.load(path, allow_pickle=True)
    metas = json.loads(str(data["meta"]))
    auds = data["audio"]
    out = []
    for meta, aud in zip(metas, auds):
        ex = dict(meta)
        ex["input_values"] = np.asarray(aud, np.float32)
        out.append(ex)
    return out


# ----------------------------------------------------------------------------
# top-level builders
# ----------------------------------------------------------------------------

def _batch_iter_factory(examples: List[dict], model, batch_size: int,
                        shuffle_seed: Optional[int] = None,
                        group_by_length: bool = True):
    ccfg = CollatorConfig(
        pad_token_id=model.config.decoder.pad_token_id,
        bos_token_id=model.tokenizer.bos_token_id,
        eos_token_id=model.config.decoder.eos_token_id,
        max_label_length=model.config.decoder.max_length,
        max_text_length=model.config.decoder.max_length,
        align_samples=model.config.encoder.aligned_samples)
    batcher = BucketBatcher(ccfg, batch_size, shuffle_seed=shuffle_seed,
                            group_by_length=group_by_length)

    def factory():
        return batcher(examples)

    return factory


def build_datasets(input_args, model, device=None, mesh=None) -> Tuple[
        Callable, Callable]:
    """(train_batches, eval_batches): zero-argument iterator factories of
    numpy batches; the train factory shuffles anew per call (epoch), the
    eval factory keeps its order.  `input_args` carries the JAX package's
    train.py options (batch, grad_accum, prompt, synthetic, dataset,
    custom_set, field, train_split, test_split, seed, cache,
    max_input_length_in_sec, worker, group_by_length, multihost); the
    teacher runs on `device` (default: the card).

    multihost: every rank batches the whole example list with the same
    seed (the same shuffle, bucket schedule and batch count everywhere) into
    global batches of batch * grad_accum * n_data rows and keeps its data
    rank's rows of each (``mesh.local_batch_index``: its share of every
    micro-batch); the model and seq ranks of one data shard get the same
    rows.  n_data and the data rank come from `mesh` (default: one data
    rank per process)."""
    n_data, data_rank = 1, 0
    if getattr(input_args, "multihost", False):
        from ..parallel import mesh as mesh_lib
        if mesh is not None:
            n_data, data_rank = mesh.n_data, mesh.data_rank
        else:
            n_data = mesh_lib.process_count()
            data_rank = mesh_lib.process_index()
    batch_size = int(input_args.batch) * int(input_args.grad_accum)
    prompt = input_args.prompt or ""
    use_teacher = True

    if getattr(input_args, "synthetic", False) or not (
            input_args.dataset or input_args.custom_set):
        train_raw = synthetic_corpus(256, seed=input_args.seed)
        eval_raw = synthetic_corpus(32, seed=input_args.seed + 1)
        # teacher targets presume a pretrained NLP model; with a fresh
        # decoder the synthetic path trains on the transcripts
        use_teacher = False
    elif input_args.custom_set:
        train_raw, eval_raw = _load_custom_csv(
            input_args.custom_set, seed=input_args.seed,
            workers=int(getattr(input_args, "worker", 1) or 1))
    else:
        train_raw = _load_hf_dataset(input_args.dataset, input_args.field,
                                     input_args.train_split)
        eval_raw = _load_hf_dataset(input_args.dataset, input_args.field,
                                    input_args.test_split)

    def prep(raw, split):
        cache_path = None
        if getattr(input_args, "cache", False):
            key = _cache_key([input_args.dataset or input_args.custom_set
                              or "synthetic",
                              model.config.encoder.name,
                              model.config.decoder.name,
                              input_args.field, split, prompt,
                              input_args.seed,
                              input_args.max_input_length_in_sec])
            cache_path = f"./.data_cache/{key}.npz"
            if os.path.exists(cache_path):
                return load_examples(cache_path)
        ex = prepare_examples(
            raw, model, prompt, use_teacher,
            workers=int(getattr(input_args, "worker", 1) or 1),
            device=device)
        ex = length_filter(ex, input_args.max_input_length_in_sec)
        if cache_path:
            save_examples(cache_path, ex)
        return ex

    train_ex = prep(train_raw, input_args.train_split or "train")
    eval_ex = prep(eval_raw, input_args.test_split or "eval")
    gbl = bool(getattr(input_args, "group_by_length", True))
    # train: a seeded shuffle per epoch; eval: a fixed order
    train_fac = _batch_iter_factory(train_ex, model, batch_size * n_data,
                                    shuffle_seed=int(input_args.seed),
                                    group_by_length=gbl)
    eval_fac = _batch_iter_factory(eval_ex, model, batch_size * n_data,
                                   group_by_length=gbl)
    if n_data > 1:
        accum = int(input_args.grad_accum)
        train_fac = _data_rank_factory(train_fac, n_data, data_rank, accum)
        eval_fac = _data_rank_factory(eval_fac, n_data, data_rank, 1)
    return train_fac, eval_fac


def _data_rank_factory(factory, n_data, data_rank, accum):
    """Wrap a global-batch iterator factory so that it yields only this
    data rank's rows of every batch."""
    from ..parallel.mesh import local_batch_index

    def wrapped():
        for batch in factory():
            rows = len(next(iter(batch.values())))
            idx = local_batch_index(rows, n_data, data_rank, accum)
            yield {k: v[idx] for k, v in batch.items()}

    return wrapped


def _load_custom_csv(path: str, seed: int = 0, test_size: float = 0.1,
                     workers: int = 1):
    """A CSV with `path` and `text` columns, split once with `seed`;
    workers > 1 loads and resamples the audio on a thread pool."""
    import csv
    rows = []
    with open(path) as f:
        for row in csv.DictReader(f):
            rows.append(row)
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(rows))
    n_test = max(1, int(len(rows) * test_size))
    test_idx = set(idx[:n_test].tolist())

    def load_row(row):
        wav, sr = _read_audio(row["path"])
        wav = audio_lib.resample(audio_lib.to_mono(wav), sr)
        return {"audio": wav, "text": row["text"]}

    if workers > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=workers) as pool:
            loaded = list(pool.map(load_row, rows))
    else:
        loaded = [load_row(r) for r in rows]
    train = [ex for i, ex in enumerate(loaded) if i not in test_idx]
    test = [ex for i, ex in enumerate(loaded) if i in test_idx]
    return train, test


def _read_audio(path: str):
    """A WAV / FLAC reader: soundfile if installed, else the standard
    library's wave (PCM WAV of 8, 16, 24 or 32 bits)."""
    try:
        import soundfile as sf
    except ImportError:
        sf = None
    if sf is not None:
        wav, sr = sf.read(path, dtype="float32")
        return wav.T if wav.ndim == 2 else wav, sr
    import wave
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        raw = w.readframes(n)
        width = w.getsampwidth()
        if width == 1:
            # 8-bit WAV PCM is unsigned, biased at 128
            data = (np.frombuffer(raw, np.uint8).astype(np.float32)
                    - 128.0) / 128.0
        elif width == 3:
            # 24-bit little-endian: widen to int32 through a zero byte
            b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
            b = np.concatenate([np.zeros((len(b), 1), np.uint8), b], axis=1)
            data = (b.view(np.int32).reshape(-1) >> 8).astype(
                np.float32) / float(2 ** 23 - 1)
        else:
            dtype = {2: np.int16, 4: np.int32}[width]
            data = np.frombuffer(raw, dtype=dtype).astype(np.float32)
            data /= float(np.iinfo(dtype).max)
        if w.getnchannels() > 1:
            data = data.reshape(-1, w.getnchannels()).mean(axis=1)
    return data, sr


def _load_hf_dataset(name, field, split):
    """An HF dataset from the local cache (``datasets`` is imported here
    only), its audio cast to 16 kHz."""
    from datasets import Audio, load_dataset
    ds = load_dataset(name, field, split=split)
    ds = ds.cast_column("audio", Audio(sampling_rate=16000))
    out = []
    for ex in ds:
        text = ex.get("text", ex.get("sentence", ""))
        out.append({"audio": np.asarray(ex["audio"]["array"], np.float32),
                    "text": text})
    return out


def load_librispeech_dir(root: str, max_utts: Optional[int] = None,
                         workers: int = 8) -> List[dict]:
    """An on-disk LibriSpeech split (<spk>/<chapter>/<spk>-<chapter>-<utt>
    .flac beside <spk>-<chapter>.trans.txt lines "<utt_id> TRANSCRIPT") as
    [{'audio': 1-D float32 at 16 kHz, 'text': str}], sorted by utterance
    id."""
    pairs = []  # (utt_id, flac_path, text)
    for dirpath, _, files in sorted(os.walk(root)):
        for fname in sorted(files):
            if not fname.endswith(".trans.txt"):
                continue
            with open(os.path.join(dirpath, fname)) as f:
                for line in f:
                    utt_id, _, text = line.strip().partition(" ")
                    flac = os.path.join(dirpath, utt_id + ".flac")
                    if text and os.path.exists(flac):
                        pairs.append((utt_id, flac, text))
    pairs.sort()
    if max_utts:
        pairs = pairs[:max_utts]

    def load_one(item):
        _, flac, text = item
        wav, sr = _read_audio(flac)
        return {"audio": audio_lib.resample(audio_lib.to_mono(wav), sr),
                "text": text}

    if workers > 1 and len(pairs) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return list(pool.map(load_one, pairs))
    return [load_one(p) for p in pairs]
