"""Static-shape bucketed batching (port of ``speechmix_tpu.data.collator``).

The reference's DataCollatorWithPadding with its quirks fixed, as in the
JAX package:
  * audio padded with 0.0 (not -100) and explicit ``lengths``;
  * labels padded with -100 (the ignore index), a label cut at
    ``max_label_length`` ending in EOS again;
  * text_input_ids padded with pad_token_id;
  * a leading BOS stripped when the tokenizer always adds it;
  * every batch of a bucket has the same shapes.

``BucketBatcher`` groups examples by audio bucket and yields dicts of numpy
arrays; the final partial batch of a bucket is filled with repeated
examples and ``example_mask`` marks the real rows.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from . import audio as audio_lib


@dataclass
class CollatorConfig:
    buckets_sec: Sequence[float] = audio_lib.DEFAULT_BUCKETS
    sample_rate: int = 16000
    max_label_length: int = 128
    max_text_length: int = 128
    pad_token_id: int = 0
    bos_token_id: Optional[int] = None
    # when set, a label sequence cut at max_label_length gets EOS as its
    # last token again (else long utterances would train the model never to
    # emit EOS)
    eos_token_id: Optional[int] = None
    label_pad: int = -100
    # optional sample-count aligner (SpeechEncoderConfig.aligned_samples):
    # pads bucket lengths so that the conv frame count is 8-aligned
    align_samples: Optional[Callable[[int], int]] = None


def collate(examples: List[dict], cfg: CollatorConfig,
            audio_target_len: int) -> Dict[str, np.ndarray]:
    """examples: dicts with input_values (1-D float), labels (list[int]),
    optionally text_input_ids (list[int])."""
    b = len(examples)
    input_values = np.zeros((b, audio_target_len), np.float32)
    lengths = np.zeros((b,), np.int32)
    labels = np.full((b, cfg.max_label_length), cfg.label_pad, np.int64)
    has_text = "text_input_ids" in examples[0]
    text_ids = np.full((b, cfg.max_text_length), cfg.pad_token_id, np.int64) \
        if has_text else None

    for i, ex in enumerate(examples):
        wav = np.asarray(ex["input_values"], np.float32)[:audio_target_len]
        input_values[i, : len(wav)] = wav
        lengths[i] = len(wav)
        lab = list(ex["labels"])
        # strip a leading BOS if the tokenizer always adds one
        if cfg.bos_token_id is not None and lab and \
                lab[0] == cfg.bos_token_id:
            lab = lab[1:]
        if len(lab) > cfg.max_label_length:
            lab = lab[: cfg.max_label_length]
            if cfg.eos_token_id is not None and \
                    lab[-1] != cfg.eos_token_id:
                lab[-1] = cfg.eos_token_id
        labels[i, : len(lab)] = lab
        if has_text:
            t = list(ex["text_input_ids"])[: cfg.max_text_length]
            text_ids[i, : len(t)] = t

    batch = {"input_values": input_values, "lengths": lengths,
             "labels": labels}
    if has_text:
        batch["text_input_ids"] = text_ids
    return batch


class BucketBatcher:
    """Groups examples into static-shape bucketed batches.

    shuffle_seed: when set, every call (= every epoch) shuffles the example
    order with RandomState(shuffle_seed + epoch), the per-epoch sampler of
    the reference's Trainer; the epoch counter counts calls.

    group_by_length: True pads each example to its length bucket; False
    pads every example to the largest bucket (one shape).
    """

    def __init__(self, cfg: CollatorConfig, batch_size: int,
                 drop_too_long: bool = True,
                 shuffle_seed: Optional[int] = None,
                 group_by_length: bool = True):
        self.cfg = cfg
        self.batch_size = batch_size
        self.drop_too_long = drop_too_long
        self.shuffle_seed = shuffle_seed
        self.group_by_length = group_by_length
        self.epoch = 0

    def __call__(self, examples: Iterable[dict]) -> Iterator[dict]:
        if self.shuffle_seed is not None:
            examples = list(examples)
            order = np.random.RandomState(
                self.shuffle_seed + self.epoch).permutation(len(examples))
            examples = [examples[i] for i in order]
            self.epoch += 1
        max_cap = int(self.cfg.buckets_sec[-1] * self.cfg.sample_rate)
        pools: Dict[int, List[dict]] = defaultdict(list)
        for ex in examples:
            n = len(ex["input_values"])
            cap = audio_lib.bucket_length(n, self.cfg.buckets_sec,
                                          self.cfg.sample_rate)
            if cap is None:
                if self.drop_too_long:
                    continue
                cap = max_cap
            if not self.group_by_length:
                cap = max_cap
            if self.cfg.align_samples is not None:
                cap = self.cfg.align_samples(cap)
            pools[cap].append(ex)
            if len(pools[cap]) == self.batch_size:
                batch = collate(pools[cap], self.cfg, cap)
                batch["example_mask"] = np.ones(self.batch_size, bool)
                pools[cap] = []
                yield batch
        # flush the partial pools, filled with repeats
        for cap, pool in pools.items():
            if not pool:
                continue
            real = len(pool)
            while len(pool) < self.batch_size:
                pool.append(pool[len(pool) % real])
            batch = collate(pool, self.cfg, cap)
            mask = np.zeros(self.batch_size, bool)
            mask[:real] = True
            batch["example_mask"] = mask
            yield batch
