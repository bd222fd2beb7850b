"""Teacher targets (port of ``speechmix_tpu.data.teacher``): batched greedy
decode of the frozen NLP model on the card.

The reference's ``create_self_decoder_input`` makes each training label by
letting the frozen NLP model greedily decode the ground-truth transcript,
one example at a time.  Here the same semantics run as one batched decode
per chunk: the text encoder (K1-K3 where the row gate admits its blocks)
and ``generation.greedy_decode`` (K4 in every cached step):

  labels = the teacher's greedy output on the tokenized text, cut at EOS,
  then the tokenizer's EOS appended.

Text lengths snap to a power-of-two grid (``_text_bucket``), as in the JAX
package, so that a run sees few shapes.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..config import Seq2SeqConfig
from ..generation import _to_device, greedy_decode
from ..models import seq2seq
from ..ops.kernels._cuda import resolve_device


def _text_bucket(n: int, floor: int = 16) -> int:
    """Smallest power of two >= n (at least `floor`): the text-length grid
    of teacher decoding."""
    b = floor
    while b < n:
        b *= 2
    return b


@torch.no_grad()
def create_self_decoder_inputs_batched(
        params, dcfg: Seq2SeqConfig, tokenizer, sentences: Sequence[str],
        max_length=None, batch_size: int = 32, device=None,
) -> List[Tuple[List[int], List[int]]]:
    """[(text_input_ids, labels_with_eos), ...] per sentence: the labels are
    the teacher's greedy prediction, its trailing EOS (if any) replaced by
    the tokenizer's; float32, as the JAX package's make_teacher_fn.
    `params`: the NLP model's (``params["nlp"]``), moved to `device`
    (default: the card; raises without CUDA)."""
    device = resolve_device(device)
    params = _to_device(params, device)
    max_length = max_length or dcfg.max_length
    encoded = [tokenizer.encode(s, add_special_tokens=True)
               for s in sentences]
    out = []
    for start in range(0, len(encoded), batch_size):
        chunk = encoded[start: start + batch_size]
        real = len(chunk)
        # pad the chunk to a full batch: one shape per text bucket
        while len(chunk) < batch_size:
            chunk.append(chunk[-1])
        t_len = _text_bucket(max(len(c) for c in chunk))
        ids = np.full((batch_size, t_len), dcfg.pad_token_id, np.int64)
        mask = np.zeros((batch_size, t_len), bool)
        for i, c in enumerate(chunk):
            ids[i, : len(c)] = c
            mask[i, : len(c)] = True
        enc_out = seq2seq.encode(params, dcfg,
                                 input_ids=torch.from_numpy(ids).to(device),
                                 attention_mask=torch.from_numpy(mask).to(
                                     device))
        tokens, lengths = greedy_decode(params, dcfg,
                                        enc_out["last_hidden_state"],
                                        enc_out["mask"], max_length)
        tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
        for i in range(real):
            toks = tokens[i][: lengths[i]].tolist()
            # greedy_decode keeps the EOS it emitted; the reference stops
            # before EOS and appends the tokenizer's: strip, then append
            if toks and toks[-1] == dcfg.eos_token_id:
                toks = toks[:-1]
            toks.append(tokenizer.eos_token_id)
            out.append((encoded[start + i], toks))
    return out
