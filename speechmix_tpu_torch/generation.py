"""Greedy and beam-search generation (port of ``speechmix_tpu.generation``).

The speech encoder and the text encoder run once (the ``ed`` variant has no
text-encoder pass: its decoder attends the projected speech states; the
``adapter`` variant runs its adapters after every text-encoder block and
every cached decoder step's block; ``self`` and ``gan`` generate as ``eed``);
cross-attention K/V are precomputed per layer (optionally as int8 codes,
``kv_int8``); the decode loops run a fixed ``max_length`` steps, with
padding after each row's EOS.
Neither loop reads a value back to the host, so the card is not held up by
the Python loop's checks.

Sampling, the HF logits processors, ``early_stop``, group and constrained
beam search are not ported yet: ``generate`` raises NotImplementedError
when asked for any of them.
"""

from __future__ import annotations

import torch

from .config import SpeechMixConfig
from .models import seq2seq
from .models import speechmix as smx
from .ops.kernels._cuda import resolve_device
from .ops.kernels.beam_gather import beam_gather

# generate() keyword arguments of the JAX package that select a path this
# port does not have yet, with the value that leaves them off
_NOT_PORTED = {
    "early_stop": False, "do_sample": False, "temperature": 1.0, "top_k": 0,
    "top_p": 1.0, "typical_p": 1.0, "rng": None, "min_length": 0,
    "repetition_penalty": 1.0, "no_repeat_ngram_size": 0,
    "forced_bos_token_id": None, "forced_eos_token_id": None,
    "bad_words_ids": None, "suppress_tokens": None,
    "begin_suppress_tokens": None, "num_beam_groups": 1,
    "diversity_penalty": 0.0,
    "encoder_no_repeat_ngram_size": 0, "encoder_input_ids": None,
    "prefix_allowed_tokens_fn": None, "force_words_ids": None,
}


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return torch.as_tensor(tree).to(device)


@torch.no_grad()
def greedy_decode(params, dcfg, enc_hidden, enc_mask, max_length,
                  dtype=torch.float32, kv_int8=False, output_scores=False,
                  lm_head=None, adapters=None):
    """Greedy decode against a text-encoder output.  Returns (tokens
    (B, max_length) with pad_token_id after EOS, the EOS itself included,
    lengths (B,)); with output_scores also the per-step logits
    (max_length, B, V) float32.  kv_int8 keeps the cross K/V as int8 codes;
    lm_head is the tied head's operand of seq2seq.tied_head_operand, made
    once for all steps (None: each step makes it); adapters: the adapter
    variant's, run after each decoder block."""
    b = enc_hidden.shape[0]
    device = enc_hidden.device
    cache = seq2seq.init_decoder_cache(params, dcfg, enc_hidden, b,
                                       max_length, dtype, kv_int8=kv_int8)
    tok = torch.full((b, 1), dcfg.decoder_start_token_id, dtype=torch.long,
                     device=device)
    finished = torch.zeros(b, dtype=torch.bool, device=device)
    pad = torch.full((b,), dcfg.pad_token_id, dtype=torch.long, device=device)
    steps, scores = [], []
    for _ in range(max_length):
        out = seq2seq.decode(params, dcfg, tok, enc_mask, cache, dtype,
                             lm_head=lm_head, adapters=adapters)
        cache = out["cache"]
        logits = out["logits"][:, -1, :]
        next_tok = torch.argmax(logits, dim=-1)
        next_tok = torch.where(finished, pad, next_tok)
        finished = finished | (next_tok == dcfg.eos_token_id)
        steps.append(next_tok)
        if output_scores:
            scores.append(logits)
        tok = next_tok[:, None]
    tokens = torch.stack(steps, dim=1)
    lengths = (tokens != dcfg.pad_token_id).sum(dim=1)
    if output_scores:
        return tokens, lengths, torch.stack(scores)
    return tokens, lengths


# ----------------------------------------------------------------------------
# beam search
# ----------------------------------------------------------------------------

def _topk_stable(x, k):
    """Top k of the last axis, descending, equal values in index order (the
    order of jax.lax.top_k; torch.topk promises none).  A stable sort: for
    the small (B, 2K) and (B, 3K) arrays of the beam step."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _topk_lowest_index(x, k):
    """The same result as _topk_stable for a wide last axis (the vocabulary)
    without sorting it.  The k-th largest value is the threshold: every
    greater column is chosen, and of the columns equal to it the lowest
    indices, as many as are missing; the k chosen columns are then put in
    (value descending, index ascending) order."""
    thr = torch.topk(x, k, dim=-1).values[..., -1:]
    greater = x > thr
    equal = x == thr
    missing = k - greater.sum(-1, keepdim=True)
    chosen = greater | (equal & (equal.cumsum(-1) <= missing))
    # exactly k columns are chosen: topk of the 0/1 mask finds that set
    idx = torch.topk(chosen.to(torch.uint8), k, dim=-1).indices
    idx = torch.sort(idx, dim=-1).values
    vals, order = torch.sort(x.gather(-1, idx), dim=-1, descending=True,
                             stable=True)
    return vals, idx.gather(-1, order)


def _topk_over_beams(scores3, k2):
    """Top k2 over the flattened (K, V) axes of scores3 (B, K, V): values
    and flat indices, equal values in flat-index order.  A per-beam top-k2
    prepass and a (B, K * k2) merge, as the JAX package computes it."""
    b, k, v = scores3.shape
    if k == 1 or k2 > v:
        return _topk_lowest_index(scores3.reshape(b, k * v), k2)
    vals, idx = _topk_lowest_index(scores3.reshape(b * k, v), k2)
    flat = (idx.reshape(b, k, k2)
            + (torch.arange(k, device=idx.device) * v)[None, :, None])
    top_v, pos = _topk_stable(vals.reshape(b, k * k2), k2)
    return top_v, flat.reshape(b, k * k2).gather(1, pos)


def _gather_cache(cache, idx, batch, beams, spare):
    """Reorder the self-attention cache on the beam axis: row (b, o) takes
    row (b, idx[b, o]).  K5 on the card, the plain gather on the CPU, written
    into the `spare` (key, value) buffers; the old buffers are the next
    spare.  Cross K/V and scales are shared by the beams of an input and are
    not gathered.  Returns (cache, spare)."""
    sk = cache.self_kv
    flat_src = (torch.arange(batch, device=idx.device)[:, None] * beams
                + idx).reshape(-1).to(torch.int32)
    new_k, new_v = beam_gather(sk.key, sk.value, flat_src, out=spare)
    new_self = sk._replace(key=new_k, value=new_v)
    return cache._replace(self_kv=new_self), (sk.key, sk.value)


@torch.no_grad()
def beam_search(params, dcfg, enc_hidden, enc_mask, max_length, num_beams=4,
                length_penalty=1.0, dtype=torch.float32, early_stopping=False,
                kv_int8=False, num_return_sequences=1, output_scores=False,
                lm_head=None, adapters=None):
    """Batched beam search with HuggingFace `generate()` semantics, as the
    JAX package's `beam_search`:

      * 2 * num_beams candidate continuations per step, so at least
        num_beams non-EOS beams always survive;
      * hypotheses finishing on EOS (or at max length) move to a finished
        set scored sum_logprobs / num_generated ** length_penalty; running
        beams keep raw cumulative log-probs;
      * the early-stop heuristic (early_stopping False | True | "never")
        stops a row when the best possible running score can no longer beat
        its worst finished score;
      * `max_length` counts generated tokens.

    One cross K/V per input row: the num_beams beams of an input share it
    (seq2seq._cross_attention), and only the self-attention cache is
    reordered each step, between two buffers (K5 cannot permute in place).

    The loop always runs max_length decoder steps and never reads a value
    back to the host: once the JAX loop's condition is false the search
    state is frozen, so the result is the one an early exit would give.

    lm_head, adapters: as for greedy_decode.

    Returns (tokens (B * num_return_sequences, max_length): the top finished
    beams per row in score order, pad after EOS; lengths); with
    output_scores also `sequences_scores` (B * num_return_sequences,), the
    length-penalised final beam scores."""
    b = enc_hidden.shape[0]
    k, k2, s_max = num_beams, 2 * num_beams, max_length
    device = enc_hidden.device
    pad, eos = dcfg.pad_token_id, dcfg.eos_token_id
    nret = num_return_sequences
    if nret > k:
        raise ValueError(
            f"num_return_sequences ({nret}) must be <= num_beams ({k})")
    f32 = dict(dtype=torch.float32, device=device)
    neg = torch.tensor(-1e9, **f32)
    zero = torch.zeros((), **f32)

    cache = seq2seq.init_decoder_cache(params, dcfg, enc_hidden, b * k, s_max,
                                       dtype, kv_int8=kv_int8)
    spare = (torch.empty_like(cache.self_kv.key),
             torch.empty_like(cache.self_kv.value))
    last_tok = torch.full((b * k, 1), dcfg.decoder_start_token_id,
                          dtype=torch.long, device=device)
    state = dict(
        running_seqs=torch.full((b, k, s_max), pad, dtype=torch.long,
                                device=device),
        # only beam 0 live at step 0 (prevents k copies of the same prefix)
        running_scores=torch.tensor([0.0] + [-1e9] * (k - 1), **f32)
        .expand(b, k).contiguous(),
        finished_seqs=torch.full((b, k, s_max), pad, dtype=torch.long,
                                 device=device),
        finished_scores=torch.full((b, k), -1e9, **f32),
        is_finished=torch.zeros((b, k), dtype=torch.bool, device=device),
        # per-row latch: can a running beam still improve the finished set
        unsat=torch.ones((b, 1), dtype=torch.bool, device=device),
        valid_cont=torch.ones((), dtype=torch.bool, device=device),
    )
    # (s + 1) ** length_penalty for every step, in float32 on the device
    len_pow = torch.arange(1, s_max + 1, **f32) ** length_penalty
    if early_stopping == "never" and length_penalty > 0.0:
        best_pow = len_pow[s_max - 1].expand(s_max)
    else:
        best_pow = len_pow
    top_half = (torch.arange(k2, device=device) < k)[None, :]

    def gather(x, idx):
        """(B, N, ...) gathered to (B, idx.shape[1], ...)"""
        view = idx.reshape(b, idx.shape[1], *([1] * (x.ndim - 2)))
        return x.gather(1, view.expand(b, idx.shape[1], *x.shape[2:]))

    for s in range(s_max):
        c = state
        active = c["unsat"].any() & c["valid_cont"]
        if early_stopping is True:
            active = active & ~c["is_finished"].all()

        out = seq2seq.decode(params, dcfg, last_tok, enc_mask, cache, dtype,
                             lm_head=lm_head, adapters=adapters)
        logp = torch.log_softmax(out["logits"][:, -1, :].float(), dim=-1)
        vocab = logp.shape[-1]
        acc = logp.reshape(b, k, vocab) + c["running_scores"][:, :, None]
        topk_scores, topk_idx = _topk_over_beams(acc, k2)     # (B, 2K)
        src_beam = topk_idx // vocab
        tok = topk_idx % vocab
        topk_seqs = gather(c["running_seqs"], src_beam)       # (B, 2K, S)
        topk_seqs[:, :, s] = tok
        hits = tok == eos
        if s + 1 >= s_max:
            hits = torch.ones_like(hits)

        # running beams for the next iteration: best k non-finished
        run_masked = topk_scores + torch.where(hits, neg, zero)
        new_running_scores, run_sel = _topk_stable(run_masked, k)
        new_running_seqs = gather(topk_seqs, run_sel)
        run_src = src_beam.gather(1, run_sel)                 # (B, K)
        last_tok = tok.gather(1, run_sel).reshape(b * k, 1)
        cache, spare = _gather_cache(out["cache"], run_src, b, k, spare)

        # finished set: only the top num_beams candidates may finalize
        did_finish = hits & top_half
        pen = topk_scores / len_pow[s]
        if early_stopping is True:
            pen = pen + torch.where(
                c["is_finished"].all(dim=1, keepdim=True), neg, zero)
        pen = pen + torch.where(c["unsat"], zero, neg)    # heuristic latch
        pen = pen + torch.where(did_finish, zero, neg)
        merged_scores = torch.cat([c["finished_scores"], pen], dim=1)
        merged_seqs = torch.cat([c["finished_seqs"], topk_seqs], dim=1)
        merged_fin = torch.cat([c["is_finished"], did_finish], dim=1)
        fin_scores, fin_sel = _topk_stable(merged_scores, k)
        fin_seqs = gather(merged_seqs, fin_sel)
        is_fin = merged_fin.gather(1, fin_sel)

        # early-stop heuristic: the best of the full 2K candidate pool at its
        # most favourable length against the worst finished score
        best_possible = topk_scores[:, :1] / best_pow[s]      # (B, 1)
        worst_fin = torch.where(
            is_fin, fin_scores.min(dim=1, keepdim=True).values, neg)
        unsat = c["unsat"] & (best_possible > worst_fin).any(
            dim=-1, keepdim=True)

        new = dict(running_seqs=new_running_seqs,
                   running_scores=new_running_scores, finished_seqs=fin_seqs,
                   finished_scores=fin_scores, is_finished=is_fin,
                   unsat=unsat, valid_cont=~hits.all())
        state = {name: torch.where(active, new[name], c[name])
                 for name in new}

    # the finished set is score-sorted: rows 0..nret-1 are the return set
    best_seqs = state["finished_seqs"][:, :nret, :].reshape(b * nret, s_max)
    lengths = (best_seqs != pad).sum(dim=1)
    if output_scores:
        return (best_seqs, lengths,
                state["finished_scores"][:, :nret].reshape(b * nret))
    return best_seqs, lengths


@torch.no_grad()
def generate(params, cfg: SpeechMixConfig, input_values, lengths=None,
             prompt_ids=None, max_length=None, num_beams=1,
             length_penalty=1.0, dtype=torch.float32, early_stopping=False,
             kv_int8=False, num_return_sequences=1, output_scores=False,
             device=None, max_new_tokens=None, **kwargs):
    """Waveform -> fused embeddings -> text encoder (once; not for the ed
    variant) -> cached greedy decode (num_beams <= 1) or beam search.
    input_values: (B, T_samples) zero-padded waveform; lengths: (B,) valid
    sample counts.  Runs on `device` (default: the card); params and inputs
    are moved there.
    Returns (tokens (B * num_return_sequences, max_length), lengths); with
    output_scores a third value: the per-step logits (max_length, B, V) for
    greedy, the length-penalised sequences_scores for beam search.
    num_return_sequences > 1 needs num_beams > 1 (the top beams per input).
    kv_int8 stores the cross K/V as int8 codes.  max_new_tokens, when given,
    takes precedence over max_length (HF precedence).  Any other keyword of
    the JAX package's generate() that is switched on raises
    NotImplementedError."""
    for name, value in kwargs.items():
        if name not in _NOT_PORTED:
            raise TypeError(f"generate() got an unexpected keyword {name!r}")
        off = _NOT_PORTED[name]
        if not (value is off or (off is not None and value == off)):
            raise NotImplementedError(f"generate({name}=...) is not ported "
                                      "yet")
    if num_beams <= 1 and num_return_sequences > 1:
        raise ValueError("num_return_sequences > 1 requires num_beams > 1 "
                         "(HF greedy contract; sampling is not ported)")
    smx._check_supported(cfg)
    device = resolve_device(device)
    if max_new_tokens is not None:
        max_length = max_new_tokens
    max_length = max_length or cfg.decoder.max_length
    params = _to_device(params, device)
    input_values = torch.as_tensor(input_values).to(device)
    if lengths is not None:
        lengths = torch.as_tensor(lengths).to(device)
    if prompt_ids is not None:
        prompt_ids = torch.as_tensor(prompt_ids).to(device)
    inputs_embeds, enc_mask = smx.encode_speech(
        params, cfg, input_values, lengths, prompt_ids, dtype)
    adapters = params["adapters"] if cfg.variant == "adapter" else None
    if cfg.variant == "ed":
        # the decoder cross-attends the projected speech states: no
        # text-encoder pass (as in the training forward)
        enc_hidden = inputs_embeds
    else:
        enc_hidden = seq2seq.encode(params["nlp"], cfg.decoder,
                                    inputs_embeds=inputs_embeds,
                                    attention_mask=enc_mask, dtype=dtype,
                                    adapters=adapters)["last_hidden_state"]
    lm_head = seq2seq.tied_head_operand(params["nlp"], cfg.decoder, dtype)
    if num_beams <= 1:
        return greedy_decode(params["nlp"], cfg.decoder, enc_hidden, enc_mask,
                             max_length, dtype, kv_int8=kv_int8,
                             output_scores=output_scores, lm_head=lm_head,
                             adapters=adapters)
    return beam_search(params["nlp"], cfg.decoder, enc_hidden, enc_mask,
                       max_length, num_beams, length_penalty, dtype,
                       early_stopping=early_stopping, kv_int8=kv_int8,
                       num_return_sequences=num_return_sequences,
                       output_scores=output_scores, lm_head=lm_head,
                       adapters=adapters)
