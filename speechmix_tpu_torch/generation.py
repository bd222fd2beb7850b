"""Generation: greedy and sampled decode, beam search and beam-sample, group
and constrained beam search (port of ``speechmix_tpu.generation``).

The speech encoder and the text encoder run once (the ``ed`` variant has no
text-encoder pass: its decoder attends the projected speech states; the
``adapter`` variant runs its adapters after every text-encoder block and
every cached decoder step's block; ``self`` and ``gan`` generate as ``eed``);
cross-attention K/V are precomputed per layer (optionally as int8 codes,
``kv_int8``); the decode loops run a fixed ``max_length`` steps, with
padding after each row's EOS.  The HF logits processors, the sampling
filters, the draws and the beam and constraint bookkeeping are plain
PyTorch on the decode loop's device, as the JAX package computes them in
XLA outside any Pallas kernel.

No loop reads a value back to the host, with two exceptions:
  * ``early_stop`` (greedy): each step's all-rows-finished flag is copied
    into pinned host memory behind a CUDA event and read
    ``_EARLY_STOP_LAG`` steps later, so the card is never waited on while
    it has work queued; the loop runs one step more than the JAX loop, and
    that step writes only pad;
  * ``prefix_allowed_tokens_fn``: the user's function runs on the host each
    step on the sequence so far, one read-back per step, as the JAX
    package's ``pure_callback``.

Sampling draws its noise from a ``torch.Generator`` on the device
(``_gumbel``), so its tokens are reproducible for one seed on one backend;
they are not the JAX package's tokens for the same seed (the streams
differ), except where a test feeds the port JAX's own draws.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from .config import SpeechMixConfig
from .models import seq2seq
from .models import speechmix as smx
from .ops.kernels._cuda import resolve_device
from .ops.kernels.beam_gather import beam_gather
from .utils import profiling

# steps between a greedy step and the read of its all-finished flag
_EARLY_STOP_LAG = 2
_NEG_INF = float("-inf")


def _steps(n):
    """range(n) for a decode loop: each step inside a ``decode.step``
    span."""
    for t in range(n):
        with profiling.annotate("decode.step"):
            yield t


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return torch.as_tensor(tree).to(device)


# ----------------------------------------------------------------------------
# HF LogitsProcessor stack
# ----------------------------------------------------------------------------

def _needs_history(repetition_penalty=1.0, no_repeat_ngram_size=0,
                   bad_words_ids=None, encoder_no_repeat_ngram_size=0,
                   prefix_allowed_tokens_fn=None, **_):
    """Whether the processor stack needs the sequence so far."""
    multi = any(len(w) > 1 for w in (bad_words_ids or ()))
    return (repetition_penalty != 1.0 or no_repeat_ngram_size > 0 or multi
            or encoder_no_repeat_ngram_size > 0
            or prefix_allowed_tokens_fn is not None)


def _ngram_bans(hist, prev, n_windows, v):
    """(N, V) bool: hist[:, j + m] is banned where the m = prev.shape[1]
    tokens of `hist` from column j equal `prev`, for j < n_windows (the
    next token may not complete an n-gram that `hist` holds)."""
    n, m = prev.shape
    match = torch.ones((n, n_windows), dtype=torch.bool, device=hist.device)
    for i in range(m):
        match &= hist[:, i: i + n_windows] == prev[:, i: i + 1]
    return torch.zeros((n, v), dtype=torch.int32, device=hist.device) \
        .scatter_add_(1, hist[:, m: m + n_windows],
                      match.to(torch.int32)) > 0


class _Processors:
    """HF's LogitsProcessor stack on (N, V) float32 scores, in transformers'
    order: RepetitionPenalty -> NoRepeatNGram -> EncoderNoRepeatNGram ->
    NoBadWords -> MinLength -> PrefixConstrained -> ForcedBOS -> ForcedEOS
    -> SuppressTokens -> SuppressTokensAtBegin, as the JAX package's
    ``_process_logits_hf``.  Its index tensors are made on `device` once,
    so a decode step copies nothing from the host (except for
    prefix_allowed_tokens_fn, which runs on the host each step).

    encoder_input_ids: (N, S_enc) already tiled to the row count.
    prefix_beams: rows per input, the divisor of batch_id = row //
    prefix_beams handed to prefix_allowed_tokens_fn(batch_id, seq), where
    seq is the int32 numpy sequence so far, decoder start included."""

    def __init__(self, dcfg, max_length, device, repetition_penalty=1.0,
                 no_repeat_ngram_size=0, min_length=0,
                 forced_bos_token_id=None, forced_eos_token_id=None,
                 bad_words_ids=None, suppress_tokens=None,
                 begin_suppress_tokens=None, encoder_no_repeat_ngram_size=0,
                 encoder_input_ids=None, prefix_allowed_tokens_fn=None,
                 prefix_beams=1):
        index = lambda ids: torch.as_tensor(  # noqa: E731
            [int(t) for t in ids], dtype=torch.long, device=device)
        self.eos = dcfg.eos_token_id
        self.max_length = max_length
        self.penalty = (None if repetition_penalty == 1.0 else torch.tensor(
            repetition_penalty, dtype=torch.float32, device=device))
        self.no_repeat = no_repeat_ngram_size
        self.enc_no_repeat, self.enc_ids = 0, None
        if encoder_no_repeat_ngram_size > 0 and encoder_input_ids is not None:
            self.enc_no_repeat = encoder_no_repeat_ngram_size
            self.enc_ids = torch.as_tensor(encoder_input_ids).to(
                device=device, dtype=torch.long)
        # NoBadWords: HF drops a bad word equal to [eos]
        words = [[int(t) for t in w] for w in (bad_words_ids or ())]
        words = [w for w in words if w != [dcfg.eos_token_id]]
        single = [w[0] for w in words if len(w) == 1]
        self.bad_single = index(single) if single else None
        self.bad_multi = [(index(w[:-1]), w[-1]) for w in words
                          if len(w) > 1]
        self.min_length = min_length
        self.prefix_fn, self.prefix_beams = (prefix_allowed_tokens_fn,
                                             prefix_beams)
        self.forced_bos, self.forced_eos = (forced_bos_token_id,
                                            forced_eos_token_id)
        self.suppress = index(suppress_tokens) if suppress_tokens else None
        self.begin_suppress = (index(begin_suppress_tokens)
                               if begin_suppress_tokens else None)
        self.needs_history = _needs_history(
            repetition_penalty, no_repeat_ngram_size, bad_words_ids,
            self.enc_no_repeat, prefix_allowed_tokens_fn)

    def __call__(self, logits, step_idx, fullbuf=None):
        """step_idx: tokens generated so far (HF's cur_len is step_idx + 1);
        fullbuf: (N, S) [decoder_start] + generated tokens, pad past
        step_idx + 1, when needs_history."""
        n, v = logits.shape
        seq_len = step_idx + 1
        if self.penalty is not None:
            seen = torch.zeros((n, v), dtype=torch.bool, device=logits.device)
            seen.scatter_(1, fullbuf[:, :seq_len], True)
            p = self.penalty
            logits = torch.where(
                seen, torch.where(logits > 0, logits / p, logits * p), logits)
        if self.no_repeat > 0:
            m = self.no_repeat - 1
            n_windows = seq_len - m    # windows whose last token is written
            if n_windows > 0:
                banned = _ngram_bans(fullbuf, fullbuf[:, seq_len - m:seq_len],
                                     n_windows, v)
                logits = logits.masked_fill(banned, _NEG_INF)
        if self.enc_no_repeat > 0:
            # no ban until the decoder history holds m tokens (HF)
            m = self.enc_no_repeat - 1
            n_windows = self.enc_ids.shape[1] - m
            if n_windows > 0 and seq_len >= m:
                banned = _ngram_bans(self.enc_ids,
                                     fullbuf[:, seq_len - m:seq_len],
                                     n_windows, v)
                logits = logits.masked_fill(banned, _NEG_INF)
        if self.bad_single is not None or self.bad_multi:
            ban = torch.zeros((n, v), dtype=torch.bool, device=logits.device)
            if self.bad_single is not None:
                ban.index_fill_(1, self.bad_single, True)
            for prefix, last in self.bad_multi:
                m = prefix.shape[0]
                if seq_len >= m:
                    match = (fullbuf[:, seq_len - m:seq_len]
                             == prefix[None, :]).all(dim=1)
                    ban[:, last] |= match
            logits = logits.masked_fill(ban, _NEG_INF)
        if self.min_length > 0 and step_idx < self.min_length - 1:
            # EOS unreachable until min_length generated tokens (EOS
            # included) are possible: HF's min_length - 1
            logits = logits.clone()
            logits[:, self.eos] = _NEG_INF
        if self.prefix_fn is not None:
            logits = logits.masked_fill(
                ~self._prefix_allowed(fullbuf, seq_len, n, v), _NEG_INF)
        if self.forced_bos is not None and step_idx == 0:
            logits = torch.full_like(logits, _NEG_INF)
            logits[:, self.forced_bos] = 0.0
        if self.forced_eos is not None and step_idx == self.max_length - 1:
            logits = torch.full_like(logits, _NEG_INF)
            logits[:, self.forced_eos] = 0.0
        if self.suppress is not None:
            logits = logits.index_fill(1, self.suppress, _NEG_INF)
        if self.begin_suppress is not None and step_idx == 0:
            # SuppressTokensAtBegin fires on the first generated token
            logits = logits.index_fill(1, self.begin_suppress, _NEG_INF)
        return logits

    def _prefix_allowed(self, fullbuf, seq_len, n, v):
        """(N, V) bool of the tokens prefix_allowed_tokens_fn allows: the
        one read-back per step of this processor."""
        seqs = fullbuf[:, :seq_len].to(torch.int32).cpu().numpy()
        rows, cols = [], []
        for i in range(n):
            allowed = list(self.prefix_fn(i // self.prefix_beams, seqs[i]))
            if len(allowed) == 0:
                raise ValueError(
                    "`prefix_allowed_tokens_fn` returned an empty list as "
                    "allowed tokens (HF generate contract)")
            rows += [i] * len(allowed)
            cols += [int(t) for t in allowed]
        allowed = torch.zeros((n, v), dtype=torch.bool, device=fullbuf.device)
        allowed[torch.tensor(rows, device=fullbuf.device),
                torch.tensor(cols, device=fullbuf.device)] = True
        return allowed


def _process_logits_hf(logits, dcfg, step_idx, max_length, fullbuf=None,
                       **processors):
    """The processor stack of one step (see _Processors; the JAX package's
    function of the same name and keywords)."""
    return _Processors(dcfg, max_length, logits.device, **processors)(
        logits, step_idx, fullbuf)


# ----------------------------------------------------------------------------
# sampling
# ----------------------------------------------------------------------------

def sample_filter_logits(logits, top_k=0, top_p=1.0, typical_p=1.0):
    """HF's warpers on (N, V) float32 logits, in HF's order: keep the top_k
    highest (0 = off; clamped to V), then the smallest set whose cumulative
    probability reaches top_p (1.0 = off; the best token always stays),
    then typical decoding's mass-typical_p set (1.0 = off).  Filtered
    positions become -inf.  As in the JAX package, each filter cuts at a
    value threshold, so exact ties at the boundary all survive."""
    if top_k and top_k > 0:
        k = min(int(top_k), logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, _NEG_INF)
    if top_p < 1.0:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < top_p
        keep[:, 0] = True
        kth = torch.where(keep, sorted_desc, float("inf")).min(
            dim=-1, keepdim=True).values
        logits = logits.masked_fill(logits < kth, _NEG_INF)
    if typical_p < 1.0:
        # shifted score |(-log p) - H(p)|; a -inf logit adds 0 to H and
        # gets +inf
        norm = torch.log_softmax(logits, dim=-1)
        p = torch.exp(norm)
        ent = -torch.where(p > 0, norm * p, 0.0).sum(dim=-1, keepdim=True)
        shifted = torch.abs(-norm - ent)
        sorted_shifted, order = torch.sort(shifted, dim=-1, stable=True)
        cum = torch.cumsum(p.gather(-1, order), dim=-1)
        last = (cum < typical_p).sum(dim=-1, keepdim=True).clamp(
            0, shifted.shape[-1] - 1)
        pivot = sorted_shifted.gather(-1, last)
        logits = logits.masked_fill(shifted > pivot, _NEG_INF)
    return logits


def _temperature(temperature, device):
    """The JAX package's float32 max(temperature, 1e-6), a tensor on
    `device` (a divisor on the card's division, not its reciprocal)."""
    return torch.tensor(max(np.float32(temperature), np.float32(1e-6)),
                        dtype=torch.float32, device=device)


def _generator(rng, device):
    """rng as a torch.Generator on `device`: a generator is used as it is,
    an int seeds a new one, None is seed 0 (the JAX package's
    PRNGKey(0))."""
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator(device=device).manual_seed(
        0 if rng is None else int(rng))


def _gumbel(rng, step, shape):
    """Gumbel(0, 1) noise of decode step `step`, float32 on rng's device:
    argmax(logits + noise) draws a token from softmax(logits), and the top
    k of logits + noise draw k tokens without replacement.  The draws come
    from rng's stream, one call per step; `step` names the step (the JAX
    package draws each step from fold_in(rng, step))."""
    del step
    u = torch.rand(shape, generator=rng, device=rng.device)
    return -torch.log(-torch.log(u.clamp_min_(torch.finfo(u.dtype).tiny)))


# ----------------------------------------------------------------------------
# greedy and sampled decode
# ----------------------------------------------------------------------------

@torch.no_grad()
def greedy_decode(params, dcfg, enc_hidden, enc_mask, max_length,
                  dtype=torch.float32, kv_int8=False, output_scores=False,
                  lm_head=None, adapters=None, early_stop=False,
                  do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
                  typical_p=1.0, rng=None, min_length=0,
                  repetition_penalty=1.0, no_repeat_ngram_size=0,
                  forced_bos_token_id=None, forced_eos_token_id=None,
                  bad_words_ids=None, suppress_tokens=None,
                  begin_suppress_tokens=None, encoder_no_repeat_ngram_size=0,
                  encoder_input_ids=None, prefix_allowed_tokens_fn=None):
    """Greedy (or, with do_sample, ancestral-sampling) decode against a
    text-encoder output: the processor stack (_Processors), then when
    sampling the temperature -> top_k -> top_p -> typical_p warpers and a
    draw per step from `rng` (a torch.Generator, an int seed or None for
    seed 0).  Returns (tokens (B, max_length) with pad_token_id after EOS,
    the EOS itself included, lengths (B,)); with output_scores also the
    per-step processed scores (max_length, B, V) float32 (post-warp when
    sampling).  kv_int8 keeps the cross K/V as int8 codes; lm_head is the
    tied head's operand of seq2seq.tied_head_operand, made once for all
    steps (None: each step makes it); adapters: the adapter variant's, run
    after each decoder block.

    early_stop ends the loop once every row has emitted EOS, read
    _EARLY_STOP_LAG steps late (module docstring); the tokens are those of
    the fixed-length loop.  output_scores forces the fixed-length loop."""
    b = enc_hidden.shape[0]
    device = enc_hidden.device
    pad = dcfg.pad_token_id
    if output_scores:
        early_stop = False
    if do_sample:
        rng = _generator(rng, device)
        temp = _temperature(temperature, device)
    procs = _Processors(
        dcfg, max_length, device, repetition_penalty=repetition_penalty,
        no_repeat_ngram_size=no_repeat_ngram_size, min_length=min_length,
        forced_bos_token_id=forced_bos_token_id,
        forced_eos_token_id=forced_eos_token_id, bad_words_ids=bad_words_ids,
        suppress_tokens=suppress_tokens,
        begin_suppress_tokens=begin_suppress_tokens,
        encoder_no_repeat_ngram_size=encoder_no_repeat_ngram_size,
        encoder_input_ids=encoder_input_ids,
        prefix_allowed_tokens_fn=prefix_allowed_tokens_fn)
    cache = seq2seq.init_decoder_cache(params, dcfg, enc_hidden, b,
                                       max_length, dtype, kv_int8=kv_int8)
    tok = torch.full((b, 1), dcfg.decoder_start_token_id, dtype=torch.long,
                     device=device)
    fullbuf = None
    if procs.needs_history:
        fullbuf = torch.full((b, max_length + 1), pad, dtype=torch.long,
                             device=device)
        fullbuf[:, 0] = dcfg.decoder_start_token_id
    finished = torch.zeros(b, dtype=torch.bool, device=device)
    pad_row = torch.full((b,), pad, dtype=torch.long, device=device)
    tokens = torch.full((b, max_length), pad, dtype=torch.long, device=device)
    if early_stop:
        on_card = device.type == "cuda"
        done_flags = torch.zeros(max_length, dtype=torch.bool,
                                 pin_memory=on_card)
        done_events = []
    scores = []
    for t in _steps(max_length):
        if early_stop and t >= _EARLY_STOP_LAG:
            seen = t - _EARLY_STOP_LAG
            if on_card:
                done_events[seen].synchronize()
            if done_flags[seen]:
                break
        out = seq2seq.decode(params, dcfg, tok, enc_mask, cache, dtype,
                             lm_head=lm_head, adapters=adapters)
        cache = out["cache"]
        logits = procs(out["logits"][:, -1, :], t, fullbuf)
        if do_sample:
            logits = sample_filter_logits(logits / temp, top_k, top_p,
                                          typical_p)
            next_tok = torch.argmax(logits + _gumbel(rng, t, logits.shape),
                                    dim=-1)
        else:
            next_tok = torch.argmax(logits, dim=-1)
        next_tok = torch.where(finished, pad_row, next_tok)
        finished = finished | (next_tok == dcfg.eos_token_id)
        tokens[:, t] = next_tok
        if fullbuf is not None:
            fullbuf[:, t + 1] = next_tok
        if output_scores:
            scores.append(logits.float())
        if early_stop:
            done_flags[t:t + 1].copy_(finished.all().reshape(1),
                                      non_blocking=True)
            if on_card:
                done_events.append(torch.cuda.Event())
                done_events[-1].record()
        tok = next_tok[:, None]
    lengths = (tokens != pad).sum(dim=1)
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


def _gather(x, idx):
    """(B, N, ...) gathered on axis 1 to (B, idx.shape[1], ...)."""
    b, m = idx.shape
    view = idx.reshape(b, m, *([1] * (x.ndim - 2)))
    return x.gather(1, view.expand(b, m, *x.shape[2:]))


class _BeamLoop:
    """What the beam loops share: one cross K/V per input row with a
    self-attention cache of B * num_beams rows and its spare buffers, the
    decoder step, the processor stack, the length-penalty tables and the
    finished-set update.  The loops always run max_length decoder steps and
    never read a value back (except for prefix_allowed_tokens_fn): once the
    JAX loop's condition is false their search state is frozen, so the
    result is the one an early exit would give."""

    def __init__(self, params, dcfg, enc_hidden, enc_mask, max_length,
                 num_beams, rows_per_input, length_penalty, early_stopping,
                 dtype, kv_int8, lm_head, adapters, processors):
        b = enc_hidden.shape[0]
        self.b, self.k, self.s_max = b, num_beams, max_length
        self.params, self.dcfg, self.enc_mask = params, dcfg, enc_mask
        self.dtype, self.lm_head, self.adapters = dtype, lm_head, adapters
        self.early_stopping = early_stopping
        self.device = device = enc_hidden.device
        self.f32 = dict(dtype=torch.float32, device=device)
        self.neg = torch.tensor(-1e9, **self.f32)
        self.zero = torch.zeros((), **self.f32)
        enc_ids = processors.pop("encoder_input_ids", None)
        if enc_ids is not None:
            enc_ids = torch.as_tensor(enc_ids).to(device).repeat_interleave(
                rows_per_input, dim=0)
        self.procs = _Processors(dcfg, max_length, device,
                                 encoder_input_ids=enc_ids,
                                 prefix_beams=rows_per_input, **processors)
        self.cache = seq2seq.init_decoder_cache(
            params, dcfg, enc_hidden, b * num_beams, max_length, dtype,
            kv_int8=kv_int8)
        self.spare = (torch.empty_like(self.cache.self_kv.key),
                      torch.empty_like(self.cache.self_kv.value))
        self.last_tok = torch.full((b * num_beams, 1),
                                   dcfg.decoder_start_token_id,
                                   dtype=torch.long, device=device)
        # (s + 1) ** length_penalty for every step, in float32
        self.len_pow = (torch.arange(1, max_length + 1, **self.f32)
                        ** length_penalty)
        if early_stopping == "never" and length_penalty > 0.0:
            self.best_pow = self.len_pow[max_length - 1].expand(max_length)
        else:
            self.best_pow = self.len_pow

    def seqs(self, shape):
        return torch.full(shape, self.dcfg.pad_token_id, dtype=torch.long,
                          device=self.device)

    def step_logp(self):
        """log-softmax of the next token's logits, (B * K, V) float32."""
        out = seq2seq.decode(self.params, self.dcfg, self.last_tok,
                             self.enc_mask, self.cache, self.dtype,
                             lm_head=self.lm_head, adapters=self.adapters)
        self.cache = out["cache"]
        return torch.log_softmax(out["logits"][:, -1, :].float(), dim=-1)

    def process(self, logp, s, running_seqs):
        """The processor stack on (R, V) log-probs of the beams whose
        sequences so far are running_seqs (..., S)."""
        fullbuf = None
        if self.procs.needs_history:
            rows = running_seqs.reshape(-1, self.s_max)
            fullbuf = torch.cat([torch.full_like(
                rows[:, :1], self.dcfg.decoder_start_token_id), rows], dim=1)
        return self.procs(logp, s, fullbuf)

    def advance(self, src, tok):
        """Next step's input tokens and the cache reordered so that beam
        (b, o) continues beam (b, src[b, o])."""
        self.last_tok = tok.reshape(self.b * self.k, 1)
        self.cache, self.spare = _gather_cache(self.cache, src, self.b,
                                               self.k, self.spare)

    def finish(self, s, topk_scores, topk_seqs, did_finish, fin_scores,
               fin_seqs, is_finished, unsat):
        """Merge the candidates that finish this step into the finished set
        (scored sum_logprobs / (s + 1) ** length_penalty, best kept) and
        advance the early-stop latch: a row stays unsatisfied while the best
        of its candidate pool, at its most favourable length, beats its
        worst finished score.  unsat is (B, 1)."""
        kf = fin_scores.shape[1]
        pen = topk_scores / self.len_pow[s]
        if self.early_stopping is True:
            pen = pen + torch.where(
                is_finished.all(dim=1, keepdim=True), self.neg, self.zero)
        pen = pen + torch.where(unsat, self.zero, self.neg)
        pen = pen + torch.where(did_finish, self.zero, self.neg)
        new_scores, sel = _topk_stable(torch.cat([fin_scores, pen], dim=1),
                                       kf)
        new_seqs = _gather(torch.cat([fin_seqs, topk_seqs], dim=1), sel)
        is_fin = torch.cat([is_finished, did_finish], dim=1).gather(1, sel)
        best_possible = topk_scores[:, :1] / self.best_pow[s]
        worst_fin = torch.where(
            is_fin, new_scores.min(dim=1, keepdim=True).values, self.neg)
        unsat = unsat & (best_possible > worst_fin).any(dim=-1, keepdim=True)
        return new_scores, new_seqs, is_fin, unsat

    def active(self, state):
        """The JAX loop's condition on the state of this step."""
        on = state["unsat"].any() & state["valid_cont"]
        if self.early_stopping is True:
            on = on & ~state["is_finished"].all()
        return on


def _freeze(active, new, old):
    return {name: torch.where(active, new[name], old[name]) for name in new}


@torch.no_grad()
def beam_search(params, dcfg, enc_hidden, enc_mask, max_length, num_beams=4,
                length_penalty=1.0, dtype=torch.float32, early_stopping=False,
                kv_int8=False, num_return_sequences=1, output_scores=False,
                lm_head=None, adapters=None, do_sample=False, temperature=1.0,
                top_k=0, top_p=1.0, typical_p=1.0, rng=None, **processors):
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
      * `max_length` counts generated tokens;
      * the processor stack (_Processors; keywords `processors`, those of
        the JAX function) applies to the per-beam log-probs;
      * do_sample is HF beam-sample: the warpers apply to the accumulated
        scores, then 2 * num_beams candidates are drawn without replacement
        from softmax over (num_beams * V) (Gumbel top-k, noise from
        `_gumbel` and `rng`) and sorted by score.

    One cross K/V per input row: the num_beams beams of an input share it
    (seq2seq._cross_attention), and only the self-attention cache is
    reordered each step, between two buffers (K5 cannot permute in place).
    lm_head, adapters: as for greedy_decode.  See _BeamLoop for the fixed
    step count.

    Returns (tokens (B * num_return_sequences, max_length): the top finished
    beams per row in score order, pad after EOS; lengths); with
    output_scores also `sequences_scores` (B * num_return_sequences,), the
    length-penalised final beam scores."""
    b = enc_hidden.shape[0]
    k, k2, s_max = num_beams, 2 * num_beams, max_length
    eos = dcfg.eos_token_id
    nret = num_return_sequences
    if nret > k:
        raise ValueError(
            f"num_return_sequences ({nret}) must be <= num_beams ({k})")
    loop = _BeamLoop(params, dcfg, enc_hidden, enc_mask, max_length, k, k,
                     length_penalty, early_stopping, dtype, kv_int8, lm_head,
                     adapters, processors)
    if do_sample:
        rng = _generator(rng, loop.device)
        temp = _temperature(temperature, loop.device)
    neg, zero = loop.neg, loop.zero
    state = dict(
        running_seqs=loop.seqs((b, k, s_max)),
        # only beam 0 live at step 0 (prevents k copies of the same prefix)
        running_scores=torch.tensor([0.0] + [-1e9] * (k - 1), **loop.f32)
        .expand(b, k).contiguous(),
        finished_seqs=loop.seqs((b, k, s_max)),
        finished_scores=torch.full((b, k), -1e9, **loop.f32),
        is_finished=torch.zeros((b, k), dtype=torch.bool,
                                device=loop.device),
        # per-row latch: can a running beam still improve the finished set
        unsat=torch.ones((b, 1), dtype=torch.bool, device=loop.device),
        valid_cont=torch.ones((), dtype=torch.bool, device=loop.device),
    )
    top_half = (torch.arange(k2, device=loop.device) < k)[None, :]

    for s in _steps(s_max):
        c = state
        active = loop.active(c)
        logp = loop.process(loop.step_logp(), s, c["running_seqs"])
        vocab = logp.shape[-1]
        acc = logp.reshape(b, k, vocab) + c["running_scores"][:, :, None]
        if do_sample:
            flat = sample_filter_logits(acc.reshape(b * k, vocab) / temp,
                                        top_k, top_p, typical_p) \
                .reshape(b, k * vocab)
            _, topk_idx = _topk_over_beams(
                (flat + _gumbel(rng, s, flat.shape)).reshape(b, k, vocab), k2)
            topk_scores = flat.gather(1, topk_idx)
            # HF sorts the sampled candidates by score, descending
            order = torch.sort(-topk_scores, dim=1, stable=True).indices
            topk_scores = topk_scores.gather(1, order)
            topk_idx = topk_idx.gather(1, order)
        else:
            topk_scores, topk_idx = _topk_over_beams(acc, k2)  # (B, 2K)
        src_beam = topk_idx // vocab
        tok = topk_idx % vocab
        topk_seqs = _gather(c["running_seqs"], src_beam)      # (B, 2K, S)
        topk_seqs[:, :, s] = tok
        hits = tok == eos
        if s + 1 >= s_max:
            hits = torch.ones_like(hits)

        # running beams for the next iteration: best k non-finished
        run_masked = topk_scores + torch.where(hits, neg, zero)
        new_running_scores, run_sel = _topk_stable(run_masked, k)
        loop.advance(src_beam.gather(1, run_sel), tok.gather(1, run_sel))

        # finished set: only the top num_beams candidates may finalize
        fin = loop.finish(s, topk_scores, topk_seqs, hits & top_half,
                          c["finished_scores"], c["finished_seqs"],
                          c["is_finished"], c["unsat"])
        new = dict(running_seqs=_gather(topk_seqs, run_sel),
                   running_scores=new_running_scores,
                   finished_scores=fin[0], finished_seqs=fin[1],
                   is_finished=fin[2], unsat=fin[3], valid_cont=~hits.all())
        state = _freeze(active, new, c)

    # the finished set is score-sorted: rows 0..nret-1 are the return set
    best_seqs = state["finished_seqs"][:, :nret, :].reshape(b * nret, s_max)
    lengths = (best_seqs != dcfg.pad_token_id).sum(dim=1)
    if output_scores:
        return (best_seqs, lengths,
                state["finished_scores"][:, :nret].reshape(b * nret))
    return best_seqs, lengths


@torch.no_grad()
def group_beam_search(params, dcfg, enc_hidden, enc_mask, max_length,
                      num_beams=4, num_beam_groups=2, diversity_penalty=0.0,
                      length_penalty=1.0, dtype=torch.float32,
                      early_stopping=False, kv_int8=False,
                      num_return_sequences=1, output_scores=False,
                      lm_head=None, adapters=None, **processors):
    """Diverse (group) beam search with HF `generate(num_beam_groups=G,
    diversity_penalty=p)` semantics, as the JAX package's
    `group_beam_search`.  One decoder step decodes all num_beams rows; the
    groups of kg = num_beams // G beams are then processed one after
    another within the step: group g's log-probs are lowered by
    diversity_penalty x the count of each token among the earlier groups'
    picks of this step (HammingDiversity, before the processor stack), and
    each group keeps its own 2 * kg-candidate bookkeeping with beam 0 of
    every group live at step 0.  The finished hypotheses of all groups are
    pooled at the end: the num_return_sequences best per input.  One K5
    reorder per step for all groups; the fixed step count of _BeamLoop."""
    b = enc_hidden.shape[0]
    k, g_n = num_beams, num_beam_groups
    if k % g_n:
        raise ValueError(f"num_beams ({k}) must be divisible by "
                         f"num_beam_groups ({g_n})")
    kg, k2g, s_max = k // g_n, 2 * (k // g_n), max_length
    pad, eos = dcfg.pad_token_id, dcfg.eos_token_id
    nret = num_return_sequences
    if nret > k:
        raise ValueError(
            f"num_return_sequences ({nret}) must be <= num_beams ({k})")
    loop = _BeamLoop(params, dcfg, enc_hidden, enc_mask, max_length, k, kg,
                     length_penalty, early_stopping, dtype, kv_int8, lm_head,
                     adapters, processors)
    neg, zero, dev = loop.neg, loop.zero, loop.device
    scores0 = torch.tensor([0.0] + [-1e9] * (kg - 1), **loop.f32)
    state = dict(
        running_seqs=loop.seqs((b, g_n, kg, s_max)),
        running_scores=scores0.expand(b, g_n, kg).contiguous(),
        finished_seqs=loop.seqs((b, g_n, kg, s_max)),
        finished_scores=torch.full((b, g_n, kg), -1e9, **loop.f32),
        is_finished=torch.zeros((b, g_n, kg), dtype=torch.bool, device=dev),
        unsat=torch.ones((b, g_n), dtype=torch.bool, device=dev),
        valid_cont=torch.ones((), dtype=torch.bool, device=dev),
    )
    top_half = (torch.arange(k2g, device=dev) < kg)[None, :]

    for s in _steps(s_max):
        c = state
        active = loop.active(c)
        logp_all = loop.step_logp()
        vocab = logp_all.shape[-1]
        logp_all = logp_all.reshape(b, g_n, kg, vocab)
        counts = torch.zeros((b, vocab), **loop.f32)  # earlier groups' picks
        new = {key: [] for key in ("running_seqs", "running_scores",
                                   "finished_seqs", "finished_scores",
                                   "is_finished", "unsat", "last", "src",
                                   "hits")}
        for g in range(g_n):
            logp = logp_all[:, g]
            if diversity_penalty > 0.0 and g > 0:
                logp = logp - diversity_penalty * counts[:, None, :]
            logp = loop.process(logp.reshape(b * kg, vocab), s,
                                c["running_seqs"][:, g])
            acc = logp.reshape(b, kg, vocab) \
                + c["running_scores"][:, g][:, :, None]
            topk_scores, topk_idx = _topk_over_beams(acc, k2g)  # (B, 2kg)
            src_beam = topk_idx // vocab
            tok = topk_idx % vocab
            topk_seqs = _gather(c["running_seqs"][:, g], src_beam)
            topk_seqs[:, :, s] = tok
            hits = tok == eos
            if s + 1 >= s_max:
                hits = torch.ones_like(hits)

            run_masked = topk_scores + torch.where(hits, neg, zero)
            new_rs, run_sel = _topk_stable(run_masked, kg)
            new_last = tok.gather(1, run_sel)                    # (B, kg)
            unsat_g = c["unsat"][:, g:g + 1]
            fin = loop.finish(s, topk_scores, topk_seqs, hits & top_half,
                              c["finished_scores"][:, g],
                              c["finished_seqs"][:, g],
                              c["is_finished"][:, g], unsat_g)
            # done groups emit pad in HF's process(); the diversity penalty
            # of the later groups counts those pads
            picks = torch.where(unsat_g, new_last, pad)
            counts.scatter_add_(1, picks, torch.ones_like(picks,
                                                          **loop.f32))
            for key, value in (("running_seqs", _gather(topk_seqs, run_sel)),
                               ("running_scores", new_rs),
                               ("finished_scores", fin[0]),
                               ("finished_seqs", fin[1]),
                               ("is_finished", fin[2]),
                               ("unsat", fin[3][:, 0]), ("last", new_last),
                               ("src", g * kg + src_beam.gather(1, run_sel)),
                               ("hits", hits)):
                new[key].append(value)
        stack = {key: torch.stack(v, dim=1) for key, v in new.items()}
        loop.advance(stack["src"].reshape(b, k), stack["last"])
        stack["valid_cont"] = ~stack["hits"].all()
        state = _freeze(active, {key: stack[key] for key in c}, c)

    # pool every group's hypotheses, best nret per input
    best_scores, best_sel = _topk_stable(
        state["finished_scores"].reshape(b, k), nret)
    best_seqs = _gather(state["finished_seqs"].reshape(b, k, s_max),
                        best_sel).reshape(b * nret, s_max)
    lengths = (best_seqs != pad).sum(dim=1)
    if output_scores:
        return best_seqs, lengths, best_scores.reshape(b * nret)
    return best_seqs, lengths


# ----------------------------------------------------------------------------
# constrained beam search (force_words_ids)
# ----------------------------------------------------------------------------
#
# HF's `generate(force_words_ids=...)` (ConstrainedBeamSearchScorer with
# PhrasalConstraint / DisjunctiveConstraint), as the JAX package re-derives
# it for a static-shape loop:
#
#   * every constraint is a token trie (a phrasal word is a chain, a
#     disjunctive word set shares prefixes) in static edge tables; a beam's
#     ConstraintListState is a few tensors: completed (C,), the constraint
#     in progress, its trie node, the pending-list stamps;
#   * each step runs the vanilla 2K-candidate advancement, adds the
#     forced-advance candidates (each running beam with each token that
#     advances its constraints), drops those equal as sequences to an
#     earlier candidate, and re-ranks the union by HF's bank round-robin;
#   * EOS finalizes a candidate only when its source beam has completed
#     every constraint; at max length, incomplete beams are admitted only
#     when fewer than num_return_sequences complete ones exist.

class _ConstraintTables(NamedTuple):
    """Static trie tables for a constraint list (one trie per constraint,
    nodes numbered globally; edge slots padded with token -1)."""
    edges_tok: torch.Tensor   # (N_nodes, E) edge tokens, -1 = empty
    edges_next: torch.Tensor  # (N_nodes, E) target node
    edges_leaf: torch.Tensor  # (N_nodes, E) bool: the target ends a word
    roots: torch.Tensor       # (C,) root node per constraint
    c_seqlen: torch.Tensor    # (C,) the constraint's longest word
    node_depth: torch.Tensor  # (N_nodes,) tokens consumed at the node
    max_seqlen: int           # max over constraints (HF's bank unit)
    n_constraints: int
    adv_width: int            # advance-candidate slots per beam (C * E)


def _build_constraint_tables(force_words_ids, device=None):
    """Compile force_words_ids into trie tables on `device`.  Takes HF's two
    shapes of an entry: a list of ints (PhrasalConstraint) or a list of
    lists of ints (DisjunctiveConstraint), with HF's validation (positive
    ints, no word a prefix of a sibling)."""
    if not isinstance(force_words_ids, (list, tuple)) or \
            len(force_words_ids) == 0:
        raise ValueError(
            f"`force_words_ids` has to be a non-empty list, but is "
            f"{force_words_ids}")
    nodes, depth, roots, seqlens = [], [], [], []   # nodes: token -> node id
    for entry in force_words_ids:
        if not isinstance(entry, (list, tuple)) or len(entry) == 0:
            raise ValueError(
                f"constraint entries must be non-empty lists, got {entry}")
        if isinstance(entry[0], (list, tuple)):
            words = [list(map(int, w)) for w in entry]
        else:
            words = [list(map(int, entry))]
        for w in words:
            if len(w) == 0 or any(t < 0 for t in w):
                raise ValueError(
                    f"each word has to be a non-empty list of positive "
                    f"integers, but got {w} in {entry}")
        root = len(nodes)
        nodes.append({})
        depth.append(0)
        roots.append(root)
        seqlens.append(max(len(w) for w in words))
        for w in words:
            cur = root
            for t in w:
                if t not in nodes[cur]:
                    nodes.append({})
                    depth.append(depth[cur] + 1)
                    nodes[cur][t] = len(nodes) - 1
                cur = nodes[cur][t]

        # HF DisjunctiveTrie(no_subsets=True): one leaf per word
        def _leaves(n):
            kids = nodes[n].values()
            return 1 if not kids else sum(_leaves(c) for c in kids)
        if _leaves(root) != len(words):
            raise ValueError(
                f"Each list in `force_words_ids` can't be a complete "
                f"subset of another list, but is {entry}")
    e_max = max(1, max(len(d) for d in nodes))
    et = np.full((len(nodes), e_max), -1, np.int64)
    en = np.zeros((len(nodes), e_max), np.int64)
    el = np.zeros((len(nodes), e_max), bool)
    for n, d in enumerate(nodes):
        for j, (t, nn) in enumerate(d.items()):
            et[n, j], en[n, j], el[n, j] = t, nn, len(nodes[nn]) == 0
    to = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return _ConstraintTables(
        edges_tok=to(et), edges_next=to(en), edges_leaf=to(el),
        roots=to(np.asarray(roots, np.int64)),
        c_seqlen=to(np.asarray(seqlens, np.int64)),
        node_depth=to(np.asarray(depth, np.int64)),
        max_seqlen=int(max(seqlens)), n_constraints=len(roots),
        adv_width=len(roots) * e_max)


def _edge_step(ct, node, tok):
    """At trie `node` (...,): whether an edge carries `tok`, and the first
    such edge's target node and leaf flag."""
    e_tok = ct.edges_tok[node]                          # (..., E)
    m = (e_tok == tok[..., None]) & (e_tok >= 0)
    sel = m.to(torch.uint8).argmax(dim=-1, keepdim=True)  # first match
    return (m.any(-1), ct.edges_next[node].gather(-1, sel)[..., 0],
            ct.edges_leaf[node].gather(-1, sel)[..., 0])


def _ct_add_token(ct: _ConstraintTables, state, tok):
    """HF ConstraintListState.add(token), elementwise over leading dims.

    state: dict of completed (..., C) bool, inprog (...,) (-1 = none), node
    (...,) (trie node of the constraint in progress), stamp (..., C)
    (pending-list arrival order: HF appends a reset constraint at the end
    of pending_constraints), ctr (...,) (the next stamp).  tok (...,).

      * all complete: no-op;
      * a constraint in progress: a token on one of its trie edges advances
        it (completing it on a leaf edge); any other token drops it back
        to pending with all progress lost (stamped to the back of the list),
        and the token is not tried against the other constraints;
      * otherwise the first pending constraint (lowest stamp) whose root
        has an edge with the token starts progressing."""
    completed, inprog, node = state["completed"], state["inprog"], \
        state["node"]
    stamp, ctr = state["stamp"], state["ctr"]
    cidx = torch.arange(ct.n_constraints, device=tok.device)
    all_done = completed.all(-1)
    # the constraint in progress
    any_m, nxt, leaf = _edge_step(ct, node, tok)
    onehot_ip = inprog[..., None] == cidx
    comp_ip = completed | (onehot_ip & (any_m & leaf)[..., None])
    inprog_ip = torch.where(any_m & ~leaf, inprog, -1)
    node_ip = torch.where(any_m & ~leaf, nxt, 0)
    reset_ip = ~any_m
    stamp_ip = torch.where(onehot_ip & reset_ip[..., None], ctr[..., None],
                           stamp)
    ctr_ip = ctr + reset_ip.long()
    # the first pending constraint whose root has an edge with tok
    root_tok = ct.edges_tok[ct.roots]                   # (C, E)
    rany = ((root_tok == tok[..., None, None]) & (root_tok >= 0)).any(-1) \
        & ~completed                                    # (..., C)
    has_c = rany.any(-1)
    first = torch.where(rany, stamp, 1 << 30).argmin(dim=-1)
    _, nxt2, leaf2 = _edge_step(ct, ct.roots[first], tok)
    comp_p = completed | ((first[..., None] == cidx)
                          & (has_c & leaf2)[..., None])
    inprog_p = torch.where(has_c & ~leaf2, first, -1)
    node_p = torch.where(has_c & ~leaf2, nxt2, 0)
    # combine
    has_ip = inprog >= 0

    def pick(ip, p, old):
        if ip.ndim > has_ip.ndim:
            return torch.where(all_done[..., None], old,
                               torch.where(has_ip[..., None], ip, p))
        return torch.where(all_done, old, torch.where(has_ip, ip, p))
    return dict(completed=pick(comp_ip, comp_p, completed),
                inprog=pick(inprog_ip, inprog_p, inprog),
                node=pick(node_ip, node_p, node),
                stamp=pick(stamp_ip, stamp, stamp),
                ctr=pick(ctr_ip, ctr, ctr))


def _ct_init_state(ct: _ConstraintTables, shape, device=None):
    c = ct.n_constraints
    return dict(
        completed=torch.zeros(shape + (c,), dtype=torch.bool, device=device),
        inprog=torch.full(shape, -1, dtype=torch.long, device=device),
        node=torch.zeros(shape, dtype=torch.long, device=device),
        stamp=torch.arange(c, device=device).expand(shape + (c,))
        .contiguous(),
        ctr=torch.full(shape, c, dtype=torch.long, device=device))


def _ct_bank(ct: _ConstraintTables, state):
    """HF ConstraintListState.get_bank(): a completed constraint counts
    max_seqlen; the one in progress adds max_seqlen - (its seqlen - trie
    depth)."""
    inprog, node = state["inprog"], state["node"]
    ncomp = state["completed"].sum(-1)
    rem = ct.c_seqlen[inprog.clamp_min(0)] - ct.node_depth[node]
    add = torch.where(inprog >= 0, ct.max_seqlen - rem, 0)
    return ncomp * ct.max_seqlen + add


def _ct_advance_tokens(ct: _ConstraintTables, state):
    """HF ConstraintListState.advance(): the in-progress constraint's next
    trie edges, or every pending constraint's root edges, (..., adv_width)
    with -1 padding (duplicates possible, as in HF's list; the caller drops
    them).  The pending constraints give their root tokens in constraint
    order, as in the JAX package."""
    c, e = ct.n_constraints, ct.edges_tok.shape[1]
    ip_adv = ct.edges_tok[state["node"]]                 # (..., E)
    if c > 1:
        ip_adv = torch.cat([ip_adv, torch.full(
            ip_adv.shape[:-1] + ((c - 1) * e,), -1, dtype=ip_adv.dtype,
            device=ip_adv.device)], dim=-1)
    pend = torch.where(state["completed"][..., None], -1,
                       ct.edges_tok[ct.roots])           # (..., C, E)
    pend = pend.reshape(pend.shape[:-2] + (c * e,))
    return torch.where((state["inprog"] >= 0)[..., None], ip_adv, pend)


@torch.no_grad()
def constrained_beam_search(params, dcfg, enc_hidden, enc_mask, max_length,
                            force_words_ids, num_beams=4, length_penalty=1.0,
                            dtype=torch.float32, early_stopping=False,
                            kv_int8=False, num_return_sequences=1,
                            output_scores=False, lm_head=None, adapters=None,
                            **processors):
    """HF `generate(force_words_ids=...)`: constrained beam search with
    ConstrainedBeamSearchScorer's semantics, as the JAX package's
    `constrained_beam_search` (see the block comment above): k selected
    candidates then k * adv_width forced-advance ones, ranked bank first
    with ties in candidate order.  max_length counts generated tokens.  One
    K5 reorder per step; the fixed step count of _BeamLoop."""
    b = enc_hidden.shape[0]
    k = num_beams
    if k <= 1:
        raise ValueError(
            f"`num_beams` has to be an integer strictly greater than 1 for "
            f"constrained beam search, but is {k}")
    k2, s_max = 2 * k, max_length
    eos = dcfg.eos_token_id
    nret = num_return_sequences
    if nret > k:
        raise ValueError(
            f"num_return_sequences ({nret}) must be <= num_beams ({k})")
    dev = enc_hidden.device
    ct = _build_constraint_tables(force_words_ids, dev)
    a_w = ct.adv_width
    n_cand = k + k * a_w    # selected + forced-advance candidates
    loop = _BeamLoop(params, dcfg, enc_hidden, enc_mask, max_length, k, k,
                     length_penalty, early_stopping, dtype, kv_int8, lm_head,
                     adapters, processors)
    neg, zero = loop.neg, loop.zero
    # every beam's constraint state replays HF's initial input_ids, which
    # hold the decoder start token
    st0 = _ct_add_token(ct, _ct_init_state(ct, (b, k), dev), torch.full(
        (b, k), dcfg.decoder_start_token_id, dtype=torch.long, device=dev))
    state = dict(
        steps=torch.zeros((), dtype=torch.long, device=dev),
        running_seqs=loop.seqs((b, k, s_max)),
        running_scores=torch.tensor([0.0] + [-1e9] * (k - 1), **loop.f32)
        .expand(b, k).contiguous(),
        **{"st_" + name: v for name, v in st0.items()},
        finished_seqs=loop.seqs((b, k, s_max)),
        finished_scores=torch.full((b, k), -1e9, **loop.f32),
        is_finished=torch.zeros((b, k), dtype=torch.bool, device=dev),
        unsat=torch.ones((b, 1), dtype=torch.bool, device=dev),
        valid_cont=torch.ones((), dtype=torch.bool, device=dev),
    )
    top_half = (torch.arange(k2, device=dev) < k)[None, :]
    earlier = torch.tril(torch.ones((n_cand, n_cand), dtype=torch.bool,
                                    device=dev), -1)[None]
    rows = torch.arange(b, device=dev)[:, None, None]
    adv_src = torch.arange(k, device=dev)[None, :, None].expand(
        b, k, a_w).reshape(b, k * a_w)
    plain_idx = torch.arange(k, device=dev)[None].expand(b, k)
    after = n_cand + torch.arange(n_cand, device=dev)[None, :]

    for s in _steps(s_max):
        c = state
        st = {name: c["st_" + name] for name in st0}
        active = loop.active(c)
        logp = loop.process(loop.step_logp(), s, c["running_seqs"])
        vocab = logp.shape[-1]
        acc = logp.reshape(b, k, vocab) + c["running_scores"][:, :, None]
        # ------- vanilla 2K advancement -------
        topk_scores, topk_idx = _topk_over_beams(acc, k2)
        src_beam = topk_idx // vocab                         # (B, 2K)
        tok = topk_idx % vocab
        # EOS only: max-length finalization runs after the loop
        hits = tok == eos
        topk_seqs = _gather(c["running_seqs"], src_beam)
        topk_seqs[:, :, s] = tok

        # finished set: EOS candidates of the top K ranks whose source beam
        # (without the EOS) satisfies every constraint
        src_complete = _gather(st["completed"], src_beam).all(-1)
        fin = loop.finish(s, topk_scores, topk_seqs,
                          hits & top_half & src_complete,
                          c["finished_scores"], c["finished_seqs"],
                          c["is_finished"], c["unsat"])

        # the best K non-EOS candidates, in score order
        run_masked = topk_scores + torch.where(hits, neg, zero)
        sel_scores, run_sel = _topk_stable(run_masked, k)    # (B, K)

        # ------- forced-advance candidates -------
        adv_tok = _ct_advance_tokens(ct, st)                 # (B, K, A)
        adv_scores = acc.gather(-1, adv_tok.clamp_min(0))

        # ------- candidate union: K selected then K * A advance -------
        cand_tok = torch.cat([tok.gather(1, run_sel),
                              adv_tok.reshape(b, k * a_w)], dim=1)  # (B, Nc)
        cand_src = torch.cat([src_beam.gather(1, run_sel), adv_src], dim=1)
        cand_scores = torch.cat([sel_scores, adv_scores.reshape(b, k * a_w)],
                                dim=1)
        cand_valid = torch.cat([torch.ones_like(run_sel, dtype=torch.bool),
                                (adv_tok >= 0).reshape(b, k * a_w)], dim=1)
        cand_st = _ct_add_token(
            ct, {name: _gather(v, cand_src) for name, v in st.items()},
            cand_tok)
        banks = _ct_bank(ct, cand_st)                        # (B, Nc)

        # an advance candidate equal as a sequence to a selected one or an
        # earlier advance one is dropped: equal source sequences, equal token
        rs = c["running_seqs"]
        seq_eq = (rs[:, :, None, :] == rs[:, None, :, :]).all(-1)  # (B,K,K)
        pair_eq = seq_eq[rows, cand_src[:, :, None], cand_src[:, None, :]] \
            & (cand_tok[:, :, None] == cand_tok[:, None, :]) \
            & cand_valid[:, :, None] & cand_valid[:, None, :]
        is_dup = (pair_eq & earlier).any(dim=2)
        is_dup[:, :k] = False                                # selected stay
        cand_valid = cand_valid & ~is_dup
        any_new = cand_valid[:, k:].any(dim=1)               # (B,)

        # ------- bank round-robin re-rank -------
        zipped = banks.float() * 100.0 + cand_scores
        zipped = torch.where(cand_valid, zipped, -1e30)
        order = torch.sort(-zipped, dim=1, stable=True).indices
        banks_sorted = torch.where(cand_valid, banks, -1).gather(1, order)
        valid_sorted = cand_valid.gather(1, order)
        same_before = ((banks_sorted[:, None, :] == banks_sorted[:, :, None])
                       & earlier).sum(dim=2)
        increments = torch.where(valid_sorted, same_before, after)
        rearr = torch.sort(increments, dim=1, stable=True).indices
        merged_idx = order.gather(1, rearr)[:, :k]
        # HF re-ranks only when a new candidate was added
        final_idx = torch.where(any_new[:, None], merged_idx, plain_idx)

        new_tok = cand_tok.gather(1, final_idx)
        new_src = cand_src.gather(1, final_idx)
        new_running_seqs = _gather(c["running_seqs"], new_src)
        new_running_seqs[:, :, s] = new_tok
        loop.advance(new_src, new_tok)
        new = dict(steps=c["steps"] + 1, running_seqs=new_running_seqs,
                   running_scores=cand_scores.gather(1, final_idx),
                   **{"st_" + name: _gather(v, final_idx)
                      for name, v in cand_st.items()},
                   finished_scores=fin[0], finished_seqs=fin[1],
                   is_finished=fin[2], unsat=fin[3], valid_cont=~hits.all())
        state = _freeze(active, new, c)

    # ------- finalize (ConstrainedBeamSearchScorer.finalize) -------
    # rows not done add the running beams that complete every constraint;
    # with fewer than num_return_sequences of them, incomplete beams in
    # beam order fill up
    complete = state["st_completed"].all(-1)                 # (B, K)
    n_complete = complete.sum(-1, keepdim=True)
    inc_rank = (~complete).long().cumsum(dim=1) - 1
    fallback = ~complete & (inc_rank < (nret - n_complete).clamp_min(0))
    gen_len = state["steps"].clamp_min(1).float()
    run_pen = state["running_scores"] / gen_len ** length_penalty
    addable = (complete | fallback) & state["unsat"]         # done rows skip
    run_pen = run_pen + torch.where(addable, zero, neg)
    best_scores, best_sel = _topk_stable(
        torch.cat([state["finished_scores"], run_pen], dim=1), nret)
    best_seqs = _gather(torch.cat([state["finished_seqs"],
                                   state["running_seqs"]], dim=1),
                        best_sel).reshape(b * nret, s_max)
    lengths = (best_seqs != dcfg.pad_token_id).sum(dim=1)
    if output_scores:
        return best_seqs, lengths, best_scores.reshape(b * nret)
    return best_seqs, lengths


# ----------------------------------------------------------------------------
# top-level speechmix generate
# ----------------------------------------------------------------------------

@torch.no_grad()
def generate(params, cfg: SpeechMixConfig, input_values, lengths=None,
             prompt_ids=None, max_length=None, num_beams=1,
             length_penalty=1.0, dtype=torch.float32, early_stop=False,
             early_stopping=False, kv_int8=False, do_sample=False,
             temperature=1.0, top_k=0, top_p=1.0, typical_p=1.0, rng=None,
             min_length=0, repetition_penalty=1.0, no_repeat_ngram_size=0,
             forced_bos_token_id=None, forced_eos_token_id=None,
             bad_words_ids=None, suppress_tokens=None,
             begin_suppress_tokens=None, num_return_sequences=1,
             output_scores=False, num_beam_groups=1, diversity_penalty=0.0,
             max_new_tokens=None, encoder_no_repeat_ngram_size=0,
             encoder_input_ids=None, prefix_allowed_tokens_fn=None,
             force_words_ids=None, device=None):
    """Waveform -> fused embeddings -> text encoder (once; not for the ed
    variant) -> a cached decode loop: greedy or sampled (num_beams <= 1),
    beam search or beam-sample (do_sample with num_beams > 1), group beam
    search (num_beam_groups > 1) or constrained beam search
    (force_words_ids), with HF's logits processors; the JAX package's
    generate() and its keywords (not use_flash).  input_values: (B,
    T_samples) zero-padded waveform; lengths: (B,) valid sample counts.
    Runs on `device` (default: the card); params and inputs are moved
    there.  rng: a torch.Generator on that device, an int seed, or None
    (seed 0).

    Returns (tokens (B * num_return_sequences, max_length), lengths); with
    output_scores a third value: the per-step processed scores (max_length,
    B, V) for greedy / sampling, the length-penalised sequences_scores for
    the beam searches.  num_return_sequences > 1 returns the top beams per
    input, or with sampling tiles each input that many times; plain greedy
    raises.  max_new_tokens, when given, takes precedence over max_length
    (HF precedence).  encoder_no_repeat_ngram_size without
    encoder_input_ids warns and has no effect (the encoder input is a
    waveform).  Which modes read values back to the host: see the module
    docstring."""
    with profiling.annotate("generate", root=True):
        if max_new_tokens is not None:
            max_length = max_new_tokens
        max_length = max_length or cfg.decoder.max_length
        if force_words_ids is not None:
            if do_sample:
                raise ValueError("`force_words_ids` is incompatible with "
                                 "sampling (HF generate contract)")
            if num_beam_groups > 1:
                raise ValueError("`force_words_ids` is incompatible with "
                                 "group beam search (HF generate contract)")
        if encoder_no_repeat_ngram_size > 0 and encoder_input_ids is None:
            warnings.warn(
                "encoder_no_repeat_ngram_size with a waveform encoder input "
                "is a no-op (the reference's HF generate builds float ngrams "
                "that never match token lookups); pass encoder_input_ids for "
                "a functional ban", UserWarning, stacklevel=2)
        if num_beam_groups > 1 and num_beam_groups > num_beams:
            raise ValueError(
                f"num_beam_groups ({num_beam_groups}) has to be smaller or "
                f"equal to num_beams ({num_beams}) (HF generate contract)")
        device = resolve_device(device)
        params = _to_device(params, device)
        input_values = torch.as_tensor(input_values).to(device)
        if lengths is not None:
            lengths = torch.as_tensor(lengths).to(device)
        if prompt_ids is not None:
            prompt_ids = torch.as_tensor(prompt_ids).to(device)
        if encoder_input_ids is not None:
            encoder_input_ids = torch.as_tensor(encoder_input_ids).to(
                device=device, dtype=torch.long)
        with profiling.annotate("generate.encode_speech"):
            inputs_embeds, enc_mask = smx.encode_speech(
                params, cfg, input_values, lengths, prompt_ids, dtype)
        adapters = params["adapters"] if cfg.variant == "adapter" else None
        if cfg.variant == "ed":
            # the decoder cross-attends the projected speech states: no
            # text-encoder pass (as in the training forward)
            enc_hidden = inputs_embeds
        else:
            with profiling.annotate("generate.text_encode"):
                enc_hidden = seq2seq.encode(
                    params["nlp"], cfg.decoder, inputs_embeds=inputs_embeds,
                    attention_mask=enc_mask, dtype=dtype,
                    adapters=adapters)["last_hidden_state"]
        lm_head = seq2seq.tied_head_operand(params["nlp"], cfg.decoder, dtype)
        common = dict(
            dtype=dtype, kv_int8=kv_int8, output_scores=output_scores,
            lm_head=lm_head, adapters=adapters, min_length=min_length,
            repetition_penalty=repetition_penalty,
            no_repeat_ngram_size=no_repeat_ngram_size,
            forced_bos_token_id=forced_bos_token_id,
            forced_eos_token_id=forced_eos_token_id,
            bad_words_ids=bad_words_ids, suppress_tokens=suppress_tokens,
            begin_suppress_tokens=begin_suppress_tokens,
            encoder_no_repeat_ngram_size=encoder_no_repeat_ngram_size,
            encoder_input_ids=encoder_input_ids,
            prefix_allowed_tokens_fn=prefix_allowed_tokens_fn)
        beams = dict(length_penalty=length_penalty,
                     early_stopping=early_stopping,
                     num_return_sequences=num_return_sequences)
        sampling = dict(do_sample=do_sample, temperature=temperature,
                        top_k=top_k, top_p=top_p, typical_p=typical_p, rng=rng)
        nlp, dcfg = params["nlp"], cfg.decoder
        with profiling.annotate("generate.decode"):
            if force_words_ids is not None:
                return constrained_beam_search(
                    nlp, dcfg, enc_hidden, enc_mask, max_length,
                    force_words_ids, num_beams=num_beams, **beams, **common)
            if num_beams <= 1:
                if num_return_sequences > 1:
                    if not do_sample:
                        raise ValueError(
                            "num_return_sequences > 1 requires num_beams > 1 "
                            "or do_sample=True (HF greedy contract)")
                    # each input tiled num_return_sequences times, drawn apart
                    tile = lambda x: x.repeat_interleave(  # noqa: E731
                        num_return_sequences, dim=0)
                    enc_hidden, enc_mask = tile(enc_hidden), tile(enc_mask)
                    if encoder_input_ids is not None:
                        common["encoder_input_ids"] = tile(encoder_input_ids)
                return greedy_decode(nlp, dcfg, enc_hidden, enc_mask,
                                     max_length, early_stop=early_stop,
                                     **sampling, **common)
            if num_beam_groups > 1:
                if do_sample:
                    raise ValueError(
                        "diverse beam search (num_beam_groups > 1) does not "
                        "support sampling (HF constraint)")
                return group_beam_search(
                    nlp, dcfg, enc_hidden, enc_mask, max_length,
                    num_beams=num_beams, num_beam_groups=num_beam_groups,
                    diversity_penalty=diversity_penalty, **beams, **common)
            return beam_search(nlp, dcfg, enc_hidden, enc_mask, max_length,
                               num_beams=num_beams, **beams, **sampling,
                               **common)
