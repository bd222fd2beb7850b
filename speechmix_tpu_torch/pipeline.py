"""Batched transcription pipeline (port of ``speechmix_tpu.pipeline``).

    pipe = TranscriptionPipeline(model, batch_size=16)
    texts = pipe(list_of_waveforms)          # order-preserving

Audio is grouped by padded length into buckets (the length rounded up to
the bucket grid, then frame-aligned), partial batches are padded by
repeating their last utterance, and each batch runs
``generation.generate`` on the model's device.  Audio longer than the
largest bucket is cut into chunks at low-energy points (or truncated), and
the chunks' transcripts are joined.

Over a mesh (``mesh=``, a ``parallel.mesh.Mesh``; every rank of it runs
the same pipeline call on the same waveforms): each batch's rows are split
over the data ranks (batch_size a multiple of n_data), the weights over the
model ranks (``mesh.shard_params``; fuse_qkv is off under tensor
parallelism, whose shares would cut the fused columns at the wrong places),
the decode keeps the local heads' K / V, and the data ranks' tokens are
gathered, so that every rank returns every transcript.
"""

from __future__ import annotations

from collections import defaultdict
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import generation as gen_lib
from .data import audio as audio_lib
from .parallel import mesh as mesh_lib
from .utils.platform import torch_dtype

# batches whose tokens have not been read back yet: the host prepares the
# next batch while the card decodes, and queued inputs stay bounded
MAX_IN_FLIGHT = 4

_ALLOWED_GENERATE_KWARGS = frozenset({
    "bad_words_ids", "suppress_tokens", "begin_suppress_tokens",
    "repetition_penalty", "no_repeat_ngram_size", "forced_bos_token_id",
    "forced_eos_token_id", "length_penalty", "early_stopping",
    "num_beam_groups", "diversity_penalty", "encoder_no_repeat_ngram_size",
    "prefix_allowed_tokens_fn", "force_words_ids"})


class TranscriptionPipeline:
    """Transcribe lists of waveforms with an API model
    (``speechmix_tpu_torch.api``) on its device.

    early_stop: leave the greedy decode loop once every row has emitted EOS
    (the same tokens as the full loop; beam search always runs max_length
    steps).  kv_int8: int8 cross-attention K/V.  long_audio: "chunk" cuts
    audio longer than the largest bucket at the lowest-energy point within
    the last long_audio_search_sec of each window (split_long) and joins the
    chunks' transcripts with spaces; "truncate" keeps the largest bucket's
    worth.  transfer_dtype: "int16" copies 16-bit PCM to the card, scaled
    by each row's peak, and converts it to float there; "float32" copies
    floats.  fuse_qkv: run on fuse_qkv_params of the model's parameters
    (the same tokens).  generate_kwargs: the HF logits-processor knobs
    forwarded to every decode; the ones that return several sequences or
    scores are refused.  use_flash is accepted for the signature's sake
    only.  mesh: serve over a mesh (see the module docstring)."""

    def __init__(self, model, batch_size: int = 16, max_length: int = None,
                 num_beams: int = 1, buckets_sec: Sequence[float] =
                 audio_lib.DEFAULT_BUCKETS, sample_rate: int = 16000,
                 use_flash: bool = None, early_stop: bool = True,
                 kv_int8: bool = False, long_audio: str = "chunk",
                 long_audio_search_sec: float = 2.0, mesh=None,
                 transfer_dtype: str = "float32", min_length: int = 0,
                 fuse_qkv: bool = False, generate_kwargs: dict = None):
        if mesh is not None and batch_size % mesh.n_data != 0:
            raise ValueError(
                f"batch_size {batch_size} must be a multiple of the "
                f"mesh data-axis size {mesh.n_data}")
        if transfer_dtype not in ("float32", "int16"):
            raise ValueError(f"transfer_dtype must be 'float32' or 'int16', "
                             f"got {transfer_dtype!r}")
        if long_audio not in ("chunk", "truncate"):
            raise ValueError(f"long_audio must be 'chunk' or 'truncate', "
                             f"got {long_audio!r}")
        generate_kwargs = dict(generate_kwargs or {})
        bad = set(generate_kwargs) - _ALLOWED_GENERATE_KWARGS
        if bad:
            raise ValueError(
                f"generate_kwargs {sorted(bad)} not supported by the "
                f"pipeline; allowed: {sorted(_ALLOWED_GENERATE_KWARGS)}")
        if generate_kwargs.get("force_words_ids") and num_beams <= 1:
            raise ValueError("force_words_ids requires num_beams > 1 "
                             "(constrained beam search)")
        if not buckets_sec or any(b <= 0 for b in buckets_sec):
            raise ValueError(f"buckets_sec must be positive and non-empty, "
                             f"got {buckets_sec!r}")
        self.generate_kwargs = generate_kwargs
        self.long_audio = long_audio
        self.long_audio_search_sec = long_audio_search_sec
        self.model = model
        self.batch_size = batch_size
        self.max_length = max_length or model.config.decoder.max_length
        self.num_beams = num_beams
        self.min_length = min_length
        self.use_flash = use_flash
        self.early_stop = early_stop
        self.kv_int8 = kv_int8
        self.transfer_dtype = transfer_dtype
        # bucket assignment takes the first bucket that fits and chunking
        # the last: both need them ascending and distinct
        self.buckets_sec = tuple(sorted(set(float(b) for b in buckets_sec)))
        self.sample_rate = sample_rate
        self.mesh = mesh
        # the fewest samples that give one conv frame: shorter inputs would
        # leave the encoder no valid frame; they get "" without a decode
        ecfg = model.config.encoder
        need = 1
        for k, s in zip(reversed(ecfg.conv_kernels),
                        reversed(ecfg.conv_strides)):
            need = (need - 1) * s + k
        self._min_samples = need
        if mesh is not None and mesh.n_model > 1:
            fuse_qkv = False
        self.fuse_qkv = fuse_qkv
        self._fused_params = None
        self._fused_src = None
        self._sharded_params = None
        self._sharded_src = None

    @property
    def device(self):
        return self.mesh.device if self.mesh is not None else \
            self.model.device

    def _base_params(self):
        """The model's parameters, q/k/v-fused when fuse_qkv is set (made
        again when model.params is replaced)."""
        if not self.fuse_qkv:
            return self.model.params
        if self._fused_src is not self.model.params:
            from .utils.quantize import fuse_qkv_params
            self._fused_params = fuse_qkv_params(self.model.params)
            self._fused_src = self.model.params
        return self._fused_params

    def _run_params(self):
        """The parameters a decode runs on: _base_params, over a mesh this
        rank's model shares of them (on its device)."""
        base = self._base_params()
        if self.mesh is None:
            return base
        if self._sharded_src is not base:
            from .training.freezing import tree_map
            self._sharded_params = mesh_lib.shard_params(
                self.mesh, tree_map(lambda t: t.to(self.device), base),
                self.model.config)
            self._sharded_src = base
        return self._sharded_params

    def _generate(self, batch, lengths, scale, max_length=None):
        """Tokens of one batch on the card: int16 rows scaled back to float
        by their peaks there, then generate(); over a mesh on this data
        rank's rows, the tokens of every data rank gathered after."""
        mesh = self.mesh
        if mesh is not None:
            rows = mesh_lib.local_batch_index(len(lengths), mesh.n_data,
                                              mesh.data_rank)
            idx = mesh_lib.torch_index(rows).to(batch.device)
            batch, lengths, scale = (x[idx] for x in (batch, lengths, scale))
        if self.transfer_dtype == "int16":
            batch = batch.float() * (scale[:, None] / 32767.0)
        cfg = self.model.config
        with mesh_lib.tp_sharding(mesh):
            tokens, _ = gen_lib.generate(
                self._run_params(), cfg, batch, lengths,
                max_length=max_length or self.max_length,
                num_beams=self.num_beams, early_stop=self.early_stop,
                kv_int8=self.kv_int8, min_length=self.min_length,
                dtype=torch_dtype(cfg.dtype), device=self.device,
                **self.generate_kwargs)
        if mesh is not None and mesh.group(mesh_lib.DATA_AXIS) is not None:
            from .parallel import collectives
            tokens = collectives.all_gather(
                tokens.contiguous(), mesh.group(mesh_lib.DATA_AXIS), dim=0)
        return tokens

    def _bucket_cap(self, sec):
        return self.model.config.encoder.aligned_samples(
            int(sec * self.sample_rate))

    def warmup(self):
        """Run a two-step decode of a silent full batch in every bucket
        before serving traffic, so that the first request of a bucket does
        not pay for building and loading the kernels, the libraries' set-up
        and the allocator's first blocks at its shapes."""
        dtype = (torch.int16 if self.transfer_dtype == "int16"
                 else torch.float32)
        for sec in self.buckets_sec:
            cap = self._bucket_cap(sec)
            batch = torch.zeros((self.batch_size, cap), dtype=dtype,
                                device=self.device)
            lengths = torch.full((self.batch_size,), cap, dtype=torch.int32,
                                 device=self.device)
            scale = torch.ones((self.batch_size,), device=self.device)
            self._generate(batch, lengths, scale, max_length=2)
        return self

    def split_long(self, wav: np.ndarray) -> List[np.ndarray]:
        """Cut a waveform longer than the largest bucket into chunks of at
        most that size, each cut at the lowest-energy sample (25 ms RMS
        window) within the last long_audio_search_sec of its window.  The
        chunks do not overlap and put the input back together."""
        sr = self.sample_rate
        max_cap = int(self.buckets_sec[-1] * sr)
        search = max(1, min(int(self.long_audio_search_sec * sr),
                            max_cap // 2))
        win = max(1, int(0.025 * sr))
        chunks, pos = [], 0
        while len(wav) - pos > max_cap:
            lo = pos + max_cap - search
            seg = wav[lo: pos + max_cap].astype(np.float64)
            energy = np.convolve(seg * seg, np.ones(win), mode="valid")
            cut = lo + int(np.argmin(energy)) + win // 2
            cut = max(pos + 1, min(cut, pos + max_cap))
            chunks.append(wav[pos:cut])
            pos = cut
        chunks.append(wav[pos:])
        return chunks

    def _host_batch(self, chunk, cap):
        """(batch, lengths, scale) numpy arrays of one batch: zero-padded
        float32 rows, or with int16 transfer 16-bit codes of each row over
        its peak."""
        batch = np.zeros((self.batch_size, cap), np.float32)
        lengths = np.zeros((self.batch_size,), np.int32)
        for j, (_, _, wav) in enumerate(chunk):
            batch[j, : len(wav)] = wav
            lengths[j] = len(wav)
        scale = np.ones((self.batch_size,), np.float32)
        if self.transfer_dtype == "int16":
            # the row's own peak: a quiet utterance beside a loud one keeps
            # its 16-bit resolution, and |x| > 1 is never clipped
            scale = np.maximum(np.abs(batch).max(axis=1),
                               1e-9).astype(np.float32)
            batch = np.clip(np.round(batch * (32767.0 / scale[:, None])),
                            -32767, 32767).astype(np.int16)
        return batch, lengths, scale

    def __call__(self, waveforms: List[np.ndarray],
                 sample_rates: Optional[List[int]] = None) -> List[str]:
        n = len(waveforms)
        prepped = []
        for i, wav in enumerate(waveforms):
            wav = np.asarray(wav, np.float32).reshape(-1)
            if sample_rates and sample_rates[i] != self.sample_rate:
                wav = audio_lib.resample(wav, sample_rates[i],
                                         self.sample_rate)
            prepped.append(wav)

        # bucket by padded length; long audio becomes several segments
        # that share the source index
        max_cap = int(self.buckets_sec[-1] * self.sample_rate)
        pools = defaultdict(list)    # cap -> [(orig_idx, seg_idx, wav)]
        seg_results = {}             # (orig_idx, seg_idx) -> text
        seg_counts = [1] * n
        for i, wav in enumerate(prepped):
            if len(wav) > max_cap and self.long_audio == "chunk":
                segs = self.split_long(wav)
            else:
                segs = [wav[:max_cap]]
            seg_counts[i] = len(segs)
            for si, seg in enumerate(segs):
                if len(seg) < self._min_samples:
                    seg_results[(i, si)] = ""
                    continue
                cap = audio_lib.bucket_length(len(seg), self.buckets_sec,
                                              self.sample_rate) or max_cap
                cap = self.model.config.encoder.aligned_samples(cap)
                pools[cap].append((i, si, seg))

        def drain(entry):
            chunk, real, tokens = entry
            tokens = tokens.cpu().numpy()
            for j in range(real):
                idx, si, _ = chunk[j]
                seg_results[(idx, si)] = self.model.tokenizer.decode(
                    tokens[j], skip_special_tokens=True)

        in_flight = []  # (chunk, real, device tokens)
        for cap, items in pools.items():
            for start in range(0, len(items), self.batch_size):
                chunk = items[start: start + self.batch_size]
                real = len(chunk)
                chunk = chunk + [chunk[-1]] * (self.batch_size - real)
                batch, lengths, scale = self._host_batch(chunk, cap)
                tokens = self._generate(
                    torch.from_numpy(batch).to(self.device),
                    torch.from_numpy(lengths).to(self.device),
                    torch.from_numpy(scale).to(self.device))
                in_flight.append((chunk, real, tokens))
                if len(in_flight) >= MAX_IN_FLIGHT:
                    drain(in_flight.pop(0))
        for entry in in_flight:
            drain(entry)

        results: List[str] = []
        for i in range(n):
            parts = [seg_results[(i, si)] for si in range(seg_counts[i])]
            results.append(" ".join(p for p in parts if p).strip()
                           if len(parts) > 1 else parts[0])
        return results
