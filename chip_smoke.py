#!/usr/bin/env python3
"""Smoke run of the PyTorch port (speechmix_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing as it goes; any failure exits non-zero:
  1. the card: name, power limit, torch / CUDA versions; TF32 off;
  2. build the CUDA kernels from speechmix_tpu_torch/csrc with nvcc;
  3. hold each kernel (K1 attention_fwd and its log-sum-exp, in bf16 also
     against attention_fwd_tiled_plain, its tiles in plain PyTorch, and
     twice, bit for bit, with causal rows that have no allowed key; K2
     dense_res_ln, K3 ffn_res_ln, K4 decode_attention with float and with
     int8 K/V (in bf16 also against decode_attention_split_plain, its
     cluster decomposition in plain PyTorch, and twice, bit for bit, at the
     decoder's four shapes, at T = 1500 and on edge-mask rows; timed beside
     its serial body), K5 beam_gather, K6 conv_ln_gelu (in bf16 also against
     fused_conv_layer_tiled_plain and twice, bit for bit, at the six
     extractor layers; its backward, conv_bwd.cu's three passes, at the six
     layers of the flagship in f32 and of XLS-R 1B in bf16 with bias and
     LayerNorm, B = 16, against the library gradient and twice bit for bit,
     each pass timed beside cuDNN's, then the whole stack's backward through
     autograd), K7 attention_bwd (also
     against attention_bwd_tiled_plain, its tiles in plain PyTorch), K8 ffn_bwd
     (bf16: its recompute pass and its TMA + wgmma products, the products
     also alone against reference products, at H = 256, 512, 768, 1024 and
     1536; f32: the same two passes with three tf32 products per product,
     twice bit for bit, at H = 256, 512, 768, 1024, 1280 and 1920 with and
     without the activation mask), K9
     ffn_fused; K3 and K9 in bf16 are the TMA + wgmma up and down passes and
     the LayerNorm row pass of ffn_fwd.cu, each pass also held and timed
     alone, the down pass's GEMM against a reference product, at every width
     that is a multiple of 128 from 256 to 1536) against its plain PyTorch
     version on the card, in bf16 and f32, at the shapes the flagship path
     gives it (K2, K3, K8 and K9 at the train step's 12800, 6400 and 1024
     rows; the bf16 K2, K3, K8, K9, K11, K12 and K13 twice, bit for bit,
     and K7 and K15 twice at the train step's three attention lengths; K2
     and K11 in bf16 also against their tiled plain version, at every
     kind of width the gate admits: 256 to 1536, 384, Din != H, 2304 as
     the down pass and the rows), and time
     kernel, plain version and one PyTorch library call beside it, with the
     least time the card could take (bound_ms); K5 must be bit-exact;
     the differentiable forms of K2, K3 and K9 (bf16 activations, f32
     weights) must give the gradients of the same functions over the plain
     versions (K2's backward products: bf16 operands, f32 results, against
     the upcast products); every width the TPU kernels take beyond the
     first bodies (check_head_widths: K1 / K14 / K7 / K15 at D = 16, 80,
     120, 128 in bf16 and f32, K4 at D = 16, 80, 128 and t5-3b's cross
     step, the f32 K2 / K3 / K9 / K8 at H = 1280 and 1920, K6 in bf16 at
     C = 32, 256 and 1024; what stays refused raises on CUDA tensors);
     the f32 rows (check_f32_rows): every kernel of the flagship's f32
     path at that path's shapes (K1 / K14 / K7 / K15 at T = 800, 400 and
     causal 64, K2 / K11 and K8 with and without the mask at 12800, 6400
     and 1024 rows, K3 / K9 / K12 / K13 at 12800, K4 with an f32 q, K6 at
     the six extractor layers with and without LayerNorm), against its
     plain version and timed beside it and one library call in full f32,
     with the f32 bound (FLOPs / 165 TFLOP/s: three tf32 products);
     then the dropout kernels: K10 dropout_mask bit-exact against the plain
     generator at the step's mask shapes, K11 dense_dropout_res_ln, K12
     ffn_dropout_res_ln, K13 ffn_dropout and K8's dropout twins at the
     step's row counts, K14 / K15 (attention with probability dropout,
     forward / backward) at its attention shapes, each against its plain
     version fed the same key's masks (K14 in bf16 also against the tiled
     plain version and twice, bit for bit), limits times 1/(1-r); and the
     differentiable dropout forms; K9, K13 and K8 (both entries) at
     t5-small's FFN (relu, H = 512, F = 2048, zero biases) at 6400, 1024
     and 4001 rows in bf16 and f32, timed at 6400 and 1024, and K8's
     refusal of an H that is not a multiple of 128 (check_t5_kernels);
     K4 at the T5 pairs' cross-attention steps (8 and 6 heads, scale 1.0,
     kb 1 and 4, float and int8 K/V) and K5 on their beam caches
     (check_t5_decode);
     K1 and K14 are timed at the path's three
     attention shapes (B = 16; T = 800, 400, causal 64), K6 at each of the
     six extractor layers;
  4. drive the flagship (wav2vec2-base + bart-base, down_scale 2, fused
     extractor, random weights from the seed, bf16 matrices) through
     generate() at B = 16 x 16 s, max_length 64, in three modes: greedy
     (K1-K3 18 launches per call, K3 as its three passes, K6 6, K4 768),
     greedy with int8 cross K/V
     (K4's int8 entry 6 per step) and beam search with 4 beams (K5 once per
     step, K4 twelve times per K5 launch); in f32 the text-encoder output,
     the tokens of all three modes and the beam scores of the kernel path
     must agree with the plain path's within the stated limits;
     then the other modes of generate() (run_generate_modes), each in bf16
     with its exact launches (K4 and K5 by expected_launches), two calls
     with one seed bit-identical, its output properties, the median ms of
     three calls, audio-s/s and the busy share of a profiled call: sampled
     greedy (temperature 0.7, top_k 50, top_p 0.9, typical_p 0.95), the HF
     processors on greedy (repetition penalty, no-repeat 3-grams,
     min_length 8, bad words of one and two tokens, suppressed and
     begin-suppressed tokens, forced BOS / EOS), beam-sample with 4 beams
     (top_k 50), group beam search (4 beams, 2 groups, diversity 0.5, 2
     returned), constrained beam search (a 2-token phrase and a
     disjunctive set; again with int8 cross K/V), early_stop greedy (no
     repeated bigrams, no EOS at step 0) with final_logits_bias[eos] moved
     so that rows end at different steps (fewer steps, the tokens of the
     fixed-length call) and greedy with prefix_allowed_tokens_fn; in f32
     each mode's tokens through the kernels must equal those through the
     plain versions;
     then the flagship's f32 path (run_f32_flagship): greedy generate and
     the default recipe's train step (Adafactor, dropout on) in f32, each
     the median of three calls after a warm-up with its exact launches,
     peak memory, busy share and the port's kernels' device ms, and one
     step with dropout off for the deterministic entries' launches;
  5. training: in f32 at full width with 2 + 2 + 2 layers the gradient tree
     through the kernels must agree with the one through their plain
     versions, without and with dropout (one key, so the same masks); then
     the flagship at full width and depth takes 8 AdamW steps (bf16 compute,
     f32 parameters, B = 16 x 16 s, 64 label positions) on one batch: the
     loss must fall and every step must launch K1, K3, K7, K9 and K8's
     recompute and products 24 times each (K3 and K9: the up pass 48, the
     down pass, the down pass to z and the rows 24 each), K2 30 times and
     K6 6 times, and print the device ms of K8, of the passes, of the
     attention backward's three kernels, of K1 / K14, of K6 and of K2 / K11
     with their backward products; then
     8 more with dropout on at the presets' rates, SpecAugment and LayerDrop:
     with k speech layers skipped, K14, K15, K12, K13, K8's dropout
     recompute and its products 24 - k times (the dropout up pass 48 - 2k),
     K11 30 - k, K10 64 - 2k, K6 6, and no deterministic twin;
     then the large pair and the variants (Adafactor, unfreezing);
     then the loop (run_trainer): the flagship through the port's Trainer
     with the default recipe, 2 epochs of 4 steps over the 4-16 s buckets
     of the synthetic corpus, eval + greedy predict and npz checkpoints
     every 4 steps, each step's launches against its LayerDrop draw and
     unfreezing mask, the eval step without backward kernels, the
     checkpoints' bits on restore, a resumed Trainer's first step against
     step_fn on the restored state, load-best-at-end, and the teacher
     (K1-K4 in f32) against the plain path's tokens; it prints ms per step
     through fit beside the bare step, eval, predict and checkpoint times;
     then the T5 family (run_t5): wav2vec2-base + t5-small (greedy,
     greedy-int8, beam-4; an AdamW step without and with dropout) and +
     byt5-small (greedy, beam-4, one step) at full width and depth, B = 16
     x 16 s, 64 steps, each with exact launches (K4 for the
     cross-attention only, t5-small's FFN as K9 / K13 and K8 at 6400 and
     1024 rows), two calls bit-identical, ms, audio-s/s, peak memory and
     busy share, the f32 tokens of the kernels equal to the plain path's,
     and the t5-small gradient tree at 2 + 2 + 2 layers in f32 (a relu
     fc1 kernel gradient allowed, beyond the limit, the terms of the a's
     that the data shows may flip sign between the paths);
     then the serving surface (run_serving), the flagship at full width
     and depth, B = 16 x 16 s, 64 steps, bf16: int8 weights
     (quantize_weights) in greedy, greedy-int8 and beam-4 with exact
     launches (no K2, K3 or K9: the gate sends int8 blocks to the plain
     chain), two calls bit-identical, ms, audio-s/s, peak memory, busy
     share and the weight bytes against the bf16 tree's, the int8 product
     (torch._int_mm, padded) equal to the CPU's and its speech-encoder
     error under set_int8_dense_compute within 0.08 of the peak, fused
     q/k/v on float and int8 weights; in f32 the int8 tokens of the
     kernels equal to the plain path's and the fused trees' to the
     unfused ones'; the CTC head (wav2vec2-base + 32 tokens): forward
     launches, f32 logits against the plain path, ctc_greedy_decode, 8
     AdamW steps on the CTC loss with exact launches and a falling loss;
     the loaders: export_speechmix -> torch.save -> a composite
     config.json, HFSpeechMixEED.from_reference_checkpoint and
     load_hf_checkpoint on the card, parameters and bf16 tokens
     bit-identical to the source; the API: SpeechMixEED("wav2vec2-base",
     "bart-base", down_scale=2, dtype="bfloat16") forward with labels,
     generate greedy and beam-4 bit-identical to generation.generate,
     save_pretrained -> from_pretrained; the TranscriptionPipeline over 64
     utterances of 1-30 s (two chunked, one too short) with float32 and
     int16 transfer, every transcript equal to a direct generate() of its
     bucket's batch, wall time and audio-s/s, the busy share of the float32
     run; one batch of each bucket (4-20 s) through the kernels against
     the plain path: the text encoder's output in bf16 and f32, the f32
     greedy tokens equal; the phase's seconds by part and by kind of work
     (busy shares are read from the profiler's raw events,
     device_totals);
     then the commands (run_commands): python -m speechmix_tpu_torch.train
     on the flagship (the preset with the fused extractor; bf16, the
     synthetic corpus, B = 16, the default recipe: Adafactor, dropout,
     freeze_epochs 3) for 4 steps with an eval + greedy predict at the
     last, again with --no-dropout for one step, then
     speechmix_tpu_torch.eval on its final_weights.npz (--synthetic_eval 16
     --beam 4, and one utterance greedy; f32): each step's, eval's and
     predict's exact launches against its LayerDrop draw and unfreezing
     mask, finite logged losses, the npz in the JAX package's layout with
     the trained bits (loaded by the API), the eval JSON and decoded line,
     and every kernel K1-K15 launched across the phase; remat (run_remat):
     one dropout step of the flagship and of the large pair with remat off,
     off and on, one key: equal losses, gradients bit-identical where the
     two remat-off runs are, launches with remat_launches added, the bytes
     the forward leaves for the backward, then train steps in turns with
     their ms and peak memory; the profiler (run_profiler): utils/
     profiling.trace around a greedy generate, the file holding the
     phase's annotate spans and K1's and K4's kernels; the native runtime
     (run_native) against the numpy plain versions on 64 utterances, host
     ms both ways; then parallelism (run_parallel, the flagship at full
     width and depth, B = 16 x 16 s): an NCCL group of world size 1 through
     the mesh code (the 1x1x1 mesh's bf16 dropout step and greedy pipeline
     bit-identical to the no-mesh path, the same launches), then four
     ranks sharing cuda:0 over gloo (spawned after the build): the f32
     gradient at (2, 2, 1) with ZeRO-1 and at (1, 2, 2) with the ring
     against the one-card f32 step's (loss, every leaf), each rank's
     launches exact, ms per step, peak memory, optimizer bytes against
     unsharded and bytes staged through the host; a bf16 dropout-on step
     at (2, 2, 1) twice, bit-identical; TranscriptionPipeline over (2, 2)
     on 16 utterances, f32 tokens equal to one card's and bf16 tokens
     agreeing; every time labelled as four ranks sharing one card, not a
     multi-card time; then wav2vec2-xls-r-1b + bart-large (run_xl_pair:
     the XLS-R 1B config.json fields through convert.config_from_hf, 48 +
     12 + 12 layers, 16 heads of 80, H = 1280, bf16, B = 16 x 16 s):
     greedy and beam-4 generate with exact launches (K1 at D = 80 in every
     speech layer), bf16 Adafactor dropout-on train steps (K14 / K15 at
     D = 80) with a falling loss and their peak memory, the f32 gradient of
     a 2 + 2 + 2 cut against the plain path (f32 K1 / K7 at D = 80, K9 /
     K8 at H = 1280); then the tiny presets through the commands on the
     card (run_tiny_commands: train with --bf16 and eval on tiny-speech +
     tiny-bart-bytes and + tiny-t5-bytes, K1, K4 at D = 16 and K6 at
     C = 32 launched);
  6. print the `kernels` JSON line (K9, K13 and K8 at t5-small's FFN with
     their launches at 6400 and 1024 rows; K1, K14, K7 and K15 with a record per
     attention length of the step and its launches there, K6 one per
     extractor layer, K4 one per decoder shape with its launches at that key
     length and its serial body's ms), then the card line, then the result
     line
     {"ok": true, "device": {...}} last.
Without CUDA it exits 1 before printing any result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core rate, HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# the least time for f32-accurate products on this card: min(FLOPs / 67
# TFLOP/s on the CUDA cores, 3 FLOPs / 495 TFLOP/s as three tf32 products
# on the tensor cores) = FLOPs / 165 TFLOP/s, the bound of every f32 row
PEAK_F32_FLOPS = 495e12 / 3

# stated tolerances of kernel vs plain version: |k - p| <= atol + rtol * |p|
# f32: accumulation order only (sums of up to 3072 products);
# bf16: two bf16 ulps (2 * 2^-8 relative) of the rounded output, which the
# LayerNorm of K2 / K3 keeps near 1.  K1 in bf16 has its own limit
# (attention_bf16_limit): its outputs are averages of about 0.06.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1.6e-2)}
# flagship text-encoder output, relative Frobenius error against the f32
# plain path: f32 kernels (order of summation only) and bf16 kernels
REL_BOUND_F32 = 1e-3
REL_BOUND_BF16 = 5e-2
LAYERS_WITH_KERNELS = 12 + 6  # wav2vec2-base layers + bart-base encoder
FUSED_CONV_LAYERS = 6         # stride-2 extractor layers 1..6
DECODER_LAYERS = 6
# K6 in bf16: kernel and plain version round one f32 value of order 1 to
# bf16 each, from sums taken in another order, so they are at most one bf16
# ulp apart (<= 2^-7 |p|); 1e-4 covers outputs near zero
K6_BF16_RULE = "1e-4 + 2^-7 * |p|"


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    """Device milliseconds per call of fn.  The card is first kept busy for
    about 25 ms, so that the host has queued every launch before the first
    one starts: the events then span the launches back to back, without the
    gaps a host-bound loop of short kernels would leave between them."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name, out, ref, limit=None, rule=None, allow_count=0):
    """max |out - ref| after asserting |out - ref| <= limit elementwise;
    the limit defaults to the dtype's TOL.  `allow_count` elements may lie
    outside it (0 but for K8 under relu, whose derivative jumps)."""
    import torch
    o, r = out.float(), ref.float()
    if limit is None:
        atol, rtol = TOL[str(out.dtype).replace("torch.", "")]
        limit = atol + rtol * r.abs()
        rule = f"atol {atol}, rtol {rtol}"
    if not torch.isfinite(o).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (o - r).abs()
    bad = err > limit
    max_err = err.max().item()
    # where the limit is 0 (a masked key's gradient) the error must be 0
    ratio = torch.where(err > 0, err / limit, 0.0).max().item()
    failed = int(bad.sum()) > allow_count
    outside = (f", {int(bad.sum())} elements outside ({allow_count} allowed)"
               if allow_count else "")
    log(f"  {name}: max_abs_err {max_err:.3e}, max err/limit {ratio:.3f} "
        f"({rule}){outside} {'FAIL' if failed else 'ok'}")
    if failed:
        raise AssertionError(f"{name}: {int(bad.sum())} elements outside "
                             "tolerance")
    return max_err


def attention_bf16_limit(q, k, v, mask, heads, scale, causal, ref,
                         dmask=None):
    """K1's bf16 limit per output element, from its error model: the kernel
    rounds each probability to bf16 (relative error <= 2^-9) before P . v,
    so before its own rounding it is off by at most 2^-9 * sum_j p_j |v_j|;
    then kernel and plain version each round to bf16 (one ulp apart at most,
    <= 2^-7 |p|).  The limit doubles the first term:
    2^-8 * (P |v|) + 2^-7 * |p|.  K14 (dmask): P becomes P * m, whose
    entries carry the 1/(1-r) scale."""
    from speechmix_tpu_torch.ops.kernels import attention as ka
    pv = ka.attention_fwd_plain(q.float(), k.float(), v.float().abs(), mask,
                                heads, scale, causal, dmask=dmask)
    return 2.0 ** -8 * pv + 2.0 ** -7 * ref.float().abs()


K1_BF16_RULE = "2^-8 * (P|v|) + 2^-7 * |p|"


def check_attention_fwd(name, q, k, v, mask, heads, causal, scale=0.125):
    """K1 on one input against its plain version (output and lse), in
    bf16 against attention_fwd_tiled_plain (the bf16 body's tiles), and
    against itself in a second call, bit for bit.  Returns the max error
    against the plain version."""
    import torch
    from speechmix_tpu_torch.ops.kernels import attention as ka
    out, lse = ka.attention_fwd(q, k, v, mask, heads, scale, causal,
                                return_lse=True)
    ref, ref_lse = ka.attention_fwd_plain(q, k, v, mask, heads, scale, causal,
                                          return_lse=True)
    torch.cuda.synchronize()
    limit = rule = None
    if q.dtype == torch.bfloat16:
        limit = attention_bf16_limit(q, k, v, mask, heads, scale, causal, ref)
        rule = K1_BF16_RULE
    err = compare(name, out, ref, limit, rule)
    compare(f"{name} lse", lse, ref_lse, 1e-4 + 1e-4 * ref_lse.abs(),
            "atol 1e-4, rtol 1e-4")
    if q.dtype == torch.bfloat16:
        tiled = ka.attention_fwd_tiled_plain(q, k, v, mask, heads, scale,
                                             causal)
        compare(f"{name} vs tiled", out, tiled,
                attention_bf16_limit(q, k, v, mask, heads, scale, causal,
                                     tiled), K1_BF16_RULE)
    expect_equal(f"K1 {name}", (out, lse), ka.attention_fwd(
        q, k, v, mask, heads, scale, causal, return_lse=True))
    return err


def check_kernels(gen, dev):
    """Phase 3.  Returns the per-kernel records of the main-path shape."""
    import torch
    import torch.nn.functional as F
    from speechmix_tpu_torch.ops.kernels import attention as ka
    from speechmix_tpu_torch.ops.kernels import ffn as kf

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dtype)

    records = {}
    # ---- K1: attention at the speech-encoder shape and beyond -----------
    log("K1 attention_fwd")
    heads, d = 12, 64
    for (b, t), causal_opts in (((4, 800), (False, True)), ((4, 400), (False,)),
                                ((4, 1500), (False, True))):
        lens = torch.tensor([t, t - 37, t // 2 + 3, t - 200], device=dev)
        mask = torch.arange(t, device=dev)[None, :] < lens[:, None]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (randn(b, t, heads * d, dtype=dtype) for _ in range(3))
            for causal in causal_opts:
                check_attention_fwd(f"B={b} T={t} {dtype} causal={causal}",
                                    q, k, v, mask, heads, causal)
    # the bodies' edges: a causal batch row without any valid key and one
    # whose keys start at 150 (its first queries have no allowed key,
    # beside rows that have one, so their blocks visit every key tile),
    # query and key lengths apart, a single query, one 64-query block
    late = torch.ones(3, 300, dtype=torch.bool, device=dev)
    late[1, :150] = False
    late[2] = False
    for name, b, tq, tk, causal, mask in (
            ("masked rows", 3, 100, 100, True, torch.arange(
                100, device=dev)[None, :] < torch.tensor(
                    [0, 100, 41], device=dev)[:, None]),
            ("late first key", 3, 300, 300, True, late),
            ("Tq != Tk", 2, 130, 200, False, None),
            ("Tq != Tk", 2, 200, 130, True, None),
            ("one query", 2, 1, 70, False, None),
            ("one block", 2, 64, 64, False, None)):
        for dtype in (torch.bfloat16, torch.float32):
            q = randn(b, tq, heads * d, dtype=dtype)
            k, v = (randn(b, tk, heads * d, dtype=dtype) for _ in range(2))
            check_attention_fwd(f"{name} B={b} Tq={tq} Tk={tk} {dtype} "
                                f"causal={causal}", q, k, v, mask, heads,
                                causal)
    # inputs the tensor-core kernels cannot load (TMA: 16-byte-aligned
    # bases) are refused, not served by another kernel
    for label, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        slab = torch.empty(4 * 400 * heads * d + 1, dtype=dtype, device=dev)
        q_off = slab[1:].view(4, 400, heads * d)
        k = randn(4, 400, heads * d, dtype=dtype)
        expect_refusal(f"K1 {label} q at a {slab.element_size()}-byte "
                       "offset", lambda: ka.attention_fwd(
                           q_off, k, k, None, heads, 0.125))
    # timing at the path's three launch shapes, bf16, every key valid: the
    # speech encoder (B=16, T=800), the text encoder (T=400) and the
    # decoder's causal self-attention in the train step (T=64)
    for suffix, b, t, causal in (("", 16, 800, False),
                                 (" (text encoder)", 16, 400, False),
                                 (" (decoder, causal)", 16, 64, True)):
        mask = torch.ones(b, t, dtype=torch.bool, device=dev)
        q, k, v = (randn(b, t, heads * d, dtype=torch.bfloat16)
                   for _ in range(3))
        err = check_attention_fwd(f"B={b} T={t} bf16 causal={causal} "
                                  "(timed)", q, k, v, mask, heads, causal)
        qh, kh, vh = (x.view(b, t, heads, d).transpose(1, 2)
                      for x in (q, k, v))
        allowed = int(mask.sum()) * t if not causal else b * t * (t + 1) // 2
        records["attention_fwd" + suffix] = dict(
            shape=f"B={b} T={t} H={heads} D={d} bf16 causal={causal}",
            max_abs_err=err,
            ms=cuda_ms(lambda: ka.attention_fwd(q, k, v, mask, heads, 0.125,
                                                causal)),
            plain_ms=cuda_ms(lambda: ka.attention_fwd_plain(
                q, k, v, mask, heads, 0.125, causal)),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask[:, None, None, :],
                is_causal=False, scale=0.125) if not causal else
                F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                               scale=0.125)),
            flops=4.0 * heads * d * allowed,
            bytes=4 * b * t * heads * d * 2 + b * t)
        if suffix:  # the speech encoder's: the whole generate call's
            records["attention_fwd" + suffix]["length"] = t

    # the other TPU attention kernels K1 covers, at the shapes checked
    # above: T = 400 (one block of keys on the TPU) and T = 1500 (tiled)
    for b, t in ((4, 400), (4, 1500)):
        lens = torch.tensor([t, t - 37, t // 2 + 3, t - 200], device=dev)
        mask = torch.arange(t, device=dev)[None, :] < lens[:, None]
        q, k, v = (randn(b, t, heads * d, dtype=torch.bfloat16)
                   for _ in range(3))
        err = check_attention_fwd(f"B={b} T={t} bf16 (timed)", q, k, v, mask,
                                  heads, False)
        qh, kh, vh = (x.view(b, t, heads, d).transpose(1, 2)
                      for x in (q, k, v))
        sdpa_mask = mask[:, None, None, :]
        records[f"attention_fwd (B={b} T={t})"] = dict(
            shape=f"B={b} T={t} H={heads} D={d} bf16, ragged lengths",
            max_abs_err=err,
            ms=cuda_ms(lambda: ka.attention_fwd(q, k, v, mask, heads, 0.125)),
            plain_ms=cuda_ms(lambda: ka.attention_fwd_plain(q, k, v, mask,
                                                            heads, 0.125)),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=sdpa_mask, scale=0.125)),
            flops=4.0 * heads * d * t * int(lens.sum()),
            bytes=4 * b * t * heads * d * 2 + b * t)

    # ---- K2: attention out-projection + residual + LayerNorm ------------
    log("K2 dense_res_ln")
    h = 768
    for dtype in (torch.bfloat16, torch.float32):
        for n in (4096, 4001):
            x, res = randn(n, h, dtype=dtype), randn(n, h, dtype=dtype)
            w = randn(h, h, scale=0.03, dtype=dtype)
            bias, g, beta = (randn(h, scale=0.1) for _ in range(3))
            g = g + 1.0
            out = kf.dense_res_ln(x, w, bias, res, g, beta)
            ref = kf.dense_res_ln_plain(x, w, bias, res, g, beta)
            torch.cuda.synchronize()
            e = compare(f"N={n} Din=H={h} {dtype}", out, ref)
            if dtype == torch.bfloat16:
                expect_equal(f"K2 N={n} Din=H={h}", (out,),
                             (kf.dense_res_ln(x, w, bias, res, g, beta),))
            if dtype == torch.bfloat16 and n == 4096:
                err = e
                args = (x, w, bias, res, g, beta)
    x, w, bias, res, g, beta = args
    n = 4096
    wt, bias_c, g_c, beta_c = w.t(), bias.to(x.dtype), g.to(x.dtype), \
        beta.to(x.dtype)
    records["dense_res_ln"] = dict(
        shape=f"N={n} Din=H={h} bf16", max_abs_err=err,
        ms=cuda_ms(lambda: kf.dense_res_ln(*args)),
        plain_ms=cuda_ms(lambda: kf.dense_res_ln_plain(*args)),
        library_ms=cuda_ms(lambda: F.layer_norm(
            res + F.linear(x, wt, bias_c), (h,), g_c, beta_c, 1e-5)),
        flops=2.0 * n * h * h,
        bytes=(2 * n * h + h * h + n * h) * 2 + 3 * h * 4)

    # ---- K3: FFN + residual + LayerNorm ----------------------------------
    log("K3 ffn_res_ln")
    f = 3072
    bf16, f32 = torch.bfloat16, torch.float32
    for dtype in (bf16, f32):
        x, res = randn(4096, h, dtype=dtype), randn(4096, h, dtype=dtype)
        w1 = randn(h, f, scale=0.03, dtype=dtype)
        w2 = randn(f, h, scale=0.03, dtype=dtype)
        b1, b2, g, beta = (randn(s, scale=0.1) for s in (f, h, h, h))
        g = g + 1.0
        for act in ("gelu", "gelu_new", "relu", "silu"):
            out = kf.ffn_res_ln(x, w1, b1, w2, b2, res, g, beta, act)
            ref = kf.ffn_res_ln_plain(x, w1, b1, w2, b2, res, g, beta, act)
            torch.cuda.synchronize()
            e = compare(f"N=4096 H={h} F={f} {act} {dtype}", out, ref)
            if dtype == torch.bfloat16 and act == "gelu":
                err = e
                args = (x, w1, b1, w2, b2, res, g, beta, "gelu")
        xr, rr = x[:4001].contiguous(), res[:4001].contiguous()
        compare(f"N=4001 (ragged) H={h} F={f} gelu {dtype}",
                kf.ffn_res_ln(xr, w1, b1, w2, b2, rr, g, beta),
                kf.ffn_res_ln_plain(xr, w1, b1, w2, b2, rr, g, beta))
        if dtype == bf16:
            expect_equal("K3 N=4001 (ragged)",
                         (kf.ffn_res_ln(xr, w1, b1, w2, b2, rr, g, beta),),
                         (kf.ffn_res_ln(xr, w1, b1, w2, b2, rr, g, beta),))
    # other widths: bart-large (h 1024, f 4096) in both dtypes; h 256 and
    # h 64 in float32; in bfloat16 K2 and K3 refuse widths that are not
    # multiples of 128 and take the others (what the TPU package's gate
    # admits): h 256, h 512 under relu, h 1536 under gelu (K2: the down pass
    # to the f32 sum and the rows)
    for hh, ff, act, dtypes in ((1024, 4096, "gelu", (bf16, f32)),
                                (256, 1024, "gelu", (bf16, f32)),
                                (64, 128, "gelu", (bf16, f32)),
                                (512, 2048, "relu", (bf16,)),
                                (1536, 6144, "gelu", (bf16,))):
        for dtype in dtypes:
            xo, ro = randn(1000, hh, dtype=dtype), randn(1000, hh, dtype=dtype)
            wo = randn(hh, hh, scale=0.03, dtype=dtype)
            w1o = randn(hh, ff, scale=0.03, dtype=dtype)
            w2o = randn(ff, hh, scale=0.03, dtype=dtype)
            bo, go, beo = (randn(hh, scale=0.1) for _ in range(3))
            b1o = randn(ff, scale=0.1)
            k3 = (xo, w1o, b1o, w2o, bo, ro, go + 1, beo, act)
            k2 = (xo, wo, bo, ro, go + 1, beo)
            if dtype == bf16 and hh % kf.FWD_WIDTH:
                expect_refusal(f"K2 N=1000 Din=H={hh} {dtype}",
                               lambda: kf.dense_res_ln(*k2))
            elif dtype == bf16 or hh <= kf.MAX_HIDDEN:
                compare(f"K2 N=1000 Din=H={hh} {dtype}",
                        kf.dense_res_ln(*k2), kf.dense_res_ln_plain(*k2))
            if dtype == bf16 and hh % kf.FWD_WIDTH:
                expect_refusal(f"K3 N=1000 H={hh} F={ff} {dtype}",
                               lambda: kf.ffn_res_ln(*k3))
                continue
            compare(f"K3 N=1000 H={hh} F={ff} {act} {dtype}",
                    kf.ffn_res_ln(*k3), kf.ffn_res_ln_plain(*k3))
            if dtype == bf16:
                expect_equal(f"K3 N=1000 H={hh} F={ff} {act}",
                             (kf.ffn_res_ln(*k3),), (kf.ffn_res_ln(*k3),))
    check_dense_widths(randn, dev)
    x, w1, b1, w2, b2, res, g, beta, _ = args
    n = 4096
    w1t, w2t = w1.t(), w2.t()
    b1c, b2c, gc, betac = (t_.to(x.dtype) for t_ in (b1, b2, g, beta))
    records["ffn_res_ln"] = dict(
        shape=f"N={n} H={h} F={f} gelu bf16", max_abs_err=err,
        ms=cuda_ms(lambda: kf.ffn_res_ln(*args)),
        plain_ms=cuda_ms(lambda: kf.ffn_res_ln_plain(*args)),
        library_ms=cuda_ms(lambda: F.layer_norm(
            res + F.linear(F.gelu(F.linear(x, w1t, b1c)), w2t, b2c), (h,),
            gc, betac, 1e-5)),
        flops=4.0 * n * h * f,
        bytes=(3 * n * h + 2 * h * f) * 2 + (f + 3 * h) * 4)

    check_decode_attention(randn, dev, records)
    check_beam_gather(randn, gen, dev, records)
    check_conv(randn, dev, records)
    check_conv_backward(randn, dev, records)
    check_train_kernels(randn, dev, records)
    check_trainable_functions(randn, dev)
    check_dropout_kernels(randn, dev, records)
    check_large_kernels(randn, dev, records)
    check_t5_kernels(randn, dev, records)
    check_t5_decode(randn, gen, dev, records)
    check_head_widths(randn, gen, dev, records)
    check_k8_f32_body(randn, dev)
    check_f32_rows(randn, dev, records)
    check_f32_forward_widths(randn, dev)

    for rec in records.values():
        t_flops = rec["flops"] / rec.get("peak_flops", PEAK_BF16_FLOPS) * 1e3
        t_bytes = rec["bytes"] / PEAK_BYTES * 1e3
        rec["bound_ms"] = max(t_flops, t_bytes)
        rec["bound_by"] = "operations" if t_flops >= t_bytes else "bytes"
        extra = "".join(f" {k} {v:.4f}" for k, v in rec.items()
                        if k.startswith("library_ms_"))
        lib = ("none" if rec["library_ms"] is None
               else f"{rec['library_ms']:.4f}")
        log(f"  {rec['shape']}: kernel_ms {rec['ms']:.4f} plain_ms "
            f"{rec['plain_ms']:.4f} library_ms {lib}{extra} "
            f"bound_ms {rec['bound_ms']:.4f} ({rec['bound_by']})")
    return records


def check_dense_widths(randn, dev):
    """K2 and K11 in bf16 at every kind of width the gate admits: one to
    eight blocks of 256 columns (h 256 .. 1024; h 1536 is six), a width 256
    does not divide (h 384: three blocks of 128), Din != H both ways, above
    the cluster (h 2304: the down pass to z and the rows), and rows off the
    128-row tile, each against its plain version (K11 given the plain
    generator's mask, which K10 draws bit for bit) and against the tiled
    plain version, and twice, bit for bit."""
    import torch
    from speechmix_tpu_torch.ops.kernels import dropout as kd
    from speechmix_tpu_torch.ops.kernels import ffn as kf

    rate, bf16 = DROP_RATE, torch.bfloat16
    key = kd.DropoutKey.from_seed(11)
    atol, rtol = _dropout_tol(TOL["bfloat16"], rate)
    rule = f"atol {atol:.4g}, rtol {rtol:.4g} (TOL / (1-r))"
    log("K2 / K11 in bf16 across widths and row counts")
    for n, din, hh in ((1000, 256, 256), (1000, 512, 512), (1000, 768, 768),
                       (1000, 1024, 1024), (1000, 1536, 1536),
                       (1000, 384, 384), (1000, 1024, 768),
                       (1000, 768, 1024), (1000, 2304, 2304),
                       (4001, 768, 768)):
        x, res = randn(n, din, dtype=bf16), randn(n, hh, dtype=bf16)
        w = randn(din, hh, scale=0.03, dtype=bf16)
        b, g, beta = (randn(hh, scale=0.1) for _ in range(3))
        k2 = (x, w, b, res, g + 1.0, beta)
        omask = kd.dropout_mask_plain(key, kd.STREAM_OUT, n, hh, rate, dev)
        what = f"N={n} Din={din} H={hh}"
        out2 = kf.dense_res_ln(*k2)
        compare(f"K2 {what}", out2, kf.dense_res_ln_plain(*k2))
        compare(f"K2 {what} vs tiled", out2, kf.dense_res_ln_tiled_plain(*k2))
        expect_equal(f"K2 {what}", (out2,), (kf.dense_res_ln(*k2),))
        out11 = kf.dense_dropout_res_ln(*k2, key, rate)
        ref = kf.dense_dropout_res_ln_plain(*k2, omask)
        compare(f"K11 {what}", out11, ref, atol + rtol * ref.float().abs(),
                rule)
        ref = kf.dense_res_ln_tiled_plain(*k2, omask)
        compare(f"K11 {what} vs tiled", out11, ref,
                atol + rtol * ref.float().abs(), rule)
        expect_equal(f"K11 {what}", (out11,),
                     (kf.dense_dropout_res_ln(*k2, key, rate),))


def decode_bf16_limit(q, k, v, mask, scales, ref, scale=0.125):
    """K4's bf16 limit per output element.  Kernel and plain version both
    round the probabilities to bf16 before P . v, from scores summed in
    another order, so a probability may land one bf16 step apart (relative
    2^-8): at most 2^-8 * sum_j p_j |v_j| before the output's own rounding,
    where the two may again be one ulp apart (<= 2^-7 |p|).  The same form
    as K1's limit."""
    from speechmix_tpu_torch.ops.kernels import decode_attention as kd
    pv = kd.decode_attention_plain(q.float(), k, v.abs(), mask, scale=scale,
                                   num_heads=k.shape[2], **scales)
    return 2.0 ** -8 * pv + 2.0 ** -7 * ref.float().abs()


# K4 at the decoder's shapes: (name, K/V rows, queries per row, keys)
DECODE_SHAPES = (("self greedy", 16, 1, 64), ("self beam-4", 64, 1, 64),
                 ("cross greedy", 16, 1, 400), ("cross beam-4", 16, 4, 400),
                 ("cross greedy T=1500", 16, 1, 1500),
                 # the pipeline's 20 s bucket: four shares of 125 keys
                 ("cross greedy T=500", 16, 1, 500),
                 # its 8 s and 12 s buckets: clusters of 2 and 3 ranks
                 ("cross greedy T=200", 16, 1, 200),
                 ("cross greedy T=300", 16, 1, 300))


def decode_mask(name, bkv, t, dev):
    """Self-attention: the slots up to the row's step are filled; cross-
    attention: encoder rows of t / 2 to t valid frames."""
    import torch
    rows = torch.arange(bkv, device=dev)
    fill = (rows % t if name.startswith("self")
            else t - 1 - (rows * 23) % (t // 2))
    return torch.arange(t, device=dev)[None, :] <= fill[:, None]


def check_decode_case(name, q, k, v, mask, scales, scale=0.125):
    """K4 on one input at attention scale `scale` against its plain version
    and, in bf16, against decode_attention_split_plain (the cluster body's
    ranges) and itself in a second call, bit for bit.  Returns the max
    error against the plain version."""
    import torch
    from speechmix_tpu_torch.ops.kernels import decode_attention as kd
    args = dict(scale=scale, num_heads=k.shape[2], **scales)
    out = kd.decode_attention(q, k, v, mask, **args)
    ref = kd.decode_attention_plain(q, k, v, mask, **args)
    torch.cuda.synchronize()
    if q.dtype != torch.bfloat16:
        return compare(name, out, ref)
    err = compare(name, out, ref, decode_bf16_limit(q, k, v, mask, scales,
                                                    ref, scale), K1_BF16_RULE)
    split = kd.decode_attention_split_plain(q, k, v, mask, **args)
    compare(f"{name} vs split", out, split,
            decode_bf16_limit(q, k, v, mask, scales, split, scale),
            K1_BF16_RULE)
    expect_equal(f"K4 {name}", (out,), (kd.decode_attention(q, k, v, mask,
                                                            **args),))
    return err


def check_decode_attention(randn, dev, records):
    """K4 at the decoder's shapes: self-attention over the 64-slot cache
    (16 rows greedy, 64 rows with 4 beams) and cross-attention over 400
    encoder positions with kb = 1 (greedy) and kb = 4 (beams share K/V), and
    over 1500 (30 s of audio) and 500, 300 and 200 (the pipeline's 20,
    12 and 8 s buckets: shares of 125 keys, which are odd, and clusters of
    3 and 2 ranks), float and int8 K/V, ragged masks; then mask
    rows with a fully masked row, one key, holes and late keys."""
    import torch
    from speechmix_tpu_torch.models.seq2seq import _quantize_kv
    from speechmix_tpu_torch.ops.kernels import decode_attention as kd

    log("K4 decode_attention")
    heads, d = 12, 64
    timed = {}
    for name, bkv, kb, t in DECODE_SHAPES:
        mask = decode_mask(name, bkv, t, dev)
        for dtype in (torch.bfloat16, torch.float32):
            q = randn(bkv * kb, 1, heads, d, dtype=dtype)
            k, v = (randn(bkv, t, heads, d, dtype=dtype) for _ in range(2))
            variants = [("float", k, v, {})]
            if name.startswith("cross"):
                (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
                variants.append(("int8", kq, vq,
                                 dict(k_scale=ks, v_scale=vs)))
            for kind, kk, vv, scales in variants:
                err = check_decode_case(
                    f"{name} B={bkv} kb={kb} T={t} {kind} K/V {dtype}", q,
                    kk, vv, mask, scales)
                if dtype == torch.bfloat16 and t < 1500:
                    timed[name, kind] = (q, kk, vv, mask, scales, err)
    # mask rows: none attended (softmax over the scores shifted by -1e9, the
    # plain version's result), key 0 alone, a prefix with holes, all, a
    # late window only (earlier ranges without an attended key) and the
    # last key alone; kb = 2
    for t in (100, 400, 1500):
        lens = torch.tensor([0, 1, 37, t, 0, 0], device=dev)
        mask = torch.arange(t, device=dev)[None, :] < lens[:, None]
        mask[2, 1::3] = False
        mask[4, t // 2:t // 2 + 10] = True
        mask[5, t - 1] = True
        for dtype in (torch.bfloat16, torch.float32):
            q = randn(12, 1, heads, d, dtype=dtype)
            k, v = (randn(6, t, heads, d, dtype=dtype) for _ in range(2))
            (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
            for kind, kk, vv, scales in (("float", k, v, {}),
                                         ("int8", kq, vq,
                                          dict(k_scale=ks, v_scale=vs))):
                check_decode_case(
                    f"rows fully masked / 1 key / with holes / full / late "
                    f"window / last key, kb=2 T={t} {kind} K/V {dtype}", q,
                    kk, vv, mask, scales)
    # refusals: a head_dim the kernel is not built for (not a multiple of
    # 8), K/V in another type than q, a misaligned q
    q = randn(16, 1, heads, d, dtype=torch.bfloat16)
    k = randn(16, 64, heads, d, dtype=torch.bfloat16)
    mask = torch.ones(16, 64, dtype=torch.bool, device=dev)
    k20 = randn(16, 64, 4, 20, dtype=torch.bfloat16)
    expect_refusal("K4 head_dim 20", lambda: kd.decode_attention(
        randn(16, 1, 4, 20, dtype=torch.bfloat16), k20, k20, mask,
        scale=0.125, num_heads=4))
    expect_refusal("K4 f32 K/V under a bf16 q", lambda: kd.decode_attention(
        q, k.float(), k.float(), mask, scale=0.125, num_heads=heads))
    slab = torch.empty(16 * heads * d + 1, dtype=torch.bfloat16, device=dev)
    expect_refusal("K4 bf16 q at a 2-byte offset", lambda: kd.decode_attention(
        slab[1:].view(16, 1, heads, d), k, k, mask, scale=0.125,
        num_heads=heads))

    for (name, kind), (q, k, v, mask, scales, err) in timed.items():
        rec = decode_record(name, kind, q, k, v, mask, scales, err, 0.125,
                            DECODER_LAYERS if name.startswith("cross")
                            else 1)
        entry = "decode_attention" if kind == "float" else "decode_attention_q8"
        records[entry if name == "cross greedy"
                else f"{entry} ({name})"] = rec


def decode_record(name, kind, q, k, v, mask, scales, err, scale, copies):
    """The timed record of K4 on one bf16 input at attention scale `scale`:
    the kernel, its serial body, its plain version and
    scaled_dot_product_attention.  Cross-attention reads another layer's
    K/V at every call: six layers' worth of the flagship's (62 to 118 MB)
    is more than the 50 MB L2 holds, so the timed calls cycle over `copies`
    copies (the decoder's layers) and find the cache as the decoder does;
    the self-attention cache (9 MB) stays in L2 (copies = 1)."""
    import torch
    import torch.nn.functional as F
    from speechmix_tpu_torch.ops.kernels import decode_attention as kd
    heads, d = k.shape[2:]

    def sdpa(q, k, v, mask, scales):
        bkv, t = k.shape[:2]
        if scales:   # dequantisation is part of what the library call costs
            k = k.to(q.dtype) * scales["k_scale"][..., None].to(q.dtype)
            v = v.to(q.dtype) * scales["v_scale"][..., None].to(q.dtype)
        qh = q.view(bkv, -1, heads, d).transpose(1, 2)
        return F.scaled_dot_product_attention(
            qh, k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask[:, None, None, :], scale=scale)

    sets = [(k, v, scales)] + [
        (k.clone(), v.clone(), {n: s_.clone() for n, s_ in scales.items()})
        for _ in range(copies - 1)]
    turn = itertools.cycle(sets)

    def timed_ms(fn):
        return cuda_ms(lambda: fn(*next(turn)), iters=60, warmup=6)
    # a masked key adds exactly 0 to the output, so the function needs K, V
    # and scale rows of attended keys only (as K1's count does); these
    # masks attend a prefix of the keys, which is what K4 reads
    attended = int(mask.sum().item())
    kb = q.shape[0] // k.shape[0]
    nbytes = (attended * heads * d * k.element_size() * 2
              + q.numel() * q.element_size() * 2 + mask.numel()
              + attended * heads * 4 * len(scales))
    args = dict(scale=scale, num_heads=heads)
    qtype = "f32" if q.dtype == torch.float32 else "bf16"
    rec = dict(
        shape=f"{name}: q {tuple(q.shape)} k/v {tuple(k.shape)} {kind} K/V "
              f"{qtype} q, scale {scale}, {attended} of {mask.numel()} keys "
              "attended",
        max_abs_err=err, length=k.shape[1],
        ms=timed_ms(lambda k_, v_, sc: kd.decode_attention(
            q, k_, v_, mask, **args, **sc)),
        serial_ms=timed_ms(lambda k_, v_, sc: kd.decode_attention_serial(
            q, k_, v_, mask, **args, **sc)),
        plain_ms=timed_ms(lambda k_, v_, sc: kd.decode_attention_plain(
            q, k_, v_, mask, **args, **sc)),
        library_ms=timed_ms(lambda k_, v_, sc: sdpa(q, k_, v_, mask, sc)),
        flops=4.0 * kb * attended * heads * d, bytes=nbytes)
    log(f"  {name} {kind} K/V, {heads} heads, scale {scale}: "
        f"{rec['ms']:.4f} ms, the serial body alone {rec['serial_ms']:.4f} "
        "ms")
    return rec


def check_beam_gather(randn, gen, dev, records):
    """K5 on the flagship's beam-4 self-attention cache: bit-exact against
    index_select, with repeated and identity rows, in both dtypes; its
    refusals."""
    import torch
    from speechmix_tpu_torch.ops.kernels import beam_gather as kg

    log("K5 beam_gather")
    args = beam_gather_case(randn, gen, dev, DECODER_LAYERS, 12)
    expect_refusal("K5 output into its input", lambda: kg.beam_gather(
        args[0], args[1], args[2], out=(args[0], args[3][1])))
    small = randn(2, 4, 3, dtype=torch.bfloat16)
    expect_refusal("K5 slab of 6 bytes", lambda: kg.beam_gather(
        small, small.clone(), torch.zeros(4, dtype=torch.int32, device=dev)))
    records["beam_gather"] = beam_gather_record(*args)


def beam_gather_case(randn, gen, dev, layers, heads, batch=16, beams=4):
    """K5 on a (layers, batch x beams, 64, heads, 64) cache: bit-exact
    against index_select into new and into given buffers, with repeated
    and identity rows, in bf16 and f32.  Returns the bf16 (key, value,
    src, spare buffers)."""
    import torch
    from speechmix_tpu_torch.ops.kernels import beam_gather as kg

    rows = batch * beams
    for dtype in (torch.bfloat16, torch.float32):
        key, value = (randn(layers, rows, 64, heads, 64, dtype=dtype)
                      for _ in range(2))
        idx = torch.randint(0, beams, (batch, beams), generator=gen,
                            device=dev)
        idx[0] = torch.arange(beams, device=dev)        # identity rows
        idx[1] = 2                                       # one row four times
        src = (torch.arange(batch, device=dev)[:, None] * beams
               + idx).reshape(-1).to(torch.int32)
        spare = (torch.empty_like(key), torch.empty_like(value))
        for out_arg, what in ((None, "new buffers"), (spare, "given buffers")):
            out_k, out_v = kg.beam_gather(key, value, src, out=out_arg)
            ref_k, ref_v = kg.beam_gather_plain(key, value, src)
            torch.cuda.synchronize()
            exact = torch.equal(out_k, ref_k) and torch.equal(out_v, ref_v)
            log(f"  L={layers} N={rows} slab (64, {heads}, 64) {dtype}, "
                f"{what}: {'bit-exact' if exact else 'DIFFERS'}")
            if not exact:
                raise AssertionError("beam_gather differs from index_select")
        if dtype == torch.bfloat16:
            args = (key, value, src, spare)
    return args


def beam_gather_record(key, value, src, spare):
    """The timed record of K5 on one bf16 cache: the kernel, its plain
    version and index_select."""
    import torch
    from speechmix_tpu_torch.ops.kernels import beam_gather as kg
    idx64 = src.long()
    return dict(
        shape=f"K, V {tuple(key.shape)} bf16", max_abs_err=0.0,
        ms=cuda_ms(lambda: kg.beam_gather(key, value, src, out=spare)),
        plain_ms=cuda_ms(lambda: kg.beam_gather_plain(key, value, src,
                                                      out=spare)),
        library_ms=cuda_ms(lambda: (torch.index_select(key, 1, idx64),
                                    torch.index_select(value, 1, idx64))),
        flops=0.0, bytes=4.0 * key.numel() * key.element_size())


def extractor_geometry():
    """(T_in, k) of the fused extractor layers 1.. of the flagship at
    SECONDS, its samples padded as generate() and the train step pad them
    (wav2vec2-base: T_in = 51263, 25631, ..., 1601)."""
    from speechmix_tpu_torch import config
    enc = config.SPEECH_ENCODER_PRESETS["wav2vec2-base"]
    t = enc.aligned_samples(int(SECONDS * 16000))
    out = []
    for layer, (k, s) in enumerate(zip(enc.conv_kernels, enc.conv_strides)):
        if layer:
            out.append((t, k))
        t = (t - k) // s + 1
    return tuple(out)


def check_conv(randn, dev, records):
    """K6 at the six fused layers of the flagship extractor at 16 s
    (extractor_geometry: k = 3 then 2, C = 512), with and without the
    LayerNorm epilogue; bf16 at B = 16 (also against
    fused_conv_layer_tiled_plain, the bf16 body's tiles, and twice, bit for
    bit; timed at each layer without LayerNorm, as the flagship runs it),
    f32 at B = 4."""
    import torch
    import torch.nn.functional as F
    from speechmix_tpu_torch.ops.kernels import conv_extractor as kc

    log("K6 conv_ln_gelu")
    c = 512
    geometry = extractor_geometry()
    for dtype, b in ((torch.bfloat16, 16), (torch.float32, 4)):
        for layer, (t_in, k) in enumerate(geometry, start=1):
            x = randn(b, t_in, c, dtype=dtype)
            w = randn(c, c, k, scale=(k * c) ** -0.5, dtype=dtype)
            bias, g, beta = (randn(c, scale=0.1) for _ in range(3))
            for ln in (None, {"scale": g + 1.0, "bias": beta}):
                out = kc.fused_conv_layer(x, w, bias, ln)
                ref = kc.fused_conv_layer_plain(x, w, bias, ln)
                torch.cuda.synchronize()
                what = (f"B={b} T_in={t_in} k={k} C={c} ln={ln is not None} "
                        f"{dtype}")
                limit = rule = None
                if dtype == torch.bfloat16:
                    limit = 1e-4 + 2.0 ** -7 * ref.float().abs()
                    rule = K6_BF16_RULE
                err = compare(what, out, ref, limit, rule)
                if dtype != torch.bfloat16:
                    expect_equal(f"K6 {what}", (out,),
                                 (kc.fused_conv_layer(x, w, bias, ln),))
                    continue
                tiled = kc.fused_conv_layer_tiled_plain(x, w, bias, ln)
                compare(f"{what} vs tiled", out, tiled,
                        1e-4 + 2.0 ** -7 * tiled.float().abs(), K6_BF16_RULE)
                del tiled
                expect_equal(f"K6 {what}", (out,),
                             (kc.fused_conv_layer(x, w, bias, ln),))
                if ln is None:
                    conv_record(records, layer, x, w, bias, err)
            del x, out, ref
    expect_refusal("K6 bf16 C=1536", lambda: kc.fused_conv_layer(
        randn(2, 100, 1536, dtype=torch.bfloat16),
        randn(1536, 1536, 3, dtype=torch.bfloat16)))
    expect_refusal("K6 k=5", lambda: kc.fused_conv_layer(
        randn(2, 100, c), randn(c, c, 5)))


def conv_record(records, layer, x, w, bias, err):
    """The timed record of K6 at one extractor layer (bf16, no LayerNorm):
    "conv_ln_gelu" at layer 1, "conv_ln_gelu (layer L)" after it, with the
    launches at its T_in."""
    import torch.nn.functional as F
    from speechmix_tpu_torch.ops.kernels import conv_extractor as kc
    b, t_in, c = x.shape
    k = w.shape[-1]
    n = b * ((t_in - k) // 2 + 1)
    iters = 10 if t_in > 10000 else 20
    # the library conv wants channels first: timed on a contiguous (B, C, T)
    # tensor, what the port's "conv" route feeds it layer after layer (it
    # never holds (B, T, C)), and on the transposed view of K6's own input
    xt_view = x.transpose(1, 2)
    xt = xt_view.contiguous()
    bias_c = bias.to(x.dtype)
    library = lambda inp: F.gelu(F.conv1d(inp, w, bias_c, stride=2))
    rec = dict(
        shape=f"x ({b}, {t_in}, {c}) k={k} stride 2, no LayerNorm, bf16",
        max_abs_err=err,
        ms=cuda_ms(lambda: kc.fused_conv_layer(x, w, bias), iters=iters),
        plain_ms=cuda_ms(lambda: kc.fused_conv_layer_plain(x, w, bias),
                         iters=5),
        library_ms=cuda_ms(lambda: library(xt), iters=iters),
        library_ms_transposed_view=cuda_ms(lambda: library(xt_view),
                                           iters=iters),
        flops=2.0 * n * k * c * c,
        bytes=(x.numel() + n * c + w.numel()) * 2 + c * 4)
    if layer == 1:   # its launches: the whole generate call's
        records["conv_ln_gelu"] = rec
    else:
        records[f"conv_ln_gelu (layer {layer})"] = dict(rec, t_in=t_in)


# K6's backward (conv_bwd.cu) against the library gradient in float64
# (library_conv_grads), each gradient's largest error over its largest
# magnitude.  float32: three tf32 products an f32 product (about 2^-21
# relative each), f32 sums over fixed row ranges of ~37k rows, 2e-5 as the
# CPU tests' limit; bfloat16: gz and dx rounded once to bf16 (2^-9) before
# the products that read them, 1e-2
CONV_BWD_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
CONV_BWD = ("smx_conv_bwd_act", "smx_conv_bwd_data", "smx_conv_bwd_weight")
CONV_BWD_NAMES = ("dx", "dkernel", "dbias", "dscale", "dbeta")
# the widths and layouts K6's backward takes, small: (dtype, C, k,
# LayerNorm, bias, B, T_in).  C 32 / 64: one block of 64 columns; 96, 256,
# 512, 1024: clusters of one to eight blocks of 128; 36 and 100: padded to
# 40 and 104 zero channels, the LayerNorm over C; T_out 131, 100, 81 and
# 149 end in a ragged row tile
CONV_BWD_CASES = (
    ("float32", 32, 3, True, True, 2, 263),
    ("float32", 32, 2, False, False, 2, 262),
    ("bfloat16", 32, 2, False, True, 2, 262),
    ("bfloat16", 64, 3, True, False, 2, 263),
    ("float32", 64, 2, False, True, 2, 200),
    ("float32", 96, 3, True, True, 3, 201),
    ("bfloat16", 96, 2, True, True, 3, 200),
    ("float32", 256, 3, True, True, 2, 301),
    ("float32", 512, 3, False, False, 2, 301),
    ("float32", 512, 2, False, False, 2, 300),
    ("bfloat16", 512, 3, True, True, 2, 301),
    ("bfloat16", 512, 2, True, True, 2, 300),
    ("bfloat16", 1024, 3, True, True, 2, 161),
    ("float32", 1024, 2, False, False, 2, 160),
    ("float32", 36, 3, True, True, 2, 263),
    ("bfloat16", 36, 2, False, True, 2, 262),
    ("bfloat16", 100, 2, True, False, 2, 200),
    ("float32", 100, 3, False, True, 2, 201),
)


def check_conv_backward_widths(randn):
    """K6's backward at CONV_BWD_CASES: each gradient against
    conv_layer_backward_tiled_plain (the kernels' tiles, stages and row
    ranges, f32 products with TF32 off) at CONV_BWD_TOL of its largest
    magnitude, and two calls bit for bit."""
    import torch
    from speechmix_tpu_torch.ops.kernels import conv_extractor as kc
    for dname, c, k, ln, bias, b, t_in in CONV_BWD_CASES:
        dtype = getattr(torch, dname)
        tol = CONV_BWD_TOL[dname]
        x = randn(b, t_in, c, dtype=dtype)
        w = randn(c, c, k, scale=(k * c) ** -0.5)
        bv = randn(c, scale=0.1) if bias else None
        norm = ({"scale": 1.0 + randn(c, scale=0.1),
                 "bias": randn(c, scale=0.1)} if ln else None)
        dout = randn(b, (t_in - k) // 2 + 1, c, dtype=dtype)
        needs = (True, True, bias, ln, ln)
        got = kc.conv_layer_backward(x, w, bv, norm, 1e-5, dout, needs)
        ref = kc.conv_layer_backward_tiled_plain(x, w.to(dtype), bv, norm,
                                                 1e-5, dout, needs)
        what = (f"K6 backward B={b} T_in={t_in} C={c} k={k} {dname} "
                f"LayerNorm={ln} bias={bias}")
        for name, g, r in zip(CONV_BWD_NAMES, got, ref):
            if r is not None:
                compare(f"{what} {name} vs tiled", g, r,
                        tol * r.float().abs().max(), f"{tol} x max |ref|")
        expect_equal(what, [g for g in got if g is not None],
                     [g for g in kc.conv_layer_backward(
                         x, w, bv, norm, 1e-5, dout, needs)
                      if g is not None])


def check_conv_backward(randn, dev, records):
    """K6's backward, its three passes (conv_bwd.cu): first at every kind of
    width and layout (check_conv_backward_widths), then at the six fused
    extractor layers at 16 s (extractor_geometry) with B = 16: the
    flagship's (float32, no bias, no LayerNorm) and XLS-R 1B's (bfloat16,
    bias and LayerNorm).  Per layer dx, dkernel, dbias, dscale, dbeta
    against the library gradient of the layer (library_conv_grads: autograd
    in float64) and twice bit for bit; the kernel ms of each pass, the
    plain version's and the library's (conv_bwd_record); then the whole
    stack's backward (fused_conv_stack through autograd) against the
    library gradient of the stack and twice bit for bit."""
    import torch
    from speechmix_tpu_torch.ops import kernels
    from speechmix_tpu_torch.ops.kernels import conv_extractor as kc

    log("K6 backward (conv_bwd.cu: smx_conv_bwd_act, _data, _weight)")
    check_conv_backward_widths(randn)
    c, b = 512, 16
    geometry = extractor_geometry()
    for dtype, ln, bias in ((torch.float32, False, False),
                            (torch.bfloat16, True, True)):
        dname = str(dtype).replace("torch.", "")
        tol = CONV_BWD_TOL[dname]
        layers = []
        for layer, (t_in, k) in enumerate(geometry, start=1):
            x = randn(b, t_in, c, dtype=dtype)
            w = randn(c, c, k, scale=(k * c) ** -0.5)
            bv = randn(c, scale=0.1) if bias else None
            norm = ({"scale": 1.0 + randn(c, scale=0.1),
                     "bias": randn(c, scale=0.1)} if ln else None)
            layers.append((w, bv, None if norm is None else norm["scale"],
                           None if norm is None else norm["bias"]))
            t_out = (t_in - k) // 2 + 1
            dout = randn(b, t_out, c, dtype=dtype)
            needs = (True, True, bias, ln, ln)
            got = kc.conv_layer_backward(x, w, bv, norm, 1e-5, dout, needs)
            torch.cuda.synchronize()
            ref = library_conv_grads(x, [layers[-1]], ln, dout)
            what = f"layer {layer} B={b} T_in={t_in} k={k} {dname}"
            errs = {name: compare(f"{what} {name}", g, r,
                                  tol * r.float().abs().max(),
                                  f"{tol} x max |ref|")
                    for name, g, r in zip(CONV_BWD_NAMES, got, ref)
                    if r is not None}
            expect_equal(f"K6 backward {what}", [g for g in got
                                                 if g is not None],
                         [g for g in kc.conv_layer_backward(
                             x, w, bv, norm, 1e-5, dout, needs)
                          if g is not None])
            del got, ref
            conv_bwd_record(records, layer, x, w, bv, norm, dout, errs)
            del x, dout
            torch.cuda.empty_cache()
        # the stack: autograd through fused_conv_stack, twice, and the
        # library gradient of the whole chain
        t_in, t_last = geometry[0][0], geometry[-1][0]
        t_last = (t_last - geometry[-1][1]) // 2 + 1
        x = randn(b, t_in, c, dtype=dtype)
        gout = randn(b, t_last, c, dtype=dtype)
        leaves = [None if t is None else t.clone().requires_grad_()
                  for layer in layers for t in layer]
        params = [{"conv": {"kernel": leaves[4 * i],
                            **({"bias": leaves[4 * i + 1]} if bias else {})},
                   **({"norm": {"scale": leaves[4 * i + 2],
                                "bias": leaves[4 * i + 3]}} if ln else {})}
                  for i in range(len(layers))]
        xin = x.clone().requires_grad_()
        wanted = [xin] + [t for t in leaves if t is not None]

        def stack_grads():
            kernels.reset_launch_counts()
            y = kc.fused_conv_stack(xin, params, ln, 1e-5)
            out = torch.autograd.grad(y, wanted, gout)
            torch.cuda.synchronize()
            return out, {k.symbol: k.launches for k in kernels.kernels()
                         if k.symbol in CONV_BWD + ("smx_conv_ln_gelu",)}
        g1, launches = stack_grads()
        g2, _ = stack_grads()
        want = dict.fromkeys(CONV_BWD + ("smx_conv_ln_gelu",), len(layers))
        if launches != want:
            raise AssertionError(f"K6 backward stack launches {launches}, "
                                 f"expected {want}")
        expect_equal(f"K6 backward stack {dname}", g1, g2)
        ref = [r for r in library_conv_grads(x, layers, ln, gout)
               if r is not None]
        # bf16: each layer rounds gz once more than the reference, and
        # independent roundings add in quadrature over the layers; the
        # reading against the per-layer limit is logged beside it
        stack_tol = tol * (len(layers) ** 0.5 if dtype == torch.bfloat16
                           else 1.0)
        for i, (g, r) in enumerate(zip(g1, ref)):
            scale = r.float().abs().max()
            ratio = float((g.float() - r.float()).abs().max() / (tol * scale))
            log(f"  K6 backward stack {dname} gradient {i}: max err/limit "
                f"{ratio:.3f} against the per-layer {tol}")
            compare(f"K6 backward stack {dname} gradient {i}", g, r,
                    stack_tol * scale, f"{stack_tol:.3g} x max |ref|")
        log(f"  K6 backward stack {dname}: launches {launches}")
        del g1, g2, ref, x, xin
        torch.cuda.empty_cache()


def library_conv_grads(x, layers, ln, dout):
    """(dx, then per layer dkernel, dbias, dscale, dbeta; None where the
    layer has none) of the stack's chain in float64 by autograd: library
    convolutions, bias, LayerNorm and exact-erf GELU, each layer's output
    rounded to x's dtype.  float64, because an f32 library sum over the
    400k rows of layer 1 rounds by as much as the kernels' own (2^-24
    sqrt(N / 2), ~3e-5 of the sum)."""
    import torch
    import torch.nn.functional as F
    d = torch.float64
    xf = x.to(d).requires_grad_()
    leaves = [None if t is None else t.to(d).detach().requires_grad_()
              for layer in layers for t in layer]
    with torch.enable_grad():
        y = xf
        for kernel, bias, scale, beta in zip(*[iter(leaves)] * 4):
            z = F.conv1d(y.transpose(1, 2), kernel, None,
                         stride=2).transpose(1, 2)
            if bias is not None:
                z = z + bias
            if ln:
                z = F.layer_norm(z, (z.shape[-1],), scale, beta, 1e-5)
            # each layer's output rounded to x's dtype, as the port and the
            # JAX package store it (its gradient passes through unchanged)
            y = F.gelu(z).to(x.dtype).to(d)
        wanted = [xf] + [t for t in leaves if t is not None]
        got = iter(torch.autograd.grad(y, wanted, dout.to(d)))
    dx = next(got)
    return [dx] + [None if t is None else next(got) for t in leaves]


def conv_bwd_record(records, layer, x, w, bias, norm, dout, errs):
    """The timed records of K6's backward at one layer: each pass's kernel
    ms, its plain version's (conv_bwd_act_plain, _data_plain,
    _weight_plain: library calls in float32) and the library's (cuDNN in
    x's dtype: the recompute's fprop, dgrad, wgrad), with the pass's FLOPs
    and bytes and its largest error of check_conv_backward (`errs`: by
    gradient; the act pass every gradient's, since each is computed from
    its gz; data dx's, weight dkernel's)."""
    import torch
    import torch.nn.functional as F
    from speechmix_tpu_torch.ops.kernels import conv_extractor as kc
    b, t_in, c = x.shape
    k = w.shape[-1]
    t_out = dout.shape[1]
    f32 = x.dtype == torch.float32
    es = x.element_size()
    wx = w.to(x.dtype)
    vectors = bias is not None or norm is not None
    gz, gzt, _ = kc.conv_bwd_act(x, wx, bias, norm, 1e-5, dout, f32, vectors)
    iters = 5 if t_in > 10000 else 10
    xc = x.transpose(1, 2)
    gc = gz.transpose(1, 2).contiguous()
    flops = 2.0 * b * t_out * k * c * c
    peak = PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS
    passes = {
        "act": (lambda: kc.conv_bwd_act(x, wx, bias, norm, 1e-5, dout, f32,
                                        vectors),
                lambda: kc.conv_bwd_act_plain(x, wx, bias, norm, 1e-5, dout),
                lambda: F.conv1d(xc, wx, None, stride=2),
                (x.numel() + 2 * dout.numel()) * es
                + (dout.numel() * 4 if f32 else 0),
                max(errs.values())),
        "data": (lambda: kc.conv_bwd_data(gz, wx, t_in),
                 lambda: kc.conv_bwd_data_plain(gz, wx, t_in),
                 lambda: torch.nn.grad.conv1d_input(xc.shape, wx, gc,
                                                    stride=2),
                 (dout.numel() + x.numel()) * es, errs["dx"]),
        "weight": (lambda: kc.conv_bwd_weight(x, wx, gz, gzt),
                   lambda: kc.conv_bwd_weight_plain(x, wx, gz),
                   lambda: torch.nn.grad.conv1d_weight(xc, wx.shape, gc,
                                                       stride=2),
                   (x.numel() + dout.numel()) * es, errs["dkernel"])}
    dname = "f32" if f32 else "bf16"
    # the f32 records are counted by T_in in the f32 flagship's step, the
    # bf16 ones (XLS-R 1B's layout) by C in the XL pair's step
    at = dict(t_in=t_in) if f32 else dict(width=c)
    for name, (kernel, plain, library, nbytes, err) in passes.items():
        records[f"conv_bwd {name} (layer {layer}, {dname})"] = dict(
            shape=f"x ({b}, {t_in}, {c}) k={k}, {dname}, "
                  f"{'bias + LayerNorm' if norm is not None else 'no bias'}",
            max_abs_err=err, ms=cuda_ms(kernel, iters=iters),
            plain_ms=cuda_ms(plain, iters=3, warmup=1),
            library_ms=cuda_ms(library, iters=iters),
            flops=flops, bytes=nbytes, peak_flops=peak, **at)
    rec = [records[f"conv_bwd {n} (layer {layer}, {dname})"] for n in passes]
    ms, plain, lib = (" / ".join(f"{r[key]:.3f}" for r in rec)
                      for key in ("ms", "plain_ms", "library_ms"))
    log(f"  layer {layer} {dname}: act / data / weight {ms} ms; plain "
        f"{plain} ms; library fprop / dgrad / wgrad {lib} ms; bound "
        f"{flops / peak * 1e3:.3f} ms a pass")


def attention_bwd_bf16_limits(q, k, v, mask, out, g, heads, scale, causal,
                              refs, dmask=None):
    """K7's bf16 limits per element of (dq, dk, dv), in the form of K1's.
    Kernel and plain version round p and ds to bf16 from f32 values that
    differ in their last bits, so an element may land one bf16 step apart
    (relative 2^-8, doubled here); and the kernel takes delta = g . out from
    the forward output, which is rounded to bf16 (relative 2^-9, doubled),
    where the plain version sums p * dp in f32.  With
      ds_err = 2^-7 |ds| + p * 2^-8 (|g| . |out|):
      dq: scale * (ds_err |k|),  dk: scale * (ds_err^T |q|),
      dv: 2^-7 * (p^T |g|),  each + 2^-7 * |ref| for the outputs' rounding.
    K15 (dmask, entries 0 or 1/(1-r)): dp and the dv weights carry the mask,
    dp = (g v^T) m and p^T becomes (p m)^T, so the 1/(1-r) scale enters the
    limits where it enters the gradients."""
    import torch
    from speechmix_tpu_torch.ops.kernels import attention as ka
    b, tq, hd = q.shape
    tk, d = k.shape[1], hd // heads
    p = torch.softmax(ka._masked_scores(q, k, mask, heads, scale, causal), -1)
    split = lambda x, t: x.float().reshape(b, t, heads, d)
    qf, kf, vf, gf = split(q, tq), split(k, tk), split(v, tk), split(g, tq)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    pd = p
    if dmask is not None:
        dp, pd = dp * dmask, p * dmask
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    delta_err = 2.0 ** -8 * (gf.abs() * split(out, tq).abs()).sum(-1)
    ds_err = 2.0 ** -7 * ds.abs() + p * delta_err.permute(0, 2, 1)[..., None]
    bounds = (torch.einsum("bhqk,bkhd->bqhd", ds_err, kf.abs()) * scale,
              torch.einsum("bhqk,bqhd->bkhd", ds_err, qf.abs()) * scale,
              2.0 ** -7 * torch.einsum("bhqk,bqhd->bkhd", pd, gf.abs()))
    return [bound.reshape(ref.shape) + 2.0 ** -7 * ref.float().abs()
            for bound, ref in zip(bounds, refs)]


K7_BF16_RULE = ("ds_err = 2^-7|ds| + p 2^-8 (|g|.|out|): scale ds_err|k|, "
                "scale ds_err^T|q|, 2^-7 p^T|g|; + 2^-7|ref|")
# K8's float32 weight gradients under bf16 inputs are sums over the N rows
# (1000 to 12800 here) of products x * da (h * g) of order 1.  Kernel and
# plain version round da and h to bf16 from f32 values that differ in their
# last bits, so a few of the N land one bf16 step apart, each moving a sum by
# up to 2^-8 |x| |da| (0.06 at 4 sigma); 0.25 allows four of them in one sum.
K8_DW_BF16_TOL = (0.25, 2e-3)
# in float32 the same sums differ by their order only: terms of order 1
K8_DW_F32_TOL = (5e-4, 1e-4)
# relu' jumps at 0: where a = x w1 + b1 lies within f32 rounding of 0 (taken
# as |a| < 2e-6 for sums of 768 products of order 0.03), kernel and plain
# version may take different branches, which moves that a's row of dx, its
# column of dw1 and its entry of db1 by up to |dh| |w1|, |x| |dh| and |dh|.
# Under relu that many rows, columns and entries may lie outside the limits.
K8_RELU_NEAR_ZERO = 2e-6


def expect_equal(name, got, again):
    """Two calls of a kernel path without atomics give the same bits."""
    import torch
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name}: two calls differ")
    log(f"  {name}: two calls bit-identical")


# K8's products alone, f32 sums of K = 12800 products against the f32
# reference product: each side's error is a rounding of the running sum per
# step, a random walk of about sqrt(K) 2^-24 of the sum of the absolute
# products; 2^-12 of that sum leaves a factor of 30 above it
K8_PRODUCT_RULE = "2^-12 * (|A||B|) + 1e-6 (f32 sums)"


def check_products_alone(randn, x, g, w1):
    """The TMA + wgmma GEMM of K8 at the three products it runs, given
    random h and da: dx = da w1^T (bf16 out), dw1 = x^T da and dw2 = h^T g
    (f32) against the same products in f32 (TF32 off) rounded as the
    kernel rounds, db1 against the sum of the tile sums; and twice, bit for
    bit."""
    import torch
    from speechmix_tpu_torch.ops.kernels import ffn as kf
    (n, h), f = x.shape, w1.shape[1]
    hid, da = randn(n, f, dtype=x.dtype), randn(n, f, dtype=x.dtype)
    colsum = randn(-(-n // kf.ROW_TILE), f)
    got = kf.ffn_bwd_products(x, g, w1, hid, da, colsum)
    torch.cuda.synchronize()
    what = f"K8 products alone N={n} H={h} F={f}"
    expect_equal(what, got, kf.ffn_bwd_products(x, g, w1, hid, da, colsum))
    compare(f"{what} dx = da w1^T", got[0],
            (da.float() @ w1.float().t()).to(x.dtype))
    for name_, o, a, b in (("dw1 = x^T da", got[1], x, da),
                           ("dw2 = h^T g", got[3], hid, g)):
        a, b = a.float().t(), b.float()
        compare(f"{what} {name_}", o, a @ b,
                2.0 ** -12 * (a.abs() @ b.abs()) + 1e-6, K8_PRODUCT_RULE)
    compare(f"{what} db1", got[2], colsum.sum(0),
            1e-4 + 1e-4 * colsum.abs().sum(0), "1e-4 (1 + sum |tile sums|)")


# the down pass alone, f32 sums of K = F products against the f32 reference
# product: the same random-walk argument as K8_PRODUCT_RULE's, K = 3072
DOWN_RULE = "2^-12 * (|h||w2|) + 1e-6 (f32 sums)"


def check_down_alone(randn, w2, b2, res):
    """The TMA + wgmma GEMM of the bf16 forward's down pass given a random
    h: h w2 + b2 rounded to bf16 (K9's) and h w2 + b2 + res in f32 (K3's
    sum before its LayerNorm) against the same product in f32 (TF32 off);
    and twice, bit for bit."""
    import torch
    from speechmix_tpu_torch.ops.kernels import ffn as kf
    (f, h), n = w2.shape, res.shape[0]
    hid = randn(n, f, dtype=w2.dtype)
    what = f"down pass alone N={n} H={h} F={f}"
    y = kf.ffn_down(hid, w2, b2)
    z = kf.ffn_down(hid, w2, b2, res)
    torch.cuda.synchronize()
    expect_equal(what, (y, z), (kf.ffn_down(hid, w2, b2),
                                kf.ffn_down(hid, w2, b2, res)))
    ref = hid.float() @ w2.float() + b2
    compare(f"{what} round(h w2 + b2)", y, ref.to(y.dtype))
    compare(f"{what} h w2 + b2 + res (f32)", z, ref + res.float(),
            2.0 ** -12 * (hid.float().abs() @ w2.float().abs()) + 1e-6,
            DOWN_RULE)


def check_train_kernels(randn, dev, records):
    """The kernels of the training step at the flagship's shapes, bf16 and
    f32: K1's log-sum-exp output, K7 attention_bwd, K8 ffn_bwd (both
    entries) and K9 ffn_fused, each against its plain version."""
    import torch
    import torch.nn.functional as F
    from speechmix_tpu_torch.ops.kernels import attention as ka
    from speechmix_tpu_torch.ops.kernels import ffn as kf

    heads, d, scale = 12, 64, 0.125
    log("K1 log-sum-exp and K7 attention_bwd")

    def attention_case(b, t, causal, dtype, lens=None, name=""):
        if lens is None:
            lens = [t, t - 37, t // 2 + 3, t - min(200, t // 3)][:b]
        lens = torch.tensor(lens, device=dev)
        mask = torch.arange(t, device=dev)[None, :] < lens[:, None]
        q, k, v, g = (randn(b, t, heads * d, dtype=dtype) for _ in range(4))
        out, lse = ka.attention_fwd(q, k, v, mask, heads, scale, causal,
                                    return_lse=True)
        ref_out, ref_lse = ka.attention_fwd_plain(q, k, v, mask, heads, scale,
                                                  causal, return_lse=True)
        got = ka.attention_bwd(q, k, v, mask, out, lse, g, heads, scale,
                               causal)
        refs = ka.attention_bwd_plain(q, k, v, mask, g, heads, scale, causal)
        # the kernels' tiles in plain PyTorch, from the kernel's out and lse
        tiled = ka.attention_bwd_tiled_plain(q, k, v, mask, out, lse, g,
                                             heads, scale, causal)
        torch.cuda.synchronize()
        what = f"{name}B={b} T={t} {dtype} causal={causal}"
        # the log-sum-exp is float32 in both dtypes: summation order only
        # (a fully masked row gives -1e30 in both)
        compare(f"lse {what}", lse, ref_lse, 1e-4 + 1e-4 * ref_lse.abs(),
                "atol 1e-4, rtol 1e-4")
        errs = []
        for against, ref3 in (("", refs), (" vs tiled", tiled)):
            limits = [None] * 3
            rule = None
            if dtype == torch.bfloat16:
                limits = attention_bwd_bf16_limits(q, k, v, mask, ref_out, g,
                                                   heads, scale, causal, ref3)
                rule = K7_BF16_RULE
            errs += [compare(f"{n_} {what}{against}", o, r, lim, rule)
                     for n_, o, r, lim in zip(("dq", "dk", "dv"), got, ref3,
                                              limits)]
        return max(errs), (q, k, v, mask, out, lse, g, causal, lens)

    timed = {}
    for dtype in (torch.bfloat16, torch.float32):
        for b, t, causal in ((4, 800, False), (4, 400, False), (4, 64, True),
                             (2, 1500, False), (2, 1500, True)):
            attention_case(b, t, causal, dtype)
        # a row whose keys are all masked (lengths 0), alone and under causal
        attention_case(3, 100, False, dtype, [0, 100, 41], "masked row ")
        attention_case(3, 100, True, dtype, [0, 100, 41], "masked row ")
    # the three shapes of the train step, bf16: speech encoder, text encoder,
    # decoder self-attention
    for name, b, t, causal in (("attention_bwd", 16, 800, False),
                               ("attention_bwd (text encoder)", 16, 400,
                                False),
                               ("attention_bwd (decoder, causal)", 16, 64,
                                True)):
        err, case = attention_case(b, t, causal, torch.bfloat16, [t] * b,
                                   "timed ")
        timed[name] = (err, case)
    slab = torch.empty(4 * 64 * heads * d + 1, dtype=torch.bfloat16,
                       device=dev)
    q = randn(4, 64, heads * d, dtype=torch.bfloat16)
    lse = randn(4, heads, 64)
    expect_refusal("K7 bf16 g at a 2-byte offset", lambda: ka.attention_bwd(
        q, q, q, None, q, lse, slab[1:].view(4, 64, heads * d), heads, scale))
    expect_refusal("K7 lse in bf16", lambda: ka.attention_bwd(
        q, q, q, None, q, lse.bfloat16(), q, heads, scale))
    for name, (err, (q, k, v, mask, out, lse, g, causal, lens)) in \
            timed.items():
        b, t, _ = q.shape
        k7 = lambda: ka.attention_bwd(q, k, v, mask, out, lse, g, heads,
                                      scale, causal)
        expect_equal(f"K7 {name} B={b} T={t}", k7(), k7())
        qh, kh, vh = (x.view(b, t, heads, d).transpose(1, 2).detach()
                      .requires_grad_() for x in (q, k, v))
        allowed = mask[:, None, :].expand(b, t, t)
        if causal:
            allowed = allowed & torch.ones(t, t, dtype=torch.bool,
                                           device=dev).tril()
        lib_out = F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=allowed[:, None], scale=scale)
        gh = g.view(b, t, heads, d).transpose(1, 2)
        records[name] = dict(
            shape=f"B={b} T={t} H={heads} D={d} bf16 causal={causal}",
            length=t, max_abs_err=err,
            ms=cuda_ms(k7),
            plain_ms=cuda_ms(lambda: ka.attention_bwd_plain(
                q, k, v, mask, g, heads, scale, causal), iters=5),
            library_ms=cuda_ms(lambda: torch.autograd.grad(
                lib_out, (qh, kh, vh), gh, retain_graph=True)),
            flops=10.0 * heads * d * int(allowed.sum()),
            bytes=8 * b * t * heads * d * 2 + b * heads * t * 4 + b * t)
        del lib_out

    log("K9 ffn_fused and K8 ffn_bwd")
    bf16, f32 = torch.bfloat16, torch.float32

    def ffn_operands(n, hh, ff, dtype):
        x, g = randn(n, hh, dtype=dtype), randn(n, hh, dtype=dtype)
        w1 = randn(hh, ff, scale=0.03, dtype=dtype)
        w2 = randn(ff, hh, scale=0.03, dtype=dtype)
        return x, g, w1, randn(ff, scale=0.1), w2, randn(hh, scale=0.1)

    def ffn_case(x, g, w1, b1, w2, b2, act="gelu"):
        """K9 and K8 against their plain versions; returns
        the largest errors of (K9, K8 dx, K8 dw)."""
        (n, hh), ff = x.shape, w1.shape[1]
        what = f"N={n} H={hh} F={ff} {act} {x.dtype}"
        dw_tol = K8_DW_BF16_TOL if x.dtype == bf16 else K8_DW_F32_TOL
        dw_rule = f"atol {dw_tol[0]}, rtol {dw_tol[1]}"
        near = 0
        if act == "relu":
            a = x.float() @ w1.float() + b1
            near = int((a.abs() < K8_RELU_NEAR_ZERO).sum())
            log(f"  relu: {near} of {a.numel()} a within "
                f"{K8_RELU_NEAR_ZERO} of 0")
            del a
        e9 = compare(f"K9 {what}", kf.ffn_fused(x, w1, b1, w2, b2, act),
                     kf.ffn_fused_plain(x, w1, b1, w2, b2, act))
        if x.dtype == bf16:
            expect_equal(f"K9 {what}",
                         (kf.ffn_fused(x, w1, b1, w2, b2, act),),
                         (kf.ffn_fused(x, w1, b1, w2, b2, act),))
        got = kf.ffn_bwd(x, g, w1, b1, w2, act)
        ref = kf.ffn_bwd_plain(x, g, w1, b1, w2, act)
        torch.cuda.synchronize()
        expect_equal(f"K8 {what}", got, kf.ffn_bwd(x, g, w1, b1, w2, act))
        edx = compare(f"K8 dx {what}", got[0], ref[0], allow_count=near * hh)
        edw = max(compare(f"K8 {name} {what}", o, r,
                          dw_tol[0] + dw_tol[1] * r.abs(), dw_rule,
                          near * count)
                  for name, o, r, count in zip(
                      ("dw1", "db1", "dw2"), got[1:4], ref[1:4], (hh, 1, 0)))
        return e9, edx, edw

    h, f = 768, 3072
    for dtype in (bf16, f32):
        ops = ffn_operands(4096, h, f, dtype)
        for act in ("gelu", "gelu_new", "relu", "silu"):
            ffn_case(*ops, act)
        # a row count that fills neither a row tile nor a split
        ffn_case(ops[0][:4001].contiguous(), ops[1][:4001].contiguous(),
                 *ops[2:])
    # bart-large's width and h 256 in both dtypes; in bfloat16 h 512 and
    # 1536 too: K8 takes every h that is a multiple of 128 (t5-small's FFN
    # at its own rows: check_t5_kernels)
    for hh, ff, act, dtypes in ((1024, 4096, "gelu", (bf16, f32)),
                                (256, 1024, "gelu", (bf16, f32)),
                                (512, 2048, "relu", (bf16,)),
                                (1536, 6144, "gelu", (bf16,))):
        for dtype in dtypes:
            ffn_case(*ffn_operands(1000, hh, ff, dtype), act)
    # the row counts the train step gives K2, K3, K8 and K9: speech encoder,
    # text encoder and decoder (B = 16 x 16 s, 64 label positions) in bf16,
    # and those of the f32 gradient-tree check (B = 8 x 8 s, 128 label
    # positions).  The count picks the row plan of K8's weight gradients:
    # bf16 12800 rows are 4 ranges of 3200, 6400 rows 2, 1024 rows one range
    # written without the workspace; f32 3200 rows 4 of 832 (the last one
    # short), 1600 rows 2 of 832, 1024 rows one.
    dense_cases = {}
    for dtype, row_counts in ((bf16, (12800, 6400, 1024)),
                              (f32, (3200, 1600, 1024))):
        for n in row_counts:
            ops = ffn_operands(n, h, f, dtype)
            errs = ffn_case(*ops)
            x, _, w1, b1, w2, b2 = ops
            res, w = randn(n, h, dtype=dtype), randn(h, h, scale=0.03,
                                                     dtype=dtype)
            if dtype == bf16:
                check_products_alone(randn, *ops[:3])
                check_down_alone(randn, w2, b2, res)
            gamma, beta = randn(h, scale=0.1) + 1.0, randn(h, scale=0.1)
            k3 = (x, w1, b1, w2, b2, res, gamma, beta)
            e3 = compare(f"K3 N={n} H={h} F={f} gelu {dtype}",
                         kf.ffn_res_ln(*k3), kf.ffn_res_ln_plain(*k3))
            if dtype == bf16:
                expect_equal(f"K3 N={n} H={h} F={f} gelu",
                             (kf.ffn_res_ln(*k3),), (kf.ffn_res_ln(*k3),))
            k2 = (x, w, b2, res, gamma, beta)
            out2 = kf.dense_res_ln(*k2)
            e2 = compare(f"K2 N={n} Din=H={h} {dtype}", out2,
                         kf.dense_res_ln_plain(*k2))
            if dtype == bf16:
                compare(f"K2 N={n} Din=H={h} vs tiled", out2,
                        kf.dense_res_ln_tiled_plain(*k2))
                expect_equal(f"K2 N={n} Din=H={h}", (out2,),
                             (kf.dense_res_ln(*k2),))
                dense_cases[n] = (k2, e2)
            if dtype == bf16 and n == 12800:
                timed_ffn = (ops, errs, (res, gamma, beta), e3)
    # timing at the speech encoder's row count, which 12 of the step's 24
    # layers have
    (x, g, w1, b1, w2, b2), (e9, edx, edw), (res, gamma, beta), e3 = \
        timed_ffn
    n = x.shape[0]
    lx = x.detach().requires_grad_()
    lw1, lw2 = (w_.t().contiguous().requires_grad_() for w_ in (w1, w2))
    lb1, lb2 = (b.to(x.dtype).requires_grad_() for b in (b1, b2))
    lib = lambda: F.linear(F.gelu(F.linear(lx, lw1, lb1)), lw2, lb2)
    lib_y = lib()
    shape = f"N={n} H={h} F={f} gelu bf16"
    records["ffn_fused"] = dict(
        shape=shape, max_abs_err=e9,
        ms=cuda_ms(lambda: kf.ffn_fused(x, w1, b1, w2, b2)),
        plain_ms=cuda_ms(lambda: kf.ffn_fused_plain(x, w1, b1, w2, b2)),
        library_ms=cuda_ms(lambda: lib().detach()),
        flops=4.0 * n * h * f,
        bytes=(2 * n * h + 2 * h * f) * 2 + (f + h) * 4)
    hid, da, colsum = kf.ffn_bwd_recompute(x, g, w1, b1, w2)
    rh, rd, rc = kf.ffn_bwd_recompute_plain(x, g, w1, b1, w2)
    torch.cuda.synchronize()
    erc = max(compare(f"K8 recompute {name_} {shape}", o, r, lim, rule)
              for name_, o, r, lim, rule in (
                  ("h", hid, rh, None, None), ("da", da, rd, None, None),
                  ("colsum", colsum, rc,
                   K8_DW_BF16_TOL[0] + K8_DW_BF16_TOL[1] * rc.abs(),
                   f"atol {K8_DW_BF16_TOL[0]}, rtol {K8_DW_BF16_TOL[1]}")))
    del rh, rd, rc
    records["ffn_bwd_recompute"] = dict(
        shape=shape + " (h, da, tile sums of da)", max_abs_err=erc,
        ms=cuda_ms(lambda: kf.ffn_bwd_recompute(x, g, w1, b1, w2)),
        plain_ms=cuda_ms(lambda: kf.ffn_bwd_recompute_plain(x, g, w1, b1,
                                                            w2)),
        library_ms=None, flops=4.0 * n * h * f,
        bytes=(2 * n * h + 2 * h * f + 2 * n * f) * 2 + f * 4 +
        -(-n // kf.ROW_TILE) * f * 4)
    records["ffn_bwd_products"] = dict(
        shape=shape + " (dx, dw1, dw2, db1 from h, da)",
        max_abs_err=max(edx, edw),
        ms=cuda_ms(lambda: kf.ffn_bwd_products(x, g, w1, hid, da, colsum)),
        plain_ms=cuda_ms(lambda: kf.ffn_bwd_products_plain(x, g, w1, hid, da,
                                                           colsum)),
        library_ms=None, flops=6.0 * n * h * f,
        bytes=(3 * n * h + h * f + 2 * n * f) * 2 +
        (-(-n // kf.ROW_TILE) * f + 2 * h * f + f) * 4)
    records["ffn_bwd"] = dict(
        shape=shape + " (recompute + products)", max_abs_err=max(edx, edw),
        ms=cuda_ms(lambda: kf.ffn_bwd_products(
            x, g, w1, *kf.ffn_bwd_recompute(x, g, w1, b1, w2))),
        plain_ms=cuda_ms(lambda: kf.ffn_bwd_plain(x, g, w1, b1, w2)),
        library_ms=cuda_ms(lambda: torch.autograd.grad(
            lib_y, (lx, lw1, lb1, lw2), g, retain_graph=True)),
        flops=10.0 * n * h * f,
        bytes=(3 * n * h + 2 * h * f) * 2 + f * 4 + (2 * h * f + f) * 4)
    del hid, da, colsum
    # K3 at the same row count, beside its N = 4096 record
    w1t, w2t = w1.t(), w2.t()
    b1c, b2c, gc, betac = (t_.to(x.dtype) for t_ in (b1, b2, gamma, beta))
    records[f"ffn_res_ln (N={n})"] = dict(
        shape=f"N={n} H={h} F={f} gelu bf16 (K3)", max_abs_err=e3,
        ms=cuda_ms(lambda: kf.ffn_res_ln(x, w1, b1, w2, b2, res, gamma,
                                         beta)),
        plain_ms=cuda_ms(lambda: kf.ffn_res_ln_plain(x, w1, b1, w2, b2, res,
                                                     gamma, beta)),
        library_ms=cuda_ms(lambda: F.layer_norm(
            res + F.linear(F.gelu(F.linear(x, w1t, b1c)), w2t, b2c), (h,),
            gc, betac, 1e-5)),
        flops=4.0 * n * h * f,
        bytes=(3 * n * h + 2 * h * f) * 2 + (f + 3 * h) * 4)
    # the bf16 forward's passes at the same rows (K9 = up + down, K3 = up +
    # down to z + rows), each against its plain version, with the bounds of
    # the structure: h (N, F) and z (N, H) f32 written once and read once
    hid = kf.ffn_up(x, w1, b1)
    z = kf.ffn_down(hid, w2, b2, res)
    torch.cuda.synchronize()
    e_up = compare(f"up pass {shape}", hid, kf.ffn_up_plain(x, w1, b1))
    z_ref = kf.ffn_down_plain(hid, w2, b2, res)
    e_down = compare(f"down pass to z {shape}", z, z_ref,
                     2.0 ** -12 * (hid.float().abs() @ w2.float().abs())
                     + 2.0 ** -20 * z_ref.abs() + 1e-6,
                     DOWN_RULE + " + 2^-20 |z|")
    del z_ref
    e_rows = compare(f"LayerNorm rows {shape}", kf.res_ln_rows(z, gamma, beta),
                     kf.res_ln_rows_plain(z, gamma, beta))
    e_out = compare(f"down pass {shape}", kf.ffn_down(hid, w2, b2),
                    kf.ffn_down_plain(hid, w2, b2))
    nhf = 2.0 * n * h * f
    records["ffn_up"] = dict(
        shape=shape + " (up pass: h = round(gelu(x w1 + b1)))",
        max_abs_err=e_up, ms=cuda_ms(lambda: kf.ffn_up(x, w1, b1)),
        plain_ms=cuda_ms(lambda: kf.ffn_up_plain(x, w1, b1)),
        library_ms=cuda_ms(lambda: F.gelu(F.linear(x, w1t, b1c))),
        flops=nhf, bytes=(n * h + h * f + n * f) * 2 + f * 4)
    records["ffn_down"] = dict(
        shape=shape + " (down pass: round(h w2 + b2), K9's)",
        max_abs_err=e_out, ms=cuda_ms(lambda: kf.ffn_down(hid, w2, b2)),
        plain_ms=cuda_ms(lambda: kf.ffn_down_plain(hid, w2, b2)),
        library_ms=cuda_ms(lambda: F.linear(hid, w2t, b2c)),
        flops=nhf, bytes=(n * f + f * h + n * h) * 2 + h * 4)
    records["ffn_down_res"] = dict(
        shape=shape + " (down pass to z = h w2 + b2 + res in f32, K3's)",
        max_abs_err=e_down,
        ms=cuda_ms(lambda: kf.ffn_down(hid, w2, b2, res)),
        plain_ms=cuda_ms(lambda: kf.ffn_down_plain(hid, w2, b2, res)),
        library_ms=None, flops=nhf,
        bytes=(n * f + f * h + n * h) * 2 + n * h * 4 + h * 4)
    records["res_ln_rows"] = dict(
        shape=f"z ({n}, {h}) f32 -> LayerNorm rows, bf16 (K3's)",
        max_abs_err=e_rows, ms=cuda_ms(lambda: kf.res_ln_rows(z, gamma, beta)),
        plain_ms=cuda_ms(lambda: kf.res_ln_rows_plain(z, gamma, beta)),
        library_ms=cuda_ms(lambda: F.layer_norm(z, (h,), gamma, beta, 1e-5)),
        flops=0.0, bytes=n * h * 4 + n * h * 2 + 2 * h * 4)
    del hid, z
    # K2 at the step's three row counts, with the launches at each
    for n, (k2, e2) in dense_cases.items():
        records[f"dense_res_ln (N={n})"] = dense_record(
            F, kf.dense_res_ln, kf.dense_res_ln_plain, k2, e2, n, h,
            "K2", lambda t_: t_)


def dense_record(F, kernel, plain, k2, err, n, h, what, drop, *extra):
    """The record of K2 (K11 with `extra` = key, rate and the plain
    version's mask) at n rows: kernel, plain version and the library's
    layer_norm(res + drop(linear)), with the row count whose launches the
    step tallies."""
    x, w, b, res, g, beta = k2
    wt, bc, gc, betac = w.t(), b.to(x.dtype), g.to(x.dtype), beta.to(x.dtype)
    key_rate, plain_extra = extra[:2], extra[2:]
    return dict(
        shape=f"N={n} Din=H={h} bf16 ({what})", max_abs_err=err,
        ms=cuda_ms(lambda: kernel(*k2, *key_rate)),
        plain_ms=cuda_ms(lambda: plain(*k2, *plain_extra)),
        library_ms=cuda_ms(lambda: F.layer_norm(
            res + drop(F.linear(x, wt, bc)), (h,), gc, betac, 1e-5)),
        flops=2.0 * n * h * h,
        bytes=(2 * n * h + h * h + n * h) * 2 + 3 * h * 4, rows=n)


def check_trainable_functions(randn, dev):
    """The differentiable forms as a post-LN layer of the train step calls
    them: bf16 activations, float32 master weights, the step's three row
    counts.  Output and every gradient of K3's function (K3 forward; K9, the
    LayerNorm backward and K8 backward) and of K9's (K9 forward, K8 backward)
    through the kernels against the same functions over the plain versions.
    Kernel and plain version differ in single roundings to bf16, so the
    limits of the kernels' own checks hold for the chain."""
    import torch
    from speechmix_tpu_torch.ops import kernels
    from speechmix_tpu_torch.ops.kernels import ffn as kf

    from speechmix_tpu_torch.ops.kernels.dropout import DropoutKey

    h, f, bf16 = 768, 3072, torch.bfloat16
    log("ffn_res_ln_trainable, ffn_fused_trainable and their dropout twins "
        "(and dense_res_ln_trainable, dense_dropout_res_ln_trainable: their "
        "backward products bf16 operands, f32 results on the card; the "
        "plain side upcast products), bf16 activations, f32 weights: "
        "kernels vs plain versions")
    names = ("x", "w1", "b1", "w2", "b2", "res", "gamma", "beta")
    dense_names = ("x", "w", "b", "res", "gamma", "beta")
    key, rate = DropoutKey.from_seed(5), DROP_RATE
    sum_rule = f"atol {K8_DW_BF16_TOL[0]}, rtol {K8_DW_BF16_TOL[1]}"
    drop_sum_tol = _dropout_tol(K8_DW_BF16_TOL, rate)
    drop_tol = _dropout_tol(TOL["bfloat16"], rate)

    def run(fn, operands, grad):
        leaves = [t.detach().requires_grad_() for t in operands]
        out = fn(*leaves)
        return (out, *torch.autograd.grad(out, leaves, grad))

    for n in (12800, 6400, 1024):
        x, res, grad = (randn(n, h, dtype=bf16) for _ in range(3))
        operands = (x, randn(h, f, scale=0.03), randn(f, scale=0.1),
                    randn(f, h, scale=0.03), randn(h, scale=0.1), res,
                    randn(h, scale=0.1) + 1.0, randn(h, scale=0.1))
        dense_ops = (x, randn(h, h, scale=0.03), randn(h, scale=0.1), res,
                     operands[6], operands[7])
        cases = (("ffn_res_ln_trainable", kf.ffn_res_ln_trainable, operands,
                  names, False),
                 ("ffn_fused_trainable", kf.ffn_fused_trainable,
                  operands[:5], names, False),
                 ("ffn_dropout_res_ln_trainable",
                  lambda *a: kf.ffn_dropout_res_ln_trainable(
                      *a, key, rate, rate), operands, names, True),
                 ("ffn_dropout_trainable",
                  lambda *a: kf.ffn_dropout_trainable(*a, key, rate),
                  operands[:5], names, True),
                 ("dense_res_ln_trainable", kf.dense_res_ln_trainable,
                  dense_ops, dense_names, False),
                 ("dense_dropout_res_ln_trainable",
                  lambda *a: kf.dense_dropout_res_ln_trainable(*a, key, rate),
                  dense_ops, dense_names, True))
        kernels.reset_launch_counts()
        got = [run(fn, ops, grad) for _, fn, ops, _, _ in cases]
        counts = {k.symbol: k.launches for k in kernels.kernels()
                  if k.launches}
        # K3 forward: the up pass, the down pass to z, the rows; its
        # backward K9 (up, down) and K8; K9: the same up and down, K8.
        # K12's backward: K13 (the dropout up pass, the down pass), K10
        # (output mask), K8's dropout recompute and its products; K11's: K10;
        # K2's and K11's backward products: no kernel of the port
        want = {"smx_ffn_up": 3, "smx_ffn_down": 4, "smx_ffn_down_res": 1,
                "smx_res_ln_rows": 2,
                "smx_ffn_bwd_recompute": 2, "smx_ffn_bwd_products": 4,
                "smx_ffn_dropout_up": 3, "smx_ffn_dropout_down_res": 1,
                "smx_ffn_dropout_bwd_recompute": 2, "smx_dense_res_ln": 1,
                "smx_dense_dropout_res_ln": 1, "smx_dropout_mask": 2}
        if counts != want:
            raise AssertionError(f"trainable functions, N={n}: launches "
                                 f"{counts}, expected {want}")
        with plain_kernels():
            ref = [run(fn, ops, grad) for _, fn, ops, _, _ in cases]
        for (what, _, ops, op_names, dropped), outs, refs in zip(cases, got,
                                                                 ref):
            tol = drop_tol if dropped else TOL["bfloat16"]
            rule = f"atol {tol[0]:.4g}, rtol {tol[1]:.4g}" + (
                " (TOL / (1-r))" if dropped else "")
            stol = drop_sum_tol if dropped else K8_DW_BF16_TOL
            srule = f"atol {stol[0]:.4g}, rtol {stol[1]:.4g}" + (
                " (K8's / (1-r))" if dropped else "")
            compare(f"{what} N={n} out", outs[0], refs[0],
                    tol[0] + tol[1] * refs[0].float().abs(), rule)
            for name, t, o, r in zip(op_names, ops, outs[1:], refs[1:]):
                if o.dtype != t.dtype:
                    raise AssertionError(f"{what}: d {name} is {o.dtype}")
                if t.dtype == bf16:
                    compare(f"{what} N={n} d {name}", o, r,
                            tol[0] + tol[1] * r.float().abs(), rule)
                else:  # float32 sums over the rows, as K8's dw
                    compare(f"{what} N={n} d {name}", o, r,
                            stol[0] + stol[1] * r.abs(), srule)
            if op_names is dense_names:
                continue
            for name, o in zip(names[1:5:2], outs[2:6:2]):
                # a weight gradient rounded to bf16 on its way would have no
                # bits below bf16's
                if torch.equal(o, o.bfloat16().float()):
                    raise AssertionError(f"{what}: d {name} was rounded to "
                                         "bfloat16")


DROP_RATE = 0.1   # the flagship's rate at every dropout site
K14_BF16_RULE = "2^-8 * ((P m)|v|) + 2^-7 * |p|, m in {0, 1/(1-r)}"


def _dropout_tol(tol, rate):
    """A kernel's (atol, rtol) with both terms times 1/(1-r): the dropout
    scale multiplies the kept values, and with them their rounding errors,
    before the residual, the LayerNorm or the next product."""
    return tol[0] / (1.0 - rate), tol[1] / (1.0 - rate)


def check_dropout_kernels(randn, dev, records):
    """K10 bit-exact against the plain generator at the step's mask shapes;
    K11, K12, K13 and K8 with the mask at the step's row counts and K14,
    K15 at its attention shapes, in bf16 and f32, against their plain
    versions fed the plain generator's masks of the same key."""
    import torch
    import torch.nn.functional as F
    from speechmix_tpu_torch.ops.kernels import attention as ka
    from speechmix_tpu_torch.ops.kernels import dropout as kd
    from speechmix_tpu_torch.ops.kernels import ffn as kf

    rate, bf16, f32 = DROP_RATE, torch.bfloat16, torch.float32
    key = kd.DropoutKey.from_seed(20261016)
    log(f"K10 dropout_mask, rate {rate}")
    for what, stream, n, cols in (
            ("FFN activation mask", kd.STREAM_ACT, 12800, 3072),
            ("output mask", kd.STREAM_OUT, 12800, 768),
            ("attention mask (16, 12, 800, 800)", kd.STREAM_ACT,
             16 * 12 * 800, 800),
            ("ragged columns", kd.STREAM_OUT, 1000, 799)):
        out = kd.dropout_mask(key, stream, n, cols, rate, dev)
        ref = kd.dropout_mask_plain(key, stream, n, cols, rate, dev)
        torch.cuda.synchronize()
        exact = torch.equal(out, ref)
        log(f"  {what} ({n}, {cols}): {'bit-exact' if exact else 'DIFFERS'}"
            f", keep rate {(out > 0).float().mean().item():.6f} (1 - r = "
            f"{1 - rate})")
        if not exact:
            raise AssertionError(f"dropout_mask differs from the plain "
                                 f"generator: {what}")
        del out, ref
    n, cols = 12800, 3072
    buf = torch.empty(n, cols, device=dev)
    records["dropout_mask"] = dict(
        shape=f"({n}, {cols}) float32, rate {rate}", max_abs_err=0.0,
        ms=cuda_ms(lambda: kd.dropout_mask(key, 0, n, cols, rate, dev)),
        plain_ms=cuda_ms(lambda: kd.dropout_mask_plain(key, 0, n, cols, rate,
                                                       dev), iters=5),
        library_ms=cuda_ms(lambda: buf.bernoulli_(1.0 - rate).mul_(
            1.0 / (1.0 - rate))),
        flops=0.0, bytes=4.0 * n * cols)
    del buf

    log("K11 dense_dropout_res_ln, K12 ffn_dropout_res_ln, K13 ffn_dropout, "
        "K8 with the activation mask")
    h, f = 768, 3072
    timed = None
    dense_cases = {}
    for dtype in (bf16, f32):
        name = str(dtype).replace("torch.", "")
        atol, rtol = _dropout_tol(TOL[name], rate)
        dw_tol = _dropout_tol(K8_DW_BF16_TOL if dtype == bf16
                              else K8_DW_F32_TOL, rate)
        rule = (f"atol {TOL[name][0]} / (1-r), rtol {TOL[name][1]} / (1-r), "
                f"r = {rate}")
        dw_rule = (f"atol {dw_tol[0]:.4g}, rtol {dw_tol[1]:.4g} (K8's / "
                   f"(1-r))")
        lim = lambda r: atol + rtol * r.float().abs()
        for n in (12800, 6400, 1024):
            x, g, res = (randn(n, h, dtype=dtype) for _ in range(3))
            w = randn(h, h, scale=0.03, dtype=dtype)
            w1 = randn(h, f, scale=0.03, dtype=dtype)
            w2 = randn(f, h, scale=0.03, dtype=dtype)
            b1, b2, beta = randn(f, scale=0.1), randn(h, scale=0.1), \
                randn(h, scale=0.1)
            gamma = randn(h, scale=0.1) + 1.0
            amask = kd.dropout_mask_plain(key, kd.STREAM_ACT, n, f, rate, dev)
            omask = kd.dropout_mask_plain(key, kd.STREAM_OUT, n, h, rate, dev)
            what = f"N={n} H={h} F={f} {name}"
            k11 = (x, w, b2, res, gamma, beta)
            out11 = kf.dense_dropout_res_ln(*k11, key, rate)
            ref = kf.dense_dropout_res_ln_plain(*k11, omask)
            e11 = compare(f"K11 {what}", out11, ref, lim(ref), rule)
            if dtype == bf16:
                ref = kf.dense_res_ln_tiled_plain(*k11, omask)
                compare(f"K11 {what} vs tiled", out11, ref, lim(ref), rule)
                expect_equal(f"K11 {what}", (out11,),
                             (kf.dense_dropout_res_ln(*k11, key, rate),))
                dense_cases[n] = (k11, e11)
            ref = kf.ffn_dropout_res_ln_plain(x, w1, b1, w2, b2, res, gamma,
                                              beta, amask, omask)
            e12 = compare(f"K12 {what}", kf.ffn_dropout_res_ln(
                x, w1, b1, w2, b2, res, gamma, beta, key, rate, rate), ref,
                lim(ref), rule)
            ref = kf.ffn_dropout_plain(x, w1, b1, w2, b2, amask)
            e13 = compare(f"K13 {what}", kf.ffn_dropout(
                x, w1, b1, w2, b2, key, rate), ref, lim(ref), rule)
            if dtype == bf16:
                k12 = (x, w1, b1, w2, b2, res, gamma, beta, key, rate, rate)
                expect_equal(f"K12 {what}", (kf.ffn_dropout_res_ln(*k12),),
                             (kf.ffn_dropout_res_ln(*k12),))
                k13 = (x, w1, b1, w2, b2, key, rate)
                expect_equal(f"K13 {what}", (kf.ffn_dropout(*k13),),
                             (kf.ffn_dropout(*k13),))
            got = kf.ffn_dropout_bwd(x, g, w1, b1, w2, key, rate)
            refs = kf.ffn_bwd_plain(x, g, w1, b1, w2, "gelu", amask)
            torch.cuda.synchronize()
            erc = 0.0
            if dtype == bf16:
                expect_equal(f"K8 dropout {what}", got,
                             kf.ffn_dropout_bwd(x, g, w1, b1, w2, key, rate))
                rc = kf.ffn_bwd_recompute(x, g, w1, b1, w2, "gelu", key, rate)
                rcp = kf.ffn_bwd_recompute_plain(x, g, w1, b1, w2, "gelu",
                                                 amask)
                erc = max(compare(f"K8 dropout recompute {p_} {what}", o, r,
                                  lm, rl)
                          for p_, o, r, lm, rl in (
                              ("h", rc[0], rcp[0], lim(rcp[0]), rule),
                              ("da", rc[1], rcp[1], lim(rcp[1]), rule),
                              ("colsum", rc[2], rcp[2],
                               dw_tol[0] + dw_tol[1] * rcp[2].abs(),
                               dw_rule)))
                del rc, rcp
            edx = compare(f"K8 dropout dx {what}", got[0], refs[0],
                          lim(refs[0]), rule)
            edw = max(compare(f"K8 dropout {p_} {what}", o, r,
                              dw_tol[0] + dw_tol[1] * r.abs(), dw_rule)
                      for p_, o, r in zip(("dw1", "db1", "dw2"), got[1:4],
                                          refs[1:4]))
            if n == 1024:   # one mask of K12 at rate 0: no bits drawn
                for ar, orate in ((rate, 0.0), (0.0, rate)):
                    ref = kf.ffn_dropout_res_ln_plain(
                        x, w1, b1, w2, b2, res, gamma, beta,
                        amask if ar else None, omask if orate else None)
                    compare(f"K12 rates ({ar}, {orate}) {what}",
                            kf.ffn_dropout_res_ln(x, w1, b1, w2, b2, res,
                                                  gamma, beta, key, ar,
                                                  orate), ref, lim(ref), rule)
            if dtype == bf16 and n == 12800:
                timed = (x, g, res, w, w1, b1, w2, b2, gamma, beta,
                         (e11, e12, e13, edx, edw, erc))
            del amask, omask, got, refs
    x, g, res, w, w1, b1, w2, b2, gamma, beta, errs = timed
    n = x.shape[0]
    w1t, w2t = w1.t(), w2.t()
    b1c, b2c, gc, betac = (t_.to(x.dtype) for t_ in (b1, b2, gamma, beta))
    drop = lambda t_: F.dropout(t_, rate)
    lib_ffn = lambda: F.linear(drop(F.gelu(F.linear(x, w1t, b1c))), w2t, b2c)
    lx = x.detach().requires_grad_()
    lw1, lw2 = (w_.t().contiguous().requires_grad_() for w_ in (w1, w2))
    lb1, lb2 = (b.to(x.dtype).requires_grad_() for b in (b1, b2))
    lib_y = F.linear(drop(F.gelu(F.linear(lx, lw1, lb1))), lw2, lb2)
    shape = f"N={n} H={h} F={f} gelu bf16, rate {rate}"
    ffn_flops = 4.0 * n * h * f
    # K11 at the step's three row counts (N = 12800 under its old name)
    for n_, (k11, e11) in dense_cases.items():
        omask = kd.dropout_mask_plain(key, kd.STREAM_OUT, n_, h, rate, dev)
        name = ("dense_dropout_res_ln" if n_ == 12800
                else f"dense_dropout_res_ln (N={n_})")
        records[name] = dense_record(
            F, kf.dense_dropout_res_ln, kf.dense_dropout_res_ln_plain, k11,
            e11, n_, h, f"K11, rate {rate}", drop, key, rate, omask)
    del dense_cases, omask
    records["ffn_dropout_res_ln"] = dict(
        shape=shape, max_abs_err=errs[1],
        ms=cuda_ms(lambda: kf.ffn_dropout_res_ln(
            x, w1, b1, w2, b2, res, gamma, beta, key, rate, rate)),
        plain_ms=cuda_ms(lambda: kf.ffn_dropout_res_ln_plain(
            x, w1, b1, w2, b2, res, gamma, beta,
            kd.dropout_mask_plain(key, kd.STREAM_ACT, n, f, rate, dev),
            kd.dropout_mask_plain(key, kd.STREAM_OUT, n, h, rate, dev)),
            iters=5),
        library_ms=cuda_ms(lambda: F.layer_norm(
            res + drop(lib_ffn()), (h,), gc, betac, 1e-5)),
        flops=ffn_flops,
        bytes=(3 * n * h + 2 * h * f) * 2 + (f + 3 * h) * 4)
    records["ffn_dropout"] = dict(
        shape=shape, max_abs_err=errs[2],
        ms=cuda_ms(lambda: kf.ffn_dropout(x, w1, b1, w2, b2, key, rate)),
        plain_ms=cuda_ms(lambda: kf.ffn_dropout_plain(
            x, w1, b1, w2, b2, kd.dropout_mask_plain(
                key, kd.STREAM_ACT, n, f, rate, dev)), iters=5),
        library_ms=cuda_ms(lib_ffn), flops=ffn_flops,
        bytes=(2 * n * h + 2 * h * f) * 2 + (f + h) * 4)
    # the passes K12 and K13 add to K3's and K9's: the up pass with the
    # activation mask, the down pass to z with the output mask
    hid = kf.ffn_up(x, w1, b1, "gelu", key, rate)
    amask = kd.dropout_mask_plain(key, kd.STREAM_ACT, n, f, rate, dev)
    omask = kd.dropout_mask_plain(key, kd.STREAM_OUT, n, h, rate, dev)
    torch.cuda.synchronize()
    ref = kf.ffn_up_plain(x, w1, b1, "gelu", amask)
    e_up = compare(f"dropout up pass {shape}", hid, ref,
                   _dropout_tol(TOL["bfloat16"], rate)[0] +
                   _dropout_tol(TOL["bfloat16"], rate)[1] * ref.float().abs(),
                   "TOL / (1-r)")
    z = kf.ffn_down(hid, w2, b2, res, key, rate)
    torch.cuda.synchronize()
    ref = kf.ffn_down_plain(hid, w2, b2, res, omask)
    e_down = compare(f"dropout down pass to z {shape}", z, ref,
                     (2.0 ** -12 * (hid.float().abs() @ w2.float().abs())
                      + 1e-6) / (1.0 - rate) + 2.0 ** -20 * ref.abs(),
                     "(" + DOWN_RULE + ") / (1-r) + 2^-20 |z|")
    del amask, omask, ref, z
    records["ffn_dropout_up"] = dict(
        shape=shape + " (up pass with the activation mask)",
        max_abs_err=e_up,
        ms=cuda_ms(lambda: kf.ffn_up(x, w1, b1, "gelu", key, rate)),
        plain_ms=cuda_ms(lambda: kf.ffn_up_plain(
            x, w1, b1, "gelu", kd.dropout_mask_plain(
                key, kd.STREAM_ACT, n, f, rate, dev)), iters=5),
        library_ms=cuda_ms(lambda: drop(F.gelu(F.linear(x, w1t, b1c)))),
        flops=2.0 * n * h * f, bytes=(n * h + h * f + n * f) * 2 + f * 4)
    records["ffn_dropout_down_res"] = dict(
        shape=shape + " (down pass to z with the output mask)",
        max_abs_err=e_down,
        ms=cuda_ms(lambda: kf.ffn_down(hid, w2, b2, res, key, rate)),
        plain_ms=cuda_ms(lambda: kf.ffn_down_plain(
            hid, w2, b2, res, kd.dropout_mask_plain(
                key, kd.STREAM_OUT, n, h, rate, dev)), iters=5),
        library_ms=None, flops=2.0 * n * h * f,
        bytes=(n * f + f * h + n * h) * 2 + n * h * 4 + h * 4)
    del hid
    k8 = lambda: kf.ffn_bwd_products(x, g, w1, *kf.ffn_bwd_recompute(
        x, g, w1, b1, w2, "gelu", key, rate))
    amask_plain = lambda: kd.dropout_mask_plain(key, kd.STREAM_ACT, n, f, rate,
                                                dev)
    records["ffn_dropout_bwd_recompute"] = dict(
        shape=shape + " (h, da, tile sums of da)", max_abs_err=errs[5],
        ms=cuda_ms(lambda: kf.ffn_bwd_recompute(x, g, w1, b1, w2, "gelu", key,
                                                rate)),
        plain_ms=cuda_ms(lambda: kf.ffn_bwd_recompute_plain(
            x, g, w1, b1, w2, "gelu", amask_plain()), iters=5),
        library_ms=None, flops=4.0 * n * h * f,
        bytes=(2 * n * h + 2 * h * f + 2 * n * f) * 2 + f * 4 +
        -(-n // kf.ROW_TILE) * f * 4)
    records["ffn_dropout_bwd"] = dict(
        shape=shape + " (recompute + products)", max_abs_err=max(errs[3:5]),
        ms=cuda_ms(k8),
        plain_ms=cuda_ms(lambda: kf.ffn_bwd_plain(x, g, w1, b1, w2, "gelu",
                                                  amask_plain()), iters=5),
        library_ms=cuda_ms(lambda: torch.autograd.grad(
            lib_y, (lx, lw1, lb1, lw2), g, retain_graph=True)),
        flops=10.0 * n * h * f,
        bytes=(3 * n * h + 2 * h * f) * 2 + f * 4 + (2 * h * f + f) * 4)
    del timed, lib_y

    log("K14 attention_dropout_fwd and K15 attention_dropout_bwd")
    heads, d, scale = 12, 64, 0.125

    def attention_case(b, t, causal, dtype, lens=None, name=""):
        if lens is None:
            lens = [t, t - 37, t // 2 + 3, t - min(200, t // 3)][:b]
        lens = torch.tensor(lens, device=dev)
        mask = torch.arange(t, device=dev)[None, :] < lens[:, None]
        q, k, v, g = (randn(b, t, heads * d, dtype=dtype) for _ in range(4))
        dmask = kd.attention_mask_plain(key, b, heads, t, t, rate, dev)
        out, lse = ka.attention_dropout_fwd(q, k, v, mask, heads, scale,
                                            causal, key, rate,
                                            return_lse=True)
        ref_out, ref_lse = ka.attention_fwd_plain(
            q, k, v, mask, heads, scale, causal, return_lse=True, dmask=dmask)
        got = ka.attention_dropout_bwd(q, k, v, mask, out, lse, g, heads,
                                       scale, causal, key, rate)
        refs = ka.attention_bwd_plain(q, k, v, mask, g, heads, scale, causal,
                                      dmask=dmask)
        tiled = ka.attention_bwd_tiled_plain(q, k, v, mask, out, lse, g,
                                             heads, scale, causal, dmask)
        torch.cuda.synchronize()
        what = f"{name}B={b} T={t} {dtype} causal={causal}"
        compare(f"K14 lse {what}", lse, ref_lse,
                1e-4 + 1e-4 * ref_lse.abs(), "atol 1e-4, rtol 1e-4")
        e15 = 0.0
        for against, ref3 in (("", refs), (" vs tiled", tiled)):
            if dtype == bf16:
                limit = attention_bf16_limit(q, k, v, mask, heads, scale,
                                             causal, ref_out, dmask)
                limits = attention_bwd_bf16_limits(q, k, v, mask, ref_out, g,
                                                   heads, scale, causal, ref3,
                                                   dmask)
                rule = K14_BF16_RULE
                rule15 = K7_BF16_RULE + ", p^T as (p m)^T"
            else:   # f32: the order of summation, of values scaled by 1/(1-r)
                atol, rtol = _dropout_tol(TOL["float32"], rate)
                limit = atol + rtol * ref_out.abs()
                limits = [atol + rtol * r.abs() for r in ref3]
                rule = rule15 = (f"atol {atol:.4g}, rtol {rtol:.4g} "
                                 "(TOL / (1-r))")
            e15 = max([e15] + [
                compare(f"K15 {n_} {what}{against}", o, r, lim, rule15)
                for n_, o, r, lim in zip(("dq", "dk", "dv"), got, ref3,
                                         limits)])
        e14 = compare(f"K14 out {what}", out, ref_out, limit, rule)
        if dtype == bf16:
            # the bf16 body's tiles, and the same bits in a second call
            tiled = ka.attention_fwd_tiled_plain(q, k, v, mask, heads, scale,
                                                 causal, dmask=dmask)
            compare(f"K14 out {what} vs tiled", out, tiled,
                    attention_bf16_limit(q, k, v, mask, heads, scale, causal,
                                         tiled, dmask), rule)
            expect_equal(f"K14 {what}", (out, lse), ka.attention_dropout_fwd(
                q, k, v, mask, heads, scale, causal, key, rate,
                return_lse=True))
        return e14, e15, (q, k, v, mask, out, lse, g, causal, lens)

    for dtype in (bf16, f32):
        for b, t, causal in ((4, 800, False), (4, 400, False), (4, 64, True)):
            attention_case(b, t, causal, dtype)
        attention_case(3, 100, True, dtype, [0, 100, 41], "masked row ")
    for name, b, t, causal in (("speech encoder", 16, 800, False),
                               ("text encoder", 16, 400, False),
                               ("decoder, causal", 16, 64, True)):
        e14, e15, (q, k, v, mask, out, lse, g, causal, lens) = \
            attention_case(b, t, causal, bf16, [t] * b, "timed ")
        k15 = lambda: ka.attention_dropout_bwd(q, k, v, mask, out, lse, g,
                                               heads, scale, causal, key, rate)
        expect_equal(f"K15 {name} B={b} T={t}", k15(), k15())
        qh, kh, vh = (x_.view(b, t, heads, d).transpose(1, 2).detach()
                      .requires_grad_() for x_ in (q, k, v))
        allowed = mask[:, None, :].expand(b, t, t)
        if causal:
            allowed = allowed & torch.ones(t, t, dtype=torch.bool,
                                           device=dev).tril()
        sdpa = lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=allowed[:, None], dropout_p=rate,
            scale=scale)
        lib_out = sdpa()
        gh = g.view(b, t, heads, d).transpose(1, 2)
        suffix = "" if name == "speech encoder" else f" ({name})"
        shape = f"B={b} T={t} H={heads} D={d} bf16 causal={causal}, rate {rate}"
        records["attention_dropout_fwd" + suffix] = dict(
            shape=shape, length=t, max_abs_err=e14,
            ms=cuda_ms(lambda: ka.attention_dropout_fwd(
                q, k, v, mask, heads, scale, causal, key, rate)),
            plain_ms=cuda_ms(lambda: ka.attention_fwd_plain(
                q, k, v, mask, heads, scale, causal,
                dmask=kd.attention_mask_plain(key, b, heads, t, t, rate,
                                              dev)), iters=5),
            library_ms=cuda_ms(lambda: sdpa().detach()),
            flops=4.0 * heads * d * int(allowed.sum()),
            bytes=4 * b * t * heads * d * 2 + b * t)
        records["attention_dropout_bwd" + suffix] = dict(
            shape=shape, length=t, max_abs_err=e15,
            ms=cuda_ms(k15),
            plain_ms=cuda_ms(lambda: ka.attention_bwd_plain(
                q, k, v, mask, g, heads, scale, causal,
                dmask=kd.attention_mask_plain(key, b, heads, t, t, rate,
                                              dev)), iters=5),
            library_ms=cuda_ms(lambda: torch.autograd.grad(
                lib_out, (qh, kh, vh), gh, retain_graph=True)),
            flops=10.0 * heads * d * int(allowed.sum()),
            bytes=8 * b * t * heads * d * 2 + b * heads * t * 4 + b * t)
        del lib_out


def expect_refusal(name, call):
    """The wrapper must raise ValueError and launch nothing."""
    from speechmix_tpu_torch.ops import kernels
    before = [k.launches for k in kernels.kernels()]
    try:
        call()
    except ValueError as e:
        if [k.launches for k in kernels.kernels()] != before:
            raise AssertionError(f"{name}: launched before refusing")
        log(f"  {name}: refused ({e})")
        return
    raise AssertionError(f"{name}: ran instead of refusing")


class plain_kernels:
    """Context that routes the port's kernel call sites to their plain
    versions, for the f32 reference runs of this script only."""

    def __enter__(self):
        from speechmix_tpu_torch import generation
        from speechmix_tpu_torch.models import seq2seq
        from speechmix_tpu_torch.ops import attention as attn_mod
        from speechmix_tpu_torch.ops.kernels import attention as ka
        from speechmix_tpu_torch.ops.kernels import beam_gather as kg
        from speechmix_tpu_torch.ops.kernels import conv_extractor as kc
        from speechmix_tpu_torch.ops.kernels import decode_attention as kd
        from speechmix_tpu_torch.ops.kernels import dropout as kdrop
        from speechmix_tpu_torch.ops.kernels import ffn as kf

        def mask(key, stream, n, cols, rate, device):
            return (kdrop.dropout_mask_plain(key, stream, n, cols, rate,
                                             device) if rate > 0 else None)

        def attn_mask(q, k, heads, key, rate):
            return kdrop.attention_mask_plain(key, q.shape[0], heads,
                                              q.shape[1], k.shape[1], rate,
                                              q.device)
        act, out = kdrop.STREAM_ACT, kdrop.STREAM_OUT
        swaps = [(ka, "attention_fwd", ka.attention_fwd_plain),
                 (ka, "attention_bwd",
                  lambda q, k, v, mask, out, lse, g, heads, scale, causal:
                  ka.attention_bwd_plain(q, k, v, mask, g, heads, scale,
                                         causal)),
                 (kf, "ffn_res_ln", kf.ffn_res_ln_plain),
                 (kf, "dense_res_ln", kf.dense_res_ln_plain),
                 (kf, "ffn_fused", kf.ffn_fused_plain),
                 (kf, "ffn_bwd", kf.ffn_bwd_plain),
                 # the dense backward's products of the upcast operands
                 (kf, "_mm_f32", lambda a, b: a.float() @ b.float()),
                 (attn_mod, "decode_attention", kd.decode_attention_plain),
                 (seq2seq, "decode_attention", kd.decode_attention_plain),
                 (generation, "beam_gather", kg.beam_gather_plain),
                 (kc, "fused_conv_layer", kc.fused_conv_layer_plain),
                 (kc, "conv_layer_backward", kc.conv_layer_backward_plain),
                 # the dropout kernels: plain versions fed the plain
                 # generator's masks of the same key
                 (kdrop, "dropout_mask", kdrop.dropout_mask_plain),
                 (kf, "dropout_mask", kdrop.dropout_mask_plain),
                 (ka, "attention_dropout_fwd",
                  lambda q, k, v, m, heads, scale, causal, key, rate,
                  return_lse=False: ka.attention_fwd_plain(
                      q, k, v, m, heads, scale, causal, return_lse,
                      attn_mask(q, k, heads, key, rate))),
                 (ka, "attention_dropout_bwd",
                  lambda q, k, v, m, o, lse, g, heads, scale, causal, key,
                  rate: ka.attention_bwd_plain(
                      q, k, v, m, g, heads, scale, causal,
                      attn_mask(q, k, heads, key, rate))),
                 (kf, "dense_dropout_res_ln",
                  lambda x, w, b, res, g, beta, key, rate, eps=1e-5:
                  kf.dense_dropout_res_ln_plain(
                      x, w, b, res, g, beta,
                      mask(key, out, x.shape[0], w.shape[1], rate, x.device),
                      eps)),
                 (kf, "ffn_dropout_res_ln",
                  lambda x, w1, b1, w2, b2, res, g, beta, key, ar, orate,
                  act_="gelu", eps=1e-5: kf.ffn_dropout_res_ln_plain(
                      x, w1, b1, w2, b2, res, g, beta,
                      mask(key, act, x.shape[0], w1.shape[1], ar, x.device),
                      mask(key, out, x.shape[0], w2.shape[1], orate,
                           x.device), act_, eps)),
                 (kf, "ffn_dropout",
                  lambda x, w1, b1, w2, b2, key, rate, act_="gelu":
                  kf.ffn_dropout_plain(
                      x, w1, b1, w2, b2,
                      mask(key, act, x.shape[0], w1.shape[1], rate,
                           x.device), act_)),
                 (kf, "ffn_dropout_bwd",
                  lambda x, g, w1, b1, w2, key, rate, act_="gelu":
                  kf.ffn_bwd_plain(
                      x, g, w1, b1, w2, act_,
                      mask(key, act, x.shape[0], w1.shape[1], rate,
                           x.device)))]
        self.saved = [(mod, name, getattr(mod, name))
                      for mod, name, _ in swaps]
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


BATCH, SECONDS, MAX_LEN, BEAMS = 16, 16.0, 64, 4
# the kernels of the dropout-on train step, never launched elsewhere
DROPOUT_KERNELS = ("smx_dropout_mask", "smx_dense_dropout_res_ln",
                   "smx_dense_dropout_res_ln_f32", "smx_ffn_dropout_up",
                   "smx_ffn_dropout_down_res", "smx_ffn_dropout_up_f32",
                   "smx_ffn_dropout_down_res_f32",
                   "smx_attention_dropout_fwd", "smx_attention_dropout_bwd",
                   "smx_ffn_dropout_bwd_recompute",
                   "smx_ffn_dropout_bwd_recompute_f32")
# K4's serial body through its own entries: timed beside the cluster body
# in phase 3, never launched by the path
K4_SERIAL = ("smx_decode_attention_serial", "smx_decode_attention_q8_serial")
# K3 / K9 forward entries: the passes of ffn_fwd.cu (K3 = up + down_res +
# rows, K9 = up + down), in f32 their f32 entries; K12 / K13 take the
# dropout up and down_res passes, and K13 K9's down pass
FWD_ENTRIES = ("smx_ffn_up", "smx_ffn_down", "smx_ffn_down_res",
               "smx_res_ln_rows", "smx_ffn_up_f32", "smx_ffn_down_f32",
               "smx_ffn_down_res_f32", "smx_res_ln_rows_f32")
# K2 / K11 by compute dtype: the cluster kernel of dense_res_ln.cu in bf16,
# the f32 entry of ffn_fwd.cu (the f32 down pass to z, then the rows)
DENSE_ENTRIES = {"bf16": "smx_dense_res_ln", "f32": "smx_dense_res_ln_f32"}
DENSE_DROPOUT_ENTRIES = {"bf16": "smx_dense_dropout_res_ln",
                         "f32": "smx_dense_dropout_res_ln_f32"}


def ffn_forward_launches(k3, k9, dtype="bf16", dropout=False):
    """Launches of the forward entries for k3 calls of K3 (K12 with
    dropout) and k9 of K9 (K13)."""
    want = dict.fromkeys(FWD_ENTRIES, 0)
    suffix = "_f32" if dtype == "f32" else ""
    up, down_res = (("smx_ffn_dropout_up", "smx_ffn_dropout_down_res")
                    if dropout else ("smx_ffn_up", "smx_ffn_down_res"))
    want.update({up + suffix: k3 + k9, down_res + suffix: k3,
                 "smx_res_ln_rows" + suffix: k3, "smx_ffn_down" + suffix: k9})
    return want


def dense_launches(k2, dtype="bf16", dropout=False):
    """Launches of K2's entries (K11's with dropout) for k2 calls in
    `dtype`, the other dtype's entry 0."""
    names = DENSE_DROPOUT_ENTRIES if dropout else DENSE_ENTRIES
    return {name: k2 if d == dtype else 0 for d, name in names.items()}
# K8's entries by compute dtype: the recompute pass and the products
# (shared by the dropout twin), in f32 their f32 entries
K8_ENTRIES = {"bf16": ("smx_ffn_bwd_recompute", "smx_ffn_bwd_products"),
              "f32": ("smx_ffn_bwd_recompute_f32", "smx_ffn_bwd_products_f32")}
K8_DROPOUT_ENTRIES = {"bf16": ("smx_ffn_dropout_bwd_recompute",
                               "smx_ffn_bwd_products"),
                      "f32": ("smx_ffn_dropout_bwd_recompute_f32",
                              "smx_ffn_bwd_products_f32")}
K8_ALL = sorted({e for d in (K8_ENTRIES, K8_DROPOUT_ENTRIES)
                 for v in d.values() for e in v})
# f32 kernel path against f32 plain path on the flagship: share of equal
# tokens, and largest difference of the beams' length-normalised scores
TOKEN_AGREEMENT_F32, BEAM_SCORE_TOL_F32 = 0.99, 1e-4


def expected_launches(mode, steps):
    """Launches of every kernel in one generate() of the flagship."""
    want = {"smx_attention_fwd": LAYERS_WITH_KERNELS,
            **dense_launches(LAYERS_WITH_KERNELS),
            "smx_conv_ln_gelu": FUSED_CONV_LAYERS,
            **dict.fromkeys(CONV_BWD, 0),
            # self- and cross-attention of each decoder layer, each step
            "smx_decode_attention": 2 * DECODER_LAYERS * steps,
            "smx_decode_attention_q8": 0, "smx_beam_gather": 0,
            **dict.fromkeys(K4_SERIAL, 0),
            # the training kernels: never under generate()
            "smx_attention_bwd": 0,
            **dict.fromkeys(K8_ALL, 0), **dict.fromkeys(DROPOUT_KERNELS, 0),
            # K3 in every encoder layer, in bf16 its three passes
            **ffn_forward_launches(LAYERS_WITH_KERNELS, 0)}
    if mode in ("greedy-int8", "constrained-int8"):
        want["smx_decode_attention"] = DECODER_LAYERS * steps
        want["smx_decode_attention_q8"] = DECODER_LAYERS * steps
    if mode in BEAM_MODES:
        # one K5 reorder of the self-K/V cache per step, for every group
        want["smx_beam_gather"] = steps
    return want


def f32_generate_launches(mode, steps):
    """expected_launches for a generate() in f32: K2 and K3's passes in
    their f32 entries."""
    want = expected_launches(mode, steps)
    want.update({**dense_launches(LAYERS_WITH_KERNELS, "f32"),
                 **ffn_forward_launches(LAYERS_WITH_KERNELS, 0, "f32")})
    return want


# the modes of generate() whose loop reorders the beams (K5) each step; the
# other modes decode as greedy does
BEAM_MODES = ("beam-4", "beam-sample", "group-beam", "constrained",
              "constrained-int8")


def flagship_inputs(seed):
    """The flagship's config, bf16 parameters from `seed` and B = BATCH
    waveforms of SECONDS s on the card."""
    import torch
    from speechmix_tpu_torch.models import speechmix

    cfg = flagship_config()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = speechmix.init_speechmix(cfg, gen, dev, torch.bfloat16)
    t_samples = int(SECONDS * 16000)
    t_padded = cfg.encoder.aligned_samples(t_samples)
    wav = torch.zeros(BATCH, t_padded, device=dev)
    wav[:, :t_samples] = torch.randn(BATCH, t_samples, generator=gen,
                                     device=dev) * 0.1
    lengths = torch.full((BATCH,), t_samples, device=dev)
    return cfg, params, wav, lengths


def run_flagship(seed, card):
    """Phase 4.  Returns {mode: launch count of each kernel per generate()}
    and {mode: K4's launches per generate() by (entry, key length)} for the
    modes greedy, greedy-int8 and beam-4."""
    import torch
    from speechmix_tpu_torch import generation
    from speechmix_tpu_torch.ops import kernels
    from speechmix_tpu_torch.ops.kernels import decode_attention as kd

    # K4's launches by key length (the argument after the K/V and query
    # row counts): self-attention over the cache, cross-attention over the
    # encoder output
    k4_lengths = collections.Counter()
    for kern in (kd.KERNEL, kd.KERNEL_Q8):
        kern.launch = _tally_by_length(kern, k4_lengths, 2)

    cfg, params, wav, lengths = flagship_inputs(seed)
    log(f"flagship wav2vec2-base + bart-base, down_scale 2, fused extractor, "
        f"B={BATCH} x {SECONDS} s, max_length {MAX_LEN}, bf16 matrices")

    modes = {"greedy": (dict(), 8),          # (generate kwargs, calls)
             "greedy-int8": (dict(kv_int8=True), 4),
             "beam-4": (dict(num_beams=BEAMS, num_return_sequences=BEAMS,
                             output_scores=True), 4)}
    counts, outputs, by_length = {}, {}, {}
    for mode, (kwargs, calls) in modes.items():
        want = expected_launches(mode, MAX_LEN)
        warmup, times = (2 if mode == "greedy" else 1), []
        for i in range(calls):
            kernels.reset_launch_counts()
            k4_lengths.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = generation.generate(params, cfg, wav, lengths,
                                      max_length=MAX_LEN,
                                      dtype=torch.bfloat16, **kwargs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            run_counts = {k.symbol: k.launches for k in kernels.kernels()}
            log(f"  {mode} generate call {i}: {dt * 1e3:.1f} ms, launches "
                f"{run_counts}")
            if run_counts != want:
                raise AssertionError(f"{mode}: launches {run_counts}, "
                                     f"expected {want}")
            if i >= warmup:
                times.append(dt)
        counts[mode], outputs[mode] = run_counts, out
        by_length[mode] = dict(k4_lengths)
        log(f"  {mode}: K4 launches by key length "
            f"{ {f'{k[0]} {k[1]}': n for k, n in sorted(k4_lengths.items())} }")
        rows = BATCH * kwargs.get("num_return_sequences", 1)
        if out[0].shape != (rows, MAX_LEN) or (out[1] < 0).any():
            raise AssertionError(f"{mode}: bad generate output "
                                 f"{tuple(out[0].shape)}")
        med = sorted(times)[len(times) // 2]
        log(f"  {mode}: audio-seconds per second {BATCH * SECONDS / med:.2f} "
            f"(median of {len(times)} calls, {med * 1e3:.1f} ms; all: "
            f"{', '.join(f'{t * 1e3:.1f}' for t in times)}) on {card}")
    stage_breakdown(params, cfg, wav, lengths, modes)
    tied_head_times(params, cfg)
    text_encoder_out = lambda p, dtype: encoder_output(  # noqa: E731
        p, cfg, wav, lengths, dtype)
    p32 = _cast_tree(params, torch.float32)
    f32_run = lambda **kw: generation.generate(
        p32, cfg, wav, lengths, max_length=MAX_LEN, dtype=torch.float32, **kw)
    with torch.no_grad():
        out_bf16, mask = text_encoder_out(params, torch.bfloat16)
        out_k32, _ = text_encoder_out(p32, torch.float32)
        k32_tokens, _ = f32_run()
        k32_int8, _ = f32_run(kv_int8=True)
        k32_beam = f32_run(**modes["beam-4"][0])
        with plain_kernels():
            kernels.reset_launch_counts()
            ref, _ = text_encoder_out(p32, torch.float32)
            ref_tokens, _ = f32_run()
            ref_int8, _ = f32_run(kv_int8=True)
            ref_beam = f32_run(**modes["beam-4"][0])
            if any(k.launches for k in kernels.kernels()):
                raise AssertionError("the plain reference launched a kernel")
    valid = mask[..., None].float()

    def rel(a):
        return (((a - ref) * valid).norm() / (ref * valid).norm()).item()
    for name, a, bound in (("f32 kernels", out_k32, REL_BOUND_F32),
                           ("bf16 kernels", out_bf16, REL_BOUND_BF16)):
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name}: non-finite text-encoder output")
        r = rel(a)
        log(f"  text-encoder output, {name} vs f32 plain path: relative "
            f"error {r:.3e} (bound {bound})")
        if r > bound:
            raise AssertionError(f"{name}: relative error {r} > {bound}")

    def agreement(a, b):
        return (a == b).float().mean().item()
    # the decode wiring (K4 in attention() and _cross_attention, the shared
    # cross K/V of the beams, K5's ping-pong, the int8 cache): in f32 the
    # kernel path must decode what the plain path decodes.  A near-tie of two
    # logits may still flip a token and what follows it in that row, hence
    # 0.99 and not 1.
    score_diff = (k32_beam[2] - ref_beam[2]).abs().max().item()
    for name, a, b in (("greedy", k32_tokens, ref_tokens),
                       ("greedy-int8", k32_int8, ref_int8),
                       ("beam-4", k32_beam[0], ref_beam[0])):
        rate = agreement(a, b)
        log(f"  {name} token agreement, f32 kernels vs f32 plain path: "
            f"{rate:.4f} (at least {TOKEN_AGREEMENT_F32})")
        if rate < TOKEN_AGREEMENT_F32:
            raise AssertionError(f"{name}: f32 kernel path agrees with the "
                                 f"plain path on {rate} of the tokens")
    log(f"  beam-4 sequences_scores, f32 kernels vs f32 plain path: max abs "
        f"difference {score_diff:.3e} (at most {BEAM_SCORE_TOL_F32})")
    if not score_diff <= BEAM_SCORE_TOL_F32:
        raise AssertionError(f"beam-4: f32 sequences_scores differ by "
                             f"{score_diff}")
    tokens = outputs["greedy"][0]
    log(f"  greedy token agreement, bf16 kernels vs f32 plain path: "
        f"{agreement(tokens, ref_tokens):.4f}")
    log(f"  greedy token agreement, int8 vs bf16 cross K/V (bf16 kernels): "
        f"{agreement(outputs['greedy-int8'][0], tokens):.4f}")
    beam_tok, _, beam_scores = outputs["beam-4"]
    log(f"  beam-4 token agreement, bf16 kernels vs f32 plain path: "
        f"{agreement(beam_tok, ref_beam[0]):.4f}")
    for name, sc in (("bf16 kernels", beam_scores), ("f32 kernels",
                                                    k32_beam[2])):
        per_row = sc.float().reshape(BATCH, BEAMS)
        if not torch.isfinite(per_row).all() or (per_row < -1e8).any():
            raise AssertionError(f"beam-4 {name}: unfinished or non-finite "
                                 "sequences_scores")
        if (per_row[:, 1:] > per_row[:, :-1]).any():
            raise AssertionError(f"beam-4 {name}: sequences_scores increase "
                                 "within an input row")
    log(f"  beam-4 sequences_scores: finite and non-increasing per input "
        f"row; best {beam_scores.reshape(BATCH, BEAMS)[:, 0].mean():.3f}, "
        f"worst {beam_scores.reshape(BATCH, BEAMS)[:, -1].mean():.3f} (means "
        "over rows)")
    return counts, by_length


def encoder_output(params, cfg, wav, lengths, dtype):
    """The text encoder's output (speech encoder, length adapter, text
    encoder: K6, K1, K2 and K3 at these inputs' lengths) in f32, and its
    frame mask."""
    from speechmix_tpu_torch.models import seq2seq, speechmix
    emb, mask = speechmix.encode_speech(params, cfg, wav, lengths,
                                        dtype=dtype)
    enc = seq2seq.encode(params["nlp"], cfg.decoder, inputs_embeds=emb,
                         attention_mask=mask, dtype=dtype)
    return enc["last_hidden_state"].float(), mask


# a name's work on the device in one profiled run: launches, summed us
DeviceTotal = collections.namedtuple("DeviceTotal",
                                     "key count self_device_time_total")


def device_totals(prof):
    """The kernels, copies and fills of a finished torch.profiler run, one
    DeviceTotal per name, read from the profiler's raw events.
    key_averages() gives the same sums, but builds the whole event tree
    first: seconds for a decode call's ~10^4 launches."""
    import torch
    totals = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            total = totals[e.name()]
            total[0] += 1
            total[1] += e.duration_ns() / 1e3
    return [DeviceTotal(k, n, us) for k, (n, us) in totals.items() if us > 0]


def profile_call(fn, cross_check=False):
    """One synchronised call of fn under torch.profiler: (wall us, summed
    device time of its kernels in us, device_totals of the run).  With
    cross_check the sum is held against key_averages()'s."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = device_totals(prof)
    busy_us = sum(e.self_device_time_total for e in events)
    if cross_check:
        ref = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.self_device_time_total > 0)
        log(f"  device time from the raw events {busy_us:.1f} us, from "
            f"key_averages() {ref:.1f} us")
        if abs(busy_us - ref) > 1e-3 * ref + 1.0:
            raise AssertionError("device_totals differs from key_averages()")
    return wall_us, busy_us, events


def stage_breakdown(params, cfg, wav, lengths, modes):
    """Median ms of each stage of generate() (host clock around
    synchronised calls), and for every mode the device-busy share of one
    whole call from torch.profiler: summed device time of all kernels over
    wall time."""
    import torch
    from speechmix_tpu_torch import generation
    from speechmix_tpu_torch.models import seq2seq, speechmix

    dt = torch.bfloat16
    state = {}

    def speech():
        state["emb"], state["mask"] = speechmix.encode_speech(
            params, cfg, wav, lengths, dtype=dt)

    def text():
        state["enc"] = seq2seq.encode(
            params["nlp"], cfg.decoder, inputs_embeds=state["emb"],
            attention_mask=state["mask"], dtype=dt)["last_hidden_state"]

    def decode(**kw):
        return lambda: generation.greedy_decode(
            params["nlp"], cfg.decoder, state["enc"], state["mask"], MAX_LEN,
            dt, **kw)

    def beam():
        generation.beam_search(params["nlp"], cfg.decoder, state["enc"],
                               state["mask"], MAX_LEN, BEAMS, dtype=dt)

    with torch.no_grad():
        for name, fn in (
                ("speech encoder + bridge", speech), ("text encoder", text),
                ("greedy decode loop (cross-KV + 64 steps)", decode()),
                ("greedy-int8 decode loop (int8 cross-KV + 64 steps)",
                 decode(kv_int8=True)),
                ("beam-4 decode loop (cross-KV + 64 steps)", beam)):
            runs = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                runs.append(time.perf_counter() - t0)
            log(f"  stage {name}: {sorted(runs)[2] * 1e3:.1f} ms (median "
                "of 5)")
        for mode, (kwargs, _) in modes.items():
            wall_us, busy_us, events = profile_call(
                lambda: generation.generate(params, cfg, wav, lengths,
                                            max_length=MAX_LEN, dtype=dt,
                                            **kwargs))
            log(f"  profiled {mode} generate: wall {wall_us / 1e3:.1f} ms, "
                f"device busy {busy_us / 1e3:.1f} ms "
                f"({busy_us / wall_us:.3f} of wall)")
            top = sorted(events, key=lambda e: -e.self_device_time_total)
            for e in top[:10 if mode == "greedy" else 6]:
                log(f"    {e.self_device_time_total / 1e3:9.2f} ms  "
                    f"{e.count:6d}x  {e.key[:90]}")
            for label, names in (("attention forward (K1)",
                                  ATTN_FWD_KERNELS),
                                 ("extractor conv (K6)", (CONV_KERNEL,)),
                                 ("decode attention (K4)", DECODE_KERNELS)):
                log_kernel_sum(events, label, names,
                               f"the profiled {mode} generate")


def tied_head_times(params, cfg):
    """The tied LM head of bart-base, (V, H) = (50265, 768), as the port runs
    it: the f32 product of the bf16 operands (seq2seq._tied_logits), held
    against the f32 product of the same rounded operands and timed beside
    the bf16-rounded product it replaced, per decode step (greedy: B rows,
    beam-4: 4 B rows) and as the train step's forward and backward (B x 64
    rows, f32 master table)."""
    import torch
    import torch.nn.functional as F
    from speechmix_tpu_torch.models import seq2seq

    bf16, dev = torch.bfloat16, torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    emb = params["nlp"]["shared"]["embedding"]
    head = seq2seq.tied_head_operand(params["nlp"], cfg.decoder, bf16)
    h = cfg.decoder.hidden_size
    route = ("torch.mm(out_dtype=float32)" if head.dtype == bf16
             else "float32 product of the upcast operands")
    log(f"tied head (V={emb.shape[0]}, H={h}), bf16 operands, f32 result: "
        f"{route}")
    for rows, what in ((BATCH, "greedy step"), (BATCH * BEAMS, "beam-4 step")):
        x = torch.randn(rows, 1, h, generator=gen, device=dev).to(bf16)
        with torch.no_grad():
            got = seq2seq._tied_logits(x, head)
            xf, wf = x.float(), emb.to(bf16).float()
            compare(f"tied head, {what}", got, F.linear(xf, wf),
                    2.0 ** -12 * F.linear(xf.abs(), wf.abs()) + 1e-6,
                    "2^-12 (|x||w|) + 1e-6 (f32 sums)")
            share = (got == got.to(bf16).float()).float().mean().item()
            new = cuda_ms(lambda: seq2seq._tied_logits(x, head), iters=64)
            old = cuda_ms(lambda: F.linear(x, emb.to(bf16)).float(), iters=64)
        log(f"  {what} ({rows} rows): {new:.4f} ms (x {MAX_LEN} steps: "
            f"{new * MAX_LEN:.2f} ms per call); the bf16-rounded product "
            f"{old:.4f} ms; bf16-representable logits {share:.4f}")
    w32 = emb.float().requires_grad_()
    x = torch.randn(BATCH, TRAIN_LABELS, h, generator=gen,
                    device=dev).to(bf16).requires_grad_()
    g = torch.randn(BATCH, TRAIN_LABELS, emb.shape[0], generator=gen,
                    device=dev)

    def fwd_bwd(fn):
        return torch.autograd.grad(fn(), (x, w32), g)
    new = cuda_ms(lambda: fwd_bwd(
        lambda: seq2seq._tied_logits(x, w32.to(bf16))), iters=10)
    old = cuda_ms(lambda: fwd_bwd(
        lambda: F.linear(x, w32.to(bf16)).float()), iters=10)
    log(f"  train step forward + backward ({BATCH} x {TRAIN_LABELS} rows): "
        f"{new:.4f} ms; the bf16-rounded product {old:.4f} ms")
    del g


# ---------------------------------------------------------------------------
# the other modes of generate() (sampling, processors, group, constrained)
# ---------------------------------------------------------------------------

# token ids of the processors and constraints (bart-base's vocabulary)
BAD_WORDS = [[1000], [2000, 2001]]
SUPPRESS, BEGIN_SUPPRESS = [3000, 3001], [4000]
PHRASE, WORD_SET = [5000, 5001], [[6000], [7000, 7001]]
MIN_LENGTH, NO_REPEAT = 8, 3
# how far the EOS bias calibration lowers EOS so that no row ends
EOS_LOW = 30.0


def prefix_allowed(batch_id, seq):
    """prefix_allowed_tokens_fn of the prefix mode: a window of 200 tokens
    that moves with the input row and the sequence length, and EOS."""
    base = (1000 + 997 * batch_id + 13 * len(seq)) % 50000
    return list(range(base, base + 200)) + [2]


def generate_modes(seed):
    """{mode: (generate kwargs, K4 / K5 formula of expected_launches)}."""
    sample = dict(do_sample=True, temperature=0.7, top_k=50, top_p=0.9,
                  typical_p=0.95, rng=seed)
    constrained = dict(num_beams=BEAMS, force_words_ids=[PHRASE, WORD_SET],
                       output_scores=True)
    return {
        "sample": (dict(output_scores=True, **sample), "greedy"),
        "processors": (dict(repetition_penalty=1.2,
                            no_repeat_ngram_size=NO_REPEAT,
                            min_length=MIN_LENGTH, bad_words_ids=BAD_WORDS,
                            suppress_tokens=SUPPRESS,
                            begin_suppress_tokens=BEGIN_SUPPRESS,
                            forced_bos_token_id=0, forced_eos_token_id=2),
                       "greedy"),
        # HF's beam-sample warps the accumulated scores: a temperature t
        # divides them again each step (t^-64 at the end), and top_p may
        # leave fewer than 2K live candidates at step 0 (the -1e9 beams
        # fill up), so f32 rounding would pick the beams: top_k alone
        "beam-sample": (dict(num_beams=BEAMS, num_return_sequences=2,
                             output_scores=True, do_sample=True, top_k=50,
                             rng=seed), "beam-sample"),
        "group-beam": (dict(num_beams=BEAMS, num_beam_groups=2,
                            diversity_penalty=0.5, num_return_sequences=2,
                            output_scores=True), "group-beam"),
        "constrained": (constrained, "constrained"),
        "constrained-int8": (dict(kv_int8=True, **constrained),
                             "constrained-int8"),
        # the random flagship repeats one token per row from step 1 on
        # (its EOS gap then stays constant) and prefers EOS at step 0: no
        # repeated bigrams and no EOS at step 0 make the rows' gaps move
        "early-stop": (dict(early_stop=True, no_repeat_ngram_size=2,
                            begin_suppress_tokens=[2]), "greedy"),
        "prefix": (dict(prefix_allowed_tokens_fn=prefix_allowed), "greedy"),
    }


def eos_bias_for_early_stop(params, cfg, wav, lengths, **kwargs):
    """A change of final_logits_bias[eos] that makes the rows of the bf16
    greedy call with `kwargs` end at different steps, all early enough for
    the early exit to skip steps.
    One call with EOS lowered by EOS_LOW never ends a row; at its step t,
    row r's gap is its best logit minus its EOS logit (EOS_LOW added back).
    With the bias b, row r follows the same tokens and ends at the first
    step whose gap is below b.  b is taken halfway between two gaps (a
    margin against rounding) where the rows end at three or more distinct
    steps (two if no bias gives three) and the loop runs the fewest.
    Returns (b, the step at which each row should end)."""
    import torch
    from speechmix_tpu_torch import generation
    eos = cfg.decoder.eos_token_id
    low = dict(params, nlp=dict(params["nlp"]))
    low["nlp"]["final_logits_bias"] = params["nlp"]["final_logits_bias"] \
        .clone()
    low["nlp"]["final_logits_bias"][..., eos] -= EOS_LOW
    _, _, scores = generation.generate(
        low, cfg, wav, lengths, max_length=MAX_LEN, dtype=torch.bfloat16,
        output_scores=True, **kwargs)
    eos_logit = scores[..., eos].double() + EOS_LOW
    scores[..., eos] = float("-inf")
    gap = (scores.max(dim=-1).values.double() - eos_logit).T.cpu()  # (B, T)
    vals = torch.unique(gap[torch.isfinite(gap)])
    mids, margins = (vals[1:] + vals[:-1]) / 2, (vals[1:] - vals[:-1]) / 2
    below = gap[None] < mids[:, None, None]                       # (C, B, T)
    ends = torch.where(below.any(-1), below.double().argmax(-1), MAX_LEN)
    distinct = (torch.sort(ends, dim=1).values.diff(dim=1) != 0).sum(1) + 1
    ok = (ends <= MAX_LEN - 1 - generation._EARLY_STOP_LAG).all(1) & (
        margins >= 1e-3)
    distinct = torch.where(ok, distinct, 0)
    ok &= distinct >= min(3, distinct.max().item())
    if not ok.any() or distinct.max() < 2:
        raise AssertionError("early-stop: no EOS bias ends the rows at "
                             "different steps")
    # the fewest steps run, then the widest margin
    last = ends.max(dim=1).values
    pick = torch.where(ok, last - margins / 1e3, float("inf")).argmin()
    return mids[pick].item(), ends[pick].long().tolist()


def _no_repeated_ngram(seq, n):
    grams = [tuple(seq[i: i + n]) for i in range(len(seq) - n + 1)]
    return len(grams) == len(set(grams))


def _contains(seq, word):
    return any(seq[i: i + len(word)] == word
               for i in range(len(seq) - len(word) + 1))


def check_mode_output(mode, out, cfg, fixed_tokens=None):
    """The properties each mode's output must have; raises if one fails.
    Returns a short description for the log."""
    import torch
    tok, lens = out[0].cpu(), out[1].cpu()
    eos, pad = cfg.decoder.eos_token_id, cfg.decoder.pad_token_id
    start = cfg.decoder.decoder_start_token_id
    seqs = [[start] + row[: int(n)] for row, n in zip(tok.tolist(),
                                                      lens.tolist())]
    if mode == "sample":
        scores = out[2].cpu()                         # (T, B, V) post-warp
        kept = torch.isfinite(scores).sum(-1)
        steps = torch.arange(MAX_LEN)[:, None] < lens[None, :]
        picked = scores.gather(2, tok.T[..., None])[..., 0]
        if not torch.isfinite(picked[steps]).all():
            raise AssertionError("sample: a token outside the filtered set")
        return (f"every token inside the filtered set (at most "
                f"{int(kept[steps].max())} kept, median "
                f"{int(kept[steps].median())})")
    if mode == "processors":
        if (tok[:, 0] != 0).any() or (tok[:, : MIN_LENGTH - 1] == eos).any():
            raise AssertionError("processors: forced BOS or min_length")
        if not ((tok[:, -1] == eos) | (tok[:, -1] == pad)).all():
            raise AssertionError("processors: forced EOS")
        for s in seqs:
            if not _no_repeated_ngram(s, NO_REPEAT):
                raise AssertionError(f"processors: a repeated 3-gram in {s}")
            if any(_contains(s, w) for w in BAD_WORDS) or \
                    set(s) & set(SUPPRESS) or s[1] in BEGIN_SUPPRESS:
                raise AssertionError(f"processors: a banned token in {s}")
        return (f"no repeated 3-gram, banned word or suppressed token; no "
                f"EOS before step {MIN_LENGTH}; lengths "
                f"{sorted(set(lens.tolist()))}")
    if mode.startswith("constrained"):
        bad = [s for s in seqs if not (_contains(s, PHRASE) and any(
            _contains(s, w) for w in WORD_SET))]
        if bad:
            raise AssertionError(f"{mode}: {len(bad)} outputs miss a "
                                 f"constraint, e.g. {bad[0]}")
        return f"every output holds {PHRASE} and one of {WORD_SET}"
    if mode == "early-stop":
        if not torch.equal(tok, fixed_tokens.cpu()):
            raise AssertionError("early-stop: tokens differ from the "
                                 "fixed-length call's")
        return "tokens equal the fixed-length call's"
    if mode == "prefix":
        for r, s in enumerate(seqs):
            for i in range(1, len(s)):
                if s[i] not in prefix_allowed(r, s[:i]):
                    raise AssertionError(f"prefix: row {r} step {i - 1} "
                                         f"token {s[i]} not allowed")
        return "every token allowed by the prefix function"
    if out[0].shape[0] != BATCH * 2:
        raise AssertionError(f"{mode}: {out[0].shape[0]} rows")
    per_row = out[2].float().reshape(BATCH, 2)
    if not torch.isfinite(per_row).all() or (per_row < -1e8).any() or \
            (per_row[:, 1] > per_row[:, 0]).any():
        raise AssertionError(f"{mode}: sequences_scores unfinished or "
                             "increasing within an input")
    return "sequences_scores finite, finished and non-increasing per input"


def run_generate_modes(seed, card):
    """Phase 4b: the flagship through generate() in the modes of
    generate_modes.  For each mode in bf16: exact launches of every kernel
    per call (K4 / K5 from expected_launches), two calls with one seed give
    the same bits, the mode's output properties, the median ms of three
    timed calls and the busy share of a profiled one; early-stop's steps.
    Then in f32 the tokens through the kernels must equal those through the
    plain versions (beam scores within BEAM_SCORE_TOL_F32).  Returns {mode:
    launches of each kernel per call}."""
    import torch
    from speechmix_tpu_torch import generation
    from speechmix_tpu_torch.ops import kernels

    cfg, params, wav, lengths = flagship_inputs(seed)
    eos = cfg.decoder.eos_token_id
    modes = generate_modes(seed)
    fixed_kw = {k: v for k, v in modes["early-stop"][0].items()
                if k != "early_stop"}
    bias, ends = eos_bias_for_early_stop(params, cfg, wav, lengths,
                                         **fixed_kw)
    params_es = dict(params, nlp=dict(params["nlp"]))
    fb = params["nlp"]["final_logits_bias"].clone()
    fb[..., eos] += bias
    params_es["nlp"]["final_logits_bias"] = fb
    log(f"generate modes of the flagship (B={BATCH} x {SECONDS} s, "
        f"max_length {MAX_LEN}, bf16); early-stop: final_logits_bias[eos] "
        f"{bias:+.4f}, rows should end at steps {ends}")
    counts, outputs = {}, {}
    for mode, (kwargs, formula) in modes.items():
        p = params_es if mode == "early-stop" else params
        call = lambda: generation.generate(  # noqa: E731
            p, cfg, wav, lengths, max_length=MAX_LEN, dtype=torch.bfloat16,
            **kwargs)
        runs, times = [], []
        for i in range(4):                # a warm-up call, then 3 timed
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            run_counts = {k.symbol: k.launches for k in kernels.kernels()}
            steps = MAX_LEN
            if mode == "early-stop":
                ended = (out[0] == eos).any(1).all().item()
                steps = (min(MAX_LEN, out[1].max().item() + 1) if ended
                         else MAX_LEN)
            want = expected_launches(formula, steps)
            if run_counts != want:
                raise AssertionError(f"{mode}: launches {run_counts}, "
                                     f"expected {want}")
            runs.append(out)
            if i:
                times.append(dt)
        for a, b in zip(runs[1], runs[2]):
            if not torch.equal(a, b):
                raise AssertionError(f"{mode}: two bf16 calls with one seed "
                                     "differ")
        counts[mode], outputs[mode] = run_counts, runs[1]
        fixed = None
        if mode == "early-stop":
            fixed = generation.generate(params_es, cfg, wav, lengths,
                                        max_length=MAX_LEN,
                                        dtype=torch.bfloat16, **fixed_kw)[0]
            if steps >= MAX_LEN or len(set(out[1].tolist())) < 2:
                raise AssertionError(f"early-stop: {steps} steps, lengths "
                                     f"{sorted(set(out[1].tolist()))}")
            log(f"  early-stop: {steps} of {MAX_LEN} steps run, rows end at "
                f"steps {(out[1] - 1).tolist()}")
        what = check_mode_output(mode, out, cfg, fixed)
        med = sorted(times)[1]
        wall_us, busy_us, _ = profile_call(call)
        log(f"  {mode}: {med * 1e3:.1f} ms (median of 3: "
            f"{', '.join(f'{t * 1e3:.1f}' for t in times)}), audio-seconds "
            f"per second {BATCH * SECONDS / med:.2f}; profiled: wall "
            f"{wall_us / 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
            f"({busy_us / wall_us:.3f} of wall); K4 "
            f"{run_counts['smx_decode_attention']}"
            f"+{run_counts['smx_decode_attention_q8']}, K5 "
            f"{run_counts['smx_beam_gather']}; two calls bit-identical; "
            f"{what} on {card}")

    # f32: the kernel path decodes what the plain path decodes
    p32, p32_es = _cast_tree(params, torch.float32), _cast_tree(
        params_es, torch.float32)
    with torch.no_grad():
        for mode, (kwargs, _) in modes.items():
            p = p32_es if mode == "early-stop" else p32
            run = lambda: generation.generate(  # noqa: E731
                p, cfg, wav, lengths, max_length=MAX_LEN,
                dtype=torch.float32, **kwargs)
            got = run()
            with plain_kernels():
                kernels.reset_launch_counts()
                ref = run()
                if any(k.launches for k in kernels.kernels()):
                    raise AssertionError("the plain reference launched a "
                                         "kernel")
            check_mode_output(mode, got, cfg,
                              ref[0] if mode == "early-stop" else None)
            if not (torch.equal(got[0], ref[0])
                    and torch.equal(got[1], ref[1])):
                rate = (got[0] == ref[0]).float().mean().item()
                raise AssertionError(f"{mode}: f32 kernel tokens differ "
                                     f"from the plain path's ({rate:.4f})")
            line = f"  {mode}, f32 kernels vs f32 plain path: tokens equal"
            if mode != "sample" and len(got) == 3:
                diff = (got[2] - ref[2]).abs().max().item()
                if not diff <= BEAM_SCORE_TOL_F32:
                    raise AssertionError(f"{mode}: f32 sequences_scores "
                                         f"differ by {diff}")
                line += (f", sequences_scores max abs difference "
                         f"{diff:.3e} (at most {BEAM_SCORE_TOL_F32})")
            log(line)
    return counts


TRAIN_LABELS, TRAIN_STEPS, TRAIN_LR = 64, 8, 1e-4
# gradient tree of the f32 kernel path against the f32 plain path, per leaf:
# |a - b| <= GRAD_REL * max|b| + GRAD_FLOOR * (largest gradient of the tree)
# (order of summation only; the floor covers leaves such as the attention key
# biases, whose gradient is zero in exact arithmetic and rounding noise here)
GRAD_REL, GRAD_FLOOR = 2e-3, 1e-5
# relu's derivative jumps at 0: where the two paths put a = x w1 on either
# side of 0, da[n, f] is dh[n, f] on one path and 0 on the other, which
# moves element (h, f) of that FFN's fc1 kernel gradient by x[n, h] dh[n, f],
# one of the N terms of its sum (up to about 0.6% of the leaf's largest
# entry at t5-small's width, above GRAD_REL).  relu_flip_allowance finds
# from the data the a's that may flip and adds exactly their terms to the
# limit of those elements; every other element is held to the limit.


def expected_train_launches(speech_layers, enc_layers, dec_layers, accum=1,
                            dtype="bf16"):
    """Launches of every kernel in one train step: a post-LN layer runs K1,
    K2 and K3 forward, K7, K9 and K8 backward (K3 as the up pass, the down
    pass to z and the LayerNorm rows, K9 as the up and down passes, K8 as
    its recompute pass and its products; f32: the f32 entries of each, K2's
    of ffn_fwd.cu); a decoder layer has a second K2
    (the cross-attention's out-projection) and no K1 / K7 for its
    cross-attention, which carries a bias."""
    layers = speech_layers + enc_layers + dec_layers
    want = {"smx_attention_fwd": layers, "smx_attention_bwd": layers,
            **dense_launches(layers + dec_layers, dtype),
            **dict.fromkeys(K8_ALL, 0),
            **dict.fromkeys(K8_ENTRIES[dtype], layers),
            "smx_conv_ln_gelu": FUSED_CONV_LAYERS,
            # K6's backward: every leaf of the extractor trains
            **dict.fromkeys(CONV_BWD, FUSED_CONV_LAYERS),
            "smx_decode_attention": 0, "smx_decode_attention_q8": 0,
            **dict.fromkeys(K4_SERIAL, 0),
            "smx_beam_gather": 0, **dict.fromkeys(DROPOUT_KERNELS, 0),
            **ffn_forward_launches(layers, layers, dtype)}
    return {k: v * accum for k, v in want.items()}


def expected_dropout_train_launches(speech_layers, enc_layers, dec_layers,
                                    dtype="bf16"):
    """Launches of every kernel in one micro-batch of a train step with
    dropout on (every rate above 0): a post-LN layer runs K14, K11 and K12
    forward, K15, K13 (the recompute in K12's backward) and K8 with the
    activation mask backward (bf16: K12 and K13 as the dropout up pass and
    K3's and K9's other passes, the down pass to z with the output mask,
    K8 as the dropout recompute pass and the products; f32: the f32
    dropout entries); a decoder layer has a
    second K11 and a plain cross-attention whose probability mask K10
    draws.  K10 also draws the
    masks of the four plain sites (the feature projection, the positional
    embedding, the two embeddings) and regenerates the output mask in the
    backward of every K11 and K12.  `speech_layers` counts the layers
    LayerDrop kept."""
    layers = speech_layers + enc_layers + dec_layers
    want = expected_train_launches(0, 0, 0)
    want.update({
        "smx_attention_dropout_fwd": layers,
        "smx_attention_dropout_bwd": layers,
        **dense_launches(layers + dec_layers, dtype, dropout=True),
        **ffn_forward_launches(layers, layers, dtype, dropout=True),
        **dict.fromkeys(K8_DROPOUT_ENTRIES[dtype], layers),
        "smx_dropout_mask": 4 + dec_layers + (layers + dec_layers) + layers})
    return want


def _train_batch(cfg, gen, dev, batch, seconds, labels_len):
    import torch
    t_samples = int(seconds * 16000)
    wav = torch.zeros(batch, cfg.encoder.aligned_samples(t_samples),
                      device=dev)
    wav[:, :t_samples] = torch.randn(batch, t_samples, generator=gen,
                                     device=dev) * 0.1
    labels = torch.randint(3, cfg.decoder.vocab_size, (batch, labels_len),
                           generator=gen, device=dev)
    labels[1, labels_len - 7:] = -100
    return {"input_values": wav,
            "lengths": torch.full((batch,), t_samples, device=dev),
            "labels": labels}


def check_gradient_tree(seed, dropout=False, large=False, t5=False,
                        xl=False):
    """On the card, f32, full width, 2 + 2 + 2 layers: d loss / d params
    through the kernels against the same through their plain versions.  With
    dropout, one key drives both runs, so both draw the same masks (the
    presets' rates and SpecAugment; LayerDrop off, to keep the layer
    count).  `large`: the large pair's widths and pre-LN layers instead of
    the flagship's; `t5`: wav2vec2-base + t5-small; `xl`: the XL pair's
    (wav2vec2-xls-r-1b: 16 heads of 80, H = 1280).  Returns the kernels
    path's launches."""
    import dataclasses
    import torch
    from speechmix_tpu_torch import config
    from speechmix_tpu_torch.models import speechmix
    from speechmix_tpu_torch.ops import kernels, layers
    from speechmix_tpu_torch.ops.kernels.dropout import DropoutKey
    from speechmix_tpu_torch.training.freezing import tree_map, tree_paths

    cfg = config.SpeechMixConfig(
        encoder=dataclasses.replace(
            config.SPEECH_ENCODER_PRESETS["wav2vec2-base"],
            extractor_impl="fused", num_layers=2, layerdrop=0.0),
        decoder=dataclasses.replace(config.SEQ2SEQ_PRESETS["bart-base"],
                                    encoder_layers=2, decoder_layers=2),
        down_scale=2)
    if large:
        cfg = large_config((2, 2, 2))
    if xl:
        cfg = xl_config((2, 2, 2))
    if t5:
        cfg = t5_config("t5-small", (2, 2, 2))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = speechmix.init_speechmix(cfg, gen, dev, torch.float32)
    batch = _train_batch(cfg, gen, dev, 8, 8.0, 128)
    key = DropoutKey.from_seed(seed).fold_in(1) if dropout else None
    log(f"gradient tree, f32, {cfg.encoder.name} + {cfg.decoder.name} at full "
        f"width, 2 + 2 + 2 layers, B=8 x 8 s, 128 label positions, dropout "
        f"{'on' if dropout else 'off'}: kernels vs plain versions")

    def grads():
        """(loss, {path: gradient}, {relu fc1 kernel path: (the FFN's input
        x, d loss / d its output)})."""
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        flat = tree_paths(leaves)
        names = {id(leaf): path for path, leaf in flat}
        ffn_apply, ffn_io = layers.ffn_apply, {}

        def spy(p1, p2, x, act_name, *args, **kwargs):
            y = ffn_apply(p1, p2, x, act_name, *args, **kwargs)
            if act_name == "relu":
                ffn_io[names[id(p1["kernel"])]] = (x, y)
            return y
        layers.ffn_apply = spy
        try:
            out = speechmix.speechmix_forward(
                leaves, cfg, batch["input_values"], batch["lengths"],
                labels=batch["labels"], dtype=torch.float32,
                dropout_rng=key)
        finally:
            layers.ffn_apply = ffn_apply
        io = list(ffn_io.items())
        # masked_spec_embed has no gradient without SpecAugment
        got = torch.autograd.grad(
            out["loss"], [leaf for _, leaf in flat] + [y for _, (_, y) in io],
            allow_unused=True)
        return (out["loss"].item(),
                {path: g for (path, _), g in zip(flat, got) if g is not None},
                {path: (x.detach(), dy) for (path, (x, _)), dy in
                 zip(io, got[len(flat):])})

    kernels.reset_launch_counts()
    loss_k, grads_k, io_k = grads()
    counts = {k.symbol: k.launches for k in kernels.kernels()}
    if large or xl:
        want = expected_preln_train_launches(2, 2, 2, 2, 2, dtype="f32",
                                             dropout=dropout)
    elif t5:
        # text-encoder rows 8 x 200, decoder rows 8 x 128
        want = expected_t5_train_launches(cfg, 2, (1600, 1024), dtype="f32",
                                          dropout=dropout)
    else:
        want = (expected_dropout_train_launches(2, 2, 2, dtype="f32")
                if dropout else expected_train_launches(2, 2, 2, dtype="f32"))
    if counts != want:
        raise AssertionError(f"gradient tree: launches {counts}, expected "
                             f"{want}")
    with plain_kernels():
        kernels.reset_launch_counts()
        loss_p, grads_p, io_p = grads()
        if any(k.launches for k in kernels.kernels()):
            raise AssertionError("the plain reference launched a kernel")
    if grads_k.keys() != grads_p.keys():
        raise AssertionError("gradient tree: kernels and plain versions "
                             "differ in the leaves that have a gradient")
    if io_k.keys() != io_p.keys() or io_k and dropout:
        raise AssertionError("gradient tree: the relu FFNs differ between "
                             "the paths, or run with dropout")
    top = max(g.abs().max().item() for g in grads_p.values())
    worst, worst_path, flips = 0.0, None, {}
    for path, ref in grads_p.items():
        got = grads_k[path]
        if not torch.isfinite(got).all():
            raise AssertionError(f"gradient of {path} is not finite")
        limit = GRAD_REL * ref.abs().max().item() + GRAD_FLOOR * top
        err = (got - ref).abs()
        if path in io_p:
            extra, flips[path] = relu_flip_allowance(
                params, path, io_k[path], io_p[path])
            err = err * limit / (limit + extra)
        ratio = err.max().item() / limit if err.numel() else 0.0
        if ratio > worst:
            worst, worst_path = ratio, path
    log(f"  loss {loss_k:.6f} (kernels) vs {loss_p:.6f} (plain); "
        f"{len(grads_p)} leaves, largest gradient {top:.3e}; worst "
        f"err/limit {worst:.3f} at {worst_path} (limit {GRAD_REL} * max|leaf|"
        f" + {GRAD_FLOOR} * {top:.3e}" + (
            ", plus on relu fc1 kernels the terms of the a's that may flip "
            f"(a's, of them with signs apart, columns): {flips}" if flips
            else "") + ")")
    if abs(loss_k - loss_p) > 1e-4 or worst > 1.0:
        raise AssertionError("gradient tree: kernels and plain versions "
                             "disagree")
    return counts


def relu_flip_allowance(params, path, io_k, io_p):
    """For the relu FFN whose fc1 kernel is at `path`, given its input x and
    the gradient dy of its output on the kernel path (io_k) and on the plain
    path (io_p): the a = x w1 that may lie on different sides of 0 on the
    two paths are those within twice the paths' difference |a_k - a_p| (the
    two inputs through one f32 product) plus 2^-22 sqrt(H) |x[n] * w1[:, f]|
    (four standard deviations of the rounding of an f32 sum of H products,
    as a random walk of 2^-24 per addition) of 0.  Returns (the allowance,
    ((h, f): sum over those n of |x[n, h]| |dh[n, f]|, dh = dy w2^T), (the
    number of such a's, of them the a's whose signs differ, columns))."""
    import torch
    leaf = params
    for part in path.split("/")[:-2]:
        leaf = leaf[int(part)] if isinstance(leaf, list) else leaf[part]
    w1, w2 = leaf["fc1"]["kernel"], leaf["fc2"]["kernel"]
    b1 = leaf["fc1"].get("bias")
    x_k, x_p = (io[0].reshape(-1, w1.shape[0]) for io in (io_k, io_p))
    a_k, a_p = x_k @ w1, x_p @ w1
    if b1 is not None:
        a_k, a_p = a_k + b1, a_p + b1
    rounding = 2.0 ** -22 * w1.shape[0] ** 0.5 * ((x_p * x_p) @ (w1 * w1)
                                                  ).sqrt()
    near = a_p.abs() <= 2 * (a_k - a_p).abs() + rounding
    flips = int(((a_k > 0) != (a_p > 0)).sum())
    dh = io_p[1].reshape(-1, w2.shape[1]) @ w2.t()
    extra = x_p.abs().t() @ (near * dh.abs())
    return extra, (int(near.sum()), flips, int(near.any(0).sum()))


def layerdrop_replay(trainer, speech_encoder, tc, cfg, step):
    """The speech-encoder layers LayerDrop skips at `step`, drawn again from
    the key chain (the step key's speech split, the speech encoder's layer
    split, its LayerDrop split)."""
    key = trainer.dropout_keys(tc, step)[0]
    k_drop = key.split(2)[0].split(4)[2].split(2)[1]
    skips = speech_encoder.layerdrop_skips(
        k_drop, cfg.num_speech_encoder_layers, cfg.encoder.layerdrop)
    return [i for i, skip in enumerate(skips) if skip]


def run_training(seed, card, dropout=False):
    """The training phase: TRAIN_STEPS AdamW steps of the flagship at full
    width and depth on one batch, deterministic or with dropout at the
    presets' rates, SpecAugment and LayerDrop.  Returns the launch counts of
    the last step."""
    import torch
    from speechmix_tpu_torch.models import speech_encoder
    from speechmix_tpu_torch.ops import kernels
    from speechmix_tpu_torch.training import trainer

    cfg = flagship_config()
    tc = trainer.TrainConfig(learning_rate=TRAIN_LR, warmup_steps=1,
                             grad_accum=1, bf16=True, dropout=dropout,
                             optimizer="adamw", seed=seed)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = trainer.create_train_state(gen, cfg, tc)
    batch = _train_batch(cfg, gen, dev, BATCH, SECONDS, TRAIN_LABELS)
    step_fn = trainer.make_train_step(cfg, tc, state.params)
    n_params = sum(p.numel() for _, p in trainer.tree_paths(state.params))
    what = "train step" if not dropout else "dropout train step"
    enc, dec = cfg.encoder, cfg.decoder
    recipe = ("dropout off" if not dropout else
              f"dropout on: speech hidden {enc.dropout}, attention "
              f"{enc.attention_dropout}, activation {enc.activation_dropout}"
              f", feature projection {enc.feat_proj_dropout}, SpecAugment "
              f"{enc.apply_spec_augment} (time p {enc.mask_time_prob}, "
              f"length {enc.mask_time_length}), LayerDrop {enc.layerdrop}; "
              f"text hidden {dec.dropout}, attention {dec.attention_dropout}, "
              f"activation {dec.activation_dropout}")
    log(f"training: flagship, {n_params / 1e6:.1f} M float32 parameters, "
        f"bf16 compute, AdamW lr {TRAIN_LR}, warmup 1, B={BATCH} x {SECONDS} "
        f"s, {TRAIN_LABELS} label positions, {TRAIN_STEPS} steps on one "
        f"batch, {recipe}")
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    # K7 / K15 launches by query length and K2 / K11 launches by row count,
    # counted around their wrappers' launches, for the kernels line's
    # per-length and per-row-count records
    from speechmix_tpu_torch.ops.kernels import attention as ka
    from speechmix_tpu_torch.ops.kernels import conv_extractor as kc
    from speechmix_tpu_torch.ops.kernels import ffn as kf
    by_length = collections.Counter()
    tallied = ((ka.KERNEL, 1), (ka.DROPOUT_KERNEL, 1), (ka.BWD_KERNEL, 1),
               (ka.DROPOUT_BWD_KERNEL, 1), (kf.DENSE_RES_LN, 0),
               (kf.DENSE_DROPOUT_RES_LN, 0), (kc.KERNEL, 1))
    for kern, offset in tallied:
        kern.launch = _tally_by_length(kern, by_length, offset)
    for i in range(TRAIN_STEPS):
        skipped = []
        want = expected_train_launches(cfg.num_speech_encoder_layers,
                                       dec.encoder_layers, dec.decoder_layers)
        if dropout:
            skipped = layerdrop_replay(trainer, speech_encoder, tc, cfg,
                                       state.step)
            want = expected_dropout_train_launches(
                cfg.num_speech_encoder_layers - len(skipped),
                dec.encoder_layers, dec.decoder_layers)
        kernels.reset_launch_counts()
        by_length.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {k.symbol: k.launches for k in kernels.kernels()}
        loss, norm = metrics["loss"].item(), metrics["grad_norm"].item()
        log(f"  step {i + 1}: loss {loss:.4f}, grad_norm {norm:.4f}, "
            f"{dt * 1e3:.1f} ms" + (f", LayerDrop skipped layers {skipped}"
                                    if dropout else ""))
        if metrics["layers_skipped"] != [skipped]:
            raise AssertionError(f"{what} {i + 1}: LayerDrop skipped "
                                 f"{metrics['layers_skipped']}, the key "
                                 f"chain gives {skipped}")
        if counts != want:
            raise AssertionError(f"{what} {i + 1}: launches {counts}, "
                                 f"expected {want}")
        if not (loss == loss and abs(loss) != float("inf")
                and norm == norm and abs(norm) != float("inf")):
            raise AssertionError(f"{what} {i + 1}: loss {loss}, "
                                 f"grad_norm {norm}")
        losses.append(loss)
        if i >= 2:
            times.append(dt)
    for kern, _ in tallied:
        del kern.launch   # the class's own again
    log(f"  launches per step: {counts}")
    log(f"  K1 / K14 / K7 / K15 launches per step by query length, K2 / "
        f"K11 by rows, K6 by T_in: "
        f"{ {f'{k[0]} {k[1]}': n for k, n in sorted(by_length.items())} }")
    if not losses[-1] < losses[1]:
        raise AssertionError(f"{what}: the loss did not fall: {losses}")
    med = sorted(times)[len(times) // 2]
    peak = torch.cuda.max_memory_allocated()
    log(f"  {what}: {med * 1e3:.1f} ms (median of {len(times)}; all: "
        f"{', '.join(f'{t * 1e3:.1f}' for t in times)}), audio-seconds per "
        f"second trained {BATCH * SECONDS / med:.2f}, peak memory "
        f"{peak / 2 ** 30:.2f} GiB, loss {losses[1]:.4f} -> {losses[-1]:.4f} "
        f"on {card}")
    _, _, events = _profile_step(lambda: step_fn(state, batch), what)
    for label, names in (("K8", K8_KERNELS), ("K3 / K9 passes", FWD_KERNELS),
                         ("attention backward (K7 / K15)", ATTN_BWD_KERNELS),
                         ("attention forward (K1 / K14)", ATTN_FWD_KERNELS),
                         ("extractor conv (K6)", (CONV_KERNEL,))):
        log_kernel_sum(events, label, names, f"the profiled {what}")
    bwd_ms, products = dense_bwd_product_ms(step_fn, state, batch)
    hit = [e for e in events if DENSE_KERNEL in e.key]
    log(f"  dense epilogue (K2 / K11) and its backward products in the "
        f"profiled {what}: forward "
        f"{sum(e.self_device_time_total for e in hit) / 1e3:.2f} ms: " +
        ", ".join(f"{KERNEL_NAME.search(e.key).group(0)} "
                  f"{e.self_device_time_total / 1e3:.2f} ms {e.count}x"
                  for e in hit) +
        f"; backward products (x w and x^T g, bf16 operands, f32 results) "
        f"{bwd_ms:.2f} ms in {products} products (one more step, profiled "
        f"with ranges around them)")
    return counts, dict(by_length)


def dense_bwd_product_ms(step_fn, state, batch):
    """Device ms and count of the dense epilogues' backward products
    (ffn._mm_f32) in one more train step, profiled with a CPU range around
    each product; the range's device time is its kernels'."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from speechmix_tpu_torch.ops.kernels import ffn as kf
    mm = kf._mm_f32

    def ranged(a, b):
        with record_function("dense_bwd_product"):
            return mm(a, b)
    kf._mm_f32 = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step_fn(state, batch)
            torch.cuda.synchronize()
    finally:
        kf._mm_f32 = mm
    hits = [e for e in prof.events() if e.name == "dense_bwd_product"
            and e.device_type == DeviceType.CPU]
    return sum(e.device_time_total for e in hits) / 1e3, len(hits)


def log_kernel_sum(events, label, names, where):
    """The device ms of the profiler events whose kernel names contain one
    of `names`, in all and by kernel."""
    hit = [e for e in events if any(name in e.key for name in names)]
    log(f"  {label} in {where}: "
        f"{sum(e.self_device_time_total for e in hit) / 1e3:.2f} ms: " +
        ", ".join(f"{KERNEL_NAME.search(e.key).group(0)} "
                  f"{e.self_device_time_total / 1e3:.2f} ms {e.count}x"
                  for e in hit))


def _tally_by_length(kernel, counter, offset):
    """kernel.launch that also counts each accepted launch under (symbol,
    the integer argument `offset` places after the pointers): K1 / K14 / K7
    / K15's query length (1, after the batch), K2 / K11's row count (0),
    K6's T_in (1)."""
    launch = kernel.launch
    arg = next(i for i, t in enumerate(kernel.argtypes)
               if t is not ctypes.c_void_p) + offset

    def counted(*args):
        launch(*args)
        counter[(kernel.symbol, args[arg])] += 1
    return counted


# K8's device kernels in bf16, and those of the passes of K3 / K9 /
# K12 / K13 (ffn_pass_kernel<dtype, 0, ...>: up, <., 1, ...>: down, <., 2,
# ...>: down to z; the float instances in the f32 runs),
# by name in the profiler's trace
K8_KERNELS = ("recompute_kernel", "products_kernel", "ffn_bwd_reduce_kernel")
FWD_KERNELS = ("ffn_pass_kernel", "res_ln_rows_kernel")
# K7 / K15: the delta pass, the dk/dv pass and the dq pass of
# attention_bwd.cu (in float32 both tiled passes are attention_bwd_f32_kernel)
ATTN_BWD_KERNELS = ("attention_bwd_delta_kernel", "dkdv_kernel", "dq_kernel",
                    "attention_bwd_f32_kernel")
# K2 / K11 in bf16 (dense_res_ln.cu)
DENSE_KERNEL = "dense_ln_kernel"
# K1 / K14 in bf16 and in float32 (attention_fwd.cu) and K6
# (conv_ln_gelu.cu: conv_kernel<dtype, columns a block, LayerNorm>)
ATTN_FWD_KERNEL = "attention_fwd_tc_kernel"
F32_FWD_KERNEL = "attention_fwd_f32_kernel"
ATTN_FWD_KERNELS = (ATTN_FWD_KERNEL, F32_FWD_KERNEL)
CONV_KERNEL = "conv_kernel"
# K4: the cluster body (bf16 q, 128 < T <= 2048) and the serial body (f32
# q, the 64-slot self-attention cache, T > 2048)
DECODE_KERNELS = ("decode_cluster_kernel", "decode_attention_kernel")
KERNEL_NAME = re.compile(r"\w+_kernel(<[^>]*>)?")


# ---------------------------------------------------------------------------
# the large pair (wav2vec2-large-960h-lv60 + bart-large) and the variants
# ---------------------------------------------------------------------------

LARGE_HEADS, LARGE_H, LARGE_F = 16, 1024, 4096
LARGE_BATCH = 16
# the unfreezing progress (epoch / freeze_epochs) of the large pair's steps
LARGE_PROGRESS = (0.0, 0.0, 0.0, 0.5, 0.5, 0.5, 1.0, 1.0)
LARGE_FREEZE_EPOCHS = 2
VARIANT_STEPS = 4
GAN_DES_UPDATE = 2


def large_config(layers=None):
    """facebook/wav2vec2-large-960h-lv60 (24 pre-LN layers, H=1024, a
    LayerNorm in every extractor layer, the fused extractor) + bart-large
    (12 + 12 layers, H=1024, vocabulary 50265), down_scale 2.  `layers`:
    (speech, text encoder, decoder) depths of a cut copy, LayerDrop off."""
    import dataclasses
    from speechmix_tpu_torch import config
    enc = dataclasses.replace(
        config.SPEECH_ENCODER_PRESETS["facebook/wav2vec2-large-960h-lv60"],
        extractor_impl="fused")
    dec = config.SEQ2SEQ_PRESETS["bart-large"]
    if layers is not None:
        enc = dataclasses.replace(enc, num_layers=layers[0], layerdrop=0.0)
        dec = dataclasses.replace(dec, encoder_layers=layers[1],
                                  decoder_layers=layers[2])
    return config.SpeechMixConfig(encoder=enc, decoder=dec, down_scale=2)


def flagship_config(variant="eed"):
    import dataclasses
    from speechmix_tpu_torch import config
    return config.SpeechMixConfig(
        encoder=dataclasses.replace(
            config.SPEECH_ENCODER_PRESETS["wav2vec2-base"],
            extractor_impl="fused"),
        decoder=config.SEQ2SEQ_PRESETS["bart-base"], down_scale=2,
        variant=variant, gan_discriminator_update_every=GAN_DES_UPDATE)


def expected_preln_train_launches(kept, attn_bwd, ffn_bwd, enc_layers,
                                  dec_layers, dtype="bf16", dropout=False):
    """Launches of every kernel in one micro-batch of a train step of a
    pre-LN speech encoder with a BART model whose layers all train: a kept
    pre-LN layer runs K1 (K14 with dropout) and K9 (K13) forward, K7 (K15)
    where its attention's backward runs (attn_bwd layers) and K8 where its
    FFN's backward runs (ffn_bwd layers); its out-projection, residuals and
    LayerNorms are plain, with dropout K10 drawing its two output masks.
    The text encoder and the decoder run as in expected_train_launches and
    expected_dropout_train_launches."""
    nlp = enc_layers + dec_layers
    want = expected_train_launches(0, 0, 0, dtype=dtype)
    if not dropout:
        want.update({"smx_attention_fwd": kept + nlp,
                     "smx_attention_bwd": attn_bwd + nlp,
                     **dense_launches(nlp + dec_layers, dtype),
                     **dict.fromkeys(K8_ENTRIES[dtype], ffn_bwd + nlp),
                     **ffn_forward_launches(nlp, kept + nlp, dtype)})
        return want
    want.update({"smx_attention_dropout_fwd": kept + nlp,
                 "smx_attention_dropout_bwd": attn_bwd + nlp,
                 **dense_launches(nlp + dec_layers, dtype, dropout=True),
                 **ffn_forward_launches(nlp, kept + nlp, dtype, dropout=True),
                 **dict.fromkeys(K8_DROPOUT_ENTRIES[dtype], ffn_bwd + nlp),
                 "smx_dropout_mask": (4 + dec_layers + (nlp + dec_layers)
                                      + nlp + 2 * kept)})
    return want


def speech_backward_layers(enc_mask, kept):
    """The kept pre-LN layers whose attention backward (K7 / K15) and FFN
    backward (K8) run under the unfreezing mask `enc_mask` of the speech
    encoder: a layer's attention backward runs when its input needs a
    gradient (something below it trains) or its q / k / v projections or its
    first LayerNorm train; its FFN backward when its input or anything of
    the layer trains."""
    from speechmix_tpu_torch.training.freezing import tree_paths
    trains = lambda tree: any(m > 0 for _, m in tree_paths(tree))
    below = trains({k: v for k, v in enc_mask.items()
                    if k not in ("layers", "encoder_layer_norm")})
    attn, ffn = [], []
    for layer in kept:
        lm = enc_mask["layers"][layer]
        if below or trains([lm["attention"][n] for n in (
                "q_proj", "k_proj", "v_proj")]) or trains(
                lm["attention_layer_norm"]):
            attn.append(layer)
        if below or trains(lm):
            ffn.append(layer)
        below = below or trains(lm)
    return attn, ffn


def expected_large_generate_launches(steps, layers=(24, 12, 12)):
    """Launches of every kernel in one greedy generate() of the large pair:
    K1 in every speech and text-encoder layer, K9's passes in the pre-LN
    speech layers, K2 and K3's passes in the text encoder, K6 6, K4 twice
    per decoder layer and step."""
    speech, enc, dec = layers
    want = expected_launches("greedy", steps)
    want.update({"smx_attention_fwd": speech + enc,
                 "smx_dense_res_ln": enc,
                 "smx_conv_ln_gelu": FUSED_CONV_LAYERS,
                 "smx_decode_attention": 2 * dec * steps,
                 **ffn_forward_launches(enc, speech)})
    return want


def check_large_kernels(randn, dev, records):
    """The kernels of the large pair's path at its widths in bf16 (H = 1024,
    F = 4096, 16 heads of 64), each against its plain version at the limits
    stated for the flagship: K1 / K7 and K14 / K15 at B = 16 and T = 800
    (speech encoder), 400 (text encoder) and causal 64 (decoder), one row
    ragged; K9, K13 and K8 (its deterministic and dropout entries) at 12800
    rows (the pre-LN FFN); K2, K3, K11 and K12 at bart-large's 6400 and
    1024 rows; K4 with 16 heads over the 64-slot cache and 400 encoder
    positions.  (K6 in LayerNorm mode at C = 512 is check_conv's.)  Timed:
    K1, K14 and K15 at T = 800, K9, K13 and K8's dropout entries at 12800
    rows, K2 and K3 at 6400 rows."""
    import torch
    import torch.nn.functional as F
    from speechmix_tpu_torch.ops.kernels import attention as ka
    from speechmix_tpu_torch.ops.kernels import dropout as kd
    from speechmix_tpu_torch.ops.kernels import ffn as kf

    heads, d, scale, h, f = LARGE_HEADS, 64, 0.125, LARGE_H, LARGE_F
    bf16, rate = torch.bfloat16, DROP_RATE
    key = kd.DropoutKey.from_seed(20261017)
    log(f"the large pair's kernels: H={h}, F={f}, {heads} heads of {d}, "
        f"bf16, dropout rate {rate}")
    rule15 = K7_BF16_RULE + ", p^T as (p m)^T"
    for b, t, causal in ((LARGE_BATCH, 800, False), (LARGE_BATCH, 400, False),
                         (LARGE_BATCH, 64, True)):
        lens = torch.full((b,), t, device=dev)
        lens[1] = t - 37
        mask = torch.arange(t, device=dev)[None, :] < lens[:, None]
        q, k, v, g = (randn(b, t, heads * d, dtype=bf16) for _ in range(4))
        what = f"B={b} T={t} H={heads} D={d} bf16 causal={causal}"
        e1 = check_attention_fwd(f"K1 {what}", q, k, v, mask, heads, causal)
        out, lse = ka.attention_fwd(q, k, v, mask, heads, scale, causal,
                                    return_lse=True)
        ref = ka.attention_fwd_plain(q, k, v, mask, heads, scale, causal)
        got = ka.attention_bwd(q, k, v, mask, out, lse, g, heads, scale,
                               causal)
        refs = ka.attention_bwd_plain(q, k, v, mask, g, heads, scale, causal)
        torch.cuda.synchronize()
        limits = attention_bwd_bf16_limits(q, k, v, mask, ref, g, heads,
                                           scale, causal, refs)
        for n_, o, r, lim in zip(("dq", "dk", "dv"), got, refs, limits):
            compare(f"K7 {n_} {what}", o, r, lim, K7_BF16_RULE)
        del got, refs, limits
        dmask = kd.attention_mask_plain(key, b, heads, t, t, rate, dev)
        out_d, lse_d = ka.attention_dropout_fwd(
            q, k, v, mask, heads, scale, causal, key, rate, return_lse=True)
        ref_d = ka.attention_fwd_plain(q, k, v, mask, heads, scale, causal,
                                       dmask=dmask)
        torch.cuda.synchronize()
        e14 = compare(f"K14 {what}", out_d, ref_d, attention_bf16_limit(
            q, k, v, mask, heads, scale, causal, ref_d, dmask), K14_BF16_RULE)
        got = ka.attention_dropout_bwd(q, k, v, mask, out_d, lse_d, g, heads,
                                       scale, causal, key, rate)
        refs = ka.attention_bwd_plain(q, k, v, mask, g, heads, scale, causal,
                                      dmask=dmask)
        torch.cuda.synchronize()
        limits = attention_bwd_bf16_limits(q, k, v, mask, ref_d, g, heads,
                                           scale, causal, refs, dmask)
        e15 = max(compare(f"K15 {n_} {what}", o, r, lim, rule15)
                  for n_, o, r, lim in zip(("dq", "dk", "dv"), got, refs,
                                           limits))
        del got, refs, limits, dmask
        if t != 800:
            continue
        allowed = int(lens.sum()) * t
        flops, nbytes = 4.0 * heads * d * allowed, 4 * b * t * heads * d * 2
        qh, kh, vh = (x_.view(b, t, heads, d).transpose(1, 2).detach()
                      .requires_grad_() for x_ in (q, k, v))
        gh = g.view(b, t, heads, d).transpose(1, 2)
        sdpa = lambda p: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask[:, None, None, :], dropout_p=p,
            scale=scale)
        dmask_plain = lambda: kd.attention_mask_plain(key, b, heads, t, t,
                                                      rate, dev)
        shape = f"{what}, one row ragged (large pair)"
        records["attention_fwd (large, T=800)"] = dict(
            shape=shape, max_abs_err=e1,
            ms=cuda_ms(lambda: ka.attention_fwd(q, k, v, mask, heads, scale)),
            plain_ms=cuda_ms(lambda: ka.attention_fwd_plain(
                q, k, v, mask, heads, scale), iters=5),
            library_ms=cuda_ms(lambda: sdpa(0.0).detach()), flops=flops,
            bytes=nbytes + b * t)
        records["attention_dropout_fwd (large, T=800)"] = dict(
            shape=f"{shape}, rate {rate}", max_abs_err=e14,
            ms=cuda_ms(lambda: ka.attention_dropout_fwd(
                q, k, v, mask, heads, scale, False, key, rate)),
            plain_ms=cuda_ms(lambda: ka.attention_fwd_plain(
                q, k, v, mask, heads, scale, dmask=dmask_plain()), iters=5),
            library_ms=cuda_ms(lambda: sdpa(rate).detach()), flops=flops,
            bytes=nbytes + b * t)
        lib_out = sdpa(rate)
        records["attention_dropout_bwd (large, T=800)"] = dict(
            shape=f"{shape}, rate {rate}", max_abs_err=e15,
            ms=cuda_ms(lambda: ka.attention_dropout_bwd(
                q, k, v, mask, out_d, lse_d, g, heads, scale, False, key,
                rate)),
            plain_ms=cuda_ms(lambda: ka.attention_bwd_plain(
                q, k, v, mask, g, heads, scale, False, dmask=dmask_plain()),
                iters=5),
            library_ms=cuda_ms(lambda: torch.autograd.grad(
                lib_out, (qh, kh, vh), gh, retain_graph=True)),
            flops=2.5 * flops,
            bytes=2 * nbytes + b * heads * t * 4 + b * t)
        del lib_out

    n = 12800
    x, g = randn(n, h, dtype=bf16), randn(n, h, dtype=bf16)
    w1 = randn(h, f, scale=0.03, dtype=bf16)
    w2 = randn(f, h, scale=0.03, dtype=bf16)
    b1, b2 = randn(f, scale=0.1), randn(h, scale=0.1)
    what = f"N={n} H={h} F={f} gelu bf16"
    dw_rule = f"atol {K8_DW_BF16_TOL[0]}, rtol {K8_DW_BF16_TOL[1]}"
    k9 = lambda: kf.ffn_fused(x, w1, b1, w2, b2)
    e9 = compare(f"K9 {what}", k9(), kf.ffn_fused_plain(x, w1, b1, w2, b2))
    expect_equal(f"K9 {what}", (k9(),), (k9(),))
    got, refs = kf.ffn_bwd(x, g, w1, b1, w2), kf.ffn_bwd_plain(x, g, w1, b1,
                                                               w2)
    torch.cuda.synchronize()
    compare(f"K8 dx {what}", got[0], refs[0])
    for name_, o, r in zip(("dw1", "db1", "dw2"), got[1:4], refs[1:4]):
        compare(f"K8 {name_} {what}", o, r,
                K8_DW_BF16_TOL[0] + K8_DW_BF16_TOL[1] * r.abs(), dw_rule)
    del got, refs
    tol = _dropout_tol(TOL["bfloat16"], rate)
    dw_tol = _dropout_tol(K8_DW_BF16_TOL, rate)
    rule = f"atol {tol[0]:.4g}, rtol {tol[1]:.4g} (TOL / (1-r))"
    amask_plain = lambda: kd.dropout_mask_plain(key, kd.STREAM_ACT, n, f,
                                                rate, dev)
    amask = amask_plain()
    k13 = lambda: kf.ffn_dropout(x, w1, b1, w2, b2, key, rate)
    ref = kf.ffn_dropout_plain(x, w1, b1, w2, b2, amask)
    e13 = compare(f"K13 {what}", k13(), ref, tol[0] + tol[1] * ref.abs(),
                  rule)
    expect_equal(f"K13 {what}", (k13(),), (k13(),))
    k8d = lambda: kf.ffn_dropout_bwd(x, g, w1, b1, w2, key, rate)
    got, refs = k8d(), kf.ffn_bwd_plain(x, g, w1, b1, w2, "gelu", amask)
    torch.cuda.synchronize()
    e8 = compare(f"K8 dropout dx {what}", got[0], refs[0],
                 tol[0] + tol[1] * refs[0].float().abs(), rule)
    for name_, o, r in zip(("dw1", "db1", "dw2"), got[1:4], refs[1:4]):
        e8 = max(e8, compare(f"K8 dropout {name_} {what}", o, r,
                             dw_tol[0] + dw_tol[1] * r.abs(),
                             f"atol {dw_tol[0]:.4g}, rtol {dw_tol[1]:.4g}"))
    expect_equal(f"K8 dropout {what}", got, k8d())
    del got, refs, amask, ref
    w1t, w2t = w1.t(), w2.t()
    b1c, b2c = b1.to(bf16), b2.to(bf16)
    drop = lambda t_: F.dropout(t_, rate)
    lx = x.detach().requires_grad_()
    lw1, lw2 = (w_.t().contiguous().requires_grad_() for w_ in (w1, w2))
    lb1, lb2 = (b_.to(bf16).requires_grad_() for b_ in (b1, b2))
    lib_y = F.linear(drop(F.gelu(F.linear(lx, lw1, lb1))), lw2, lb2)
    ffn_flops, ffn_bytes = 4.0 * n * h * f, (2 * n * h + 2 * h * f) * 2
    shape = f"{what} (pre-LN FFN of the large pair)"
    records["ffn_fused (large, N=12800)"] = dict(
        shape=shape, max_abs_err=e9, ms=cuda_ms(k9),
        plain_ms=cuda_ms(lambda: kf.ffn_fused_plain(x, w1, b1, w2, b2)),
        library_ms=cuda_ms(lambda: F.linear(F.gelu(F.linear(x, w1t, b1c)),
                                            w2t, b2c)),
        flops=ffn_flops, bytes=ffn_bytes + (f + h) * 4)
    records["ffn_dropout (large, N=12800)"] = dict(
        shape=f"{shape}, rate {rate}", max_abs_err=e13, ms=cuda_ms(k13),
        plain_ms=cuda_ms(lambda: kf.ffn_dropout_plain(
            x, w1, b1, w2, b2, amask_plain()), iters=5),
        library_ms=cuda_ms(lambda: F.linear(drop(F.gelu(F.linear(
            x, w1t, b1c))), w2t, b2c)),
        flops=ffn_flops, bytes=ffn_bytes + (f + h) * 4)
    records["ffn_dropout_bwd (large, N=12800)"] = dict(
        shape=f"{shape}, rate {rate} (recompute + products)",
        max_abs_err=e8, ms=cuda_ms(k8d),
        plain_ms=cuda_ms(lambda: kf.ffn_bwd_plain(
            x, g, w1, b1, w2, "gelu", amask_plain()), iters=5),
        library_ms=cuda_ms(lambda: torch.autograd.grad(
            lib_y, (lx, lw1, lb1, lw2), g, retain_graph=True)),
        flops=2.5 * ffn_flops,
        bytes=(3 * n * h + 2 * h * f) * 2 + f * 4 + (2 * h * f + f) * 4)
    del lib_y

    for n in (6400, 1024):
        x, res = randn(n, h, dtype=bf16), randn(n, h, dtype=bf16)
        w = randn(h, h, scale=0.03, dtype=bf16)
        w1 = randn(h, f, scale=0.03, dtype=bf16)
        w2 = randn(f, h, scale=0.03, dtype=bf16)
        b1, b2, beta = randn(f, scale=0.1), randn(h, scale=0.1), \
            randn(h, scale=0.1)
        gamma = randn(h, scale=0.1) + 1.0
        what = f"N={n} H={h} F={f} bf16 (bart-large)"
        k2 = (x, w, b2, res, gamma, beta)
        k3 = (x, w1, b1, w2, b2, res, gamma, beta)
        out2 = kf.dense_res_ln(*k2)
        e2 = compare(f"K2 {what}", out2, kf.dense_res_ln_plain(*k2))
        compare(f"K2 {what} vs tiled", out2, kf.dense_res_ln_tiled_plain(*k2))
        expect_equal(f"K2 {what}", (out2,), (kf.dense_res_ln(*k2),))
        e3 = compare(f"K3 {what}", kf.ffn_res_ln(*k3),
                     kf.ffn_res_ln_plain(*k3))
        expect_equal(f"K3 {what}", (kf.ffn_res_ln(*k3),),
                     (kf.ffn_res_ln(*k3),))
        omask = kd.dropout_mask_plain(key, kd.STREAM_OUT, n, h, rate, dev)
        amask = kd.dropout_mask_plain(key, kd.STREAM_ACT, n, f, rate, dev)
        ref = kf.dense_dropout_res_ln_plain(*k2, omask)
        compare(f"K11 {what}", kf.dense_dropout_res_ln(*k2, key, rate), ref,
                tol[0] + tol[1] * ref.float().abs(), rule)
        ref = kf.ffn_dropout_res_ln_plain(*k3, amask, omask)
        compare(f"K12 {what}", kf.ffn_dropout_res_ln(*k3, key, rate, rate),
                ref, tol[0] + tol[1] * ref.float().abs(), rule)
        del omask, amask, ref
        if n != 6400:
            continue
        wt, w1t, w2t = w.t(), w1.t(), w2.t()
        b1c, b2c, gc, betac = (t_.to(bf16) for t_ in (b1, b2, gamma, beta))
        records["dense_res_ln (large, N=6400)"] = dict(
            shape=f"N={n} Din=H={h} bf16 (bart-large text encoder)",
            max_abs_err=e2, ms=cuda_ms(lambda: kf.dense_res_ln(*k2)),
            plain_ms=cuda_ms(lambda: kf.dense_res_ln_plain(*k2)),
            library_ms=cuda_ms(lambda: F.layer_norm(
                res + F.linear(x, wt, b2c), (h,), gc, betac, 1e-5)),
            flops=2.0 * n * h * h,
            bytes=(3 * n * h + h * h) * 2 + 3 * h * 4)
        records["ffn_res_ln (large, N=6400)"] = dict(
            shape=f"{what} gelu (text encoder)", max_abs_err=e3,
            ms=cuda_ms(lambda: kf.ffn_res_ln(*k3)),
            plain_ms=cuda_ms(lambda: kf.ffn_res_ln_plain(*k3)),
            library_ms=cuda_ms(lambda: F.layer_norm(
                res + F.linear(F.gelu(F.linear(x, w1t, b1c)), w2t, b2c),
                (h,), gc, betac, 1e-5)),
            flops=4.0 * n * h * f,
            bytes=(3 * n * h + 2 * h * f) * 2 + (f + 3 * h) * 4)

    for name, bkv, t in (("self greedy", LARGE_BATCH, 64),
                         ("cross greedy", LARGE_BATCH, 400)):
        mask = decode_mask(name, bkv, t, dev)
        q = randn(bkv, 1, heads, d, dtype=bf16)
        k, v = (randn(bkv, t, heads, d, dtype=bf16) for _ in range(2))
        check_decode_case(f"K4 {name} B={bkv} T={t} {heads} heads float K/V "
                          "bf16", q, k, v, mask, {})


# t5-small's FFN: relu, H = 512, F = 2048, no biases (zero vectors to the
# kernels), at the rows of its text encoder (B = 16 x 16 s: 6400), of its
# decoder in a train step (16 x 64 label positions: 1024) and a ragged count
T5_H, T5_F, T5_ROWS = 512, 2048, (6400, 1024, 4001)


def check_t5_kernels(randn, dev, records):
    """K9, K13 and K8 (its deterministic and dropout entries) at t5-small's
    FFN, relu, H = T5_H, F = T5_F, zero biases, in bf16 and f32 at the
    T5_ROWS row counts, each against its plain version (the masked ones fed
    the plain generator's mask of the same key) at the limits stated for
    the flagship (times 1/(1-r) with the mask; relu's jump at 0 as
    K8_RELU_NEAR_ZERO allows); in bf16 each twice, bit for bit.  Timed and
    recorded: K9, K13 and K8 at 6400 and 1024 rows in bf16, beside the
    library's linear(relu(linear)) and its autograd backward."""
    import torch
    import torch.nn.functional as F
    from speechmix_tpu_torch.ops.kernels import dropout as kd
    from speechmix_tpu_torch.ops.kernels import ffn as kf

    h, f, rate = T5_H, T5_F, DROP_RATE
    bf16, f32 = torch.bfloat16, torch.float32
    key = kd.DropoutKey.from_seed(20261018)
    log(f"t5-small's FFN kernels: relu, H={h}, F={f}, zero biases, rows "
        f"{T5_ROWS}, dropout rate {rate}")
    for dtype in (bf16, f32):
        for n in T5_ROWS:
            x, g = randn(n, h, dtype=dtype), randn(n, h, dtype=dtype)
            w1 = randn(h, f, scale=0.03, dtype=dtype)
            w2 = randn(f, h, scale=0.03, dtype=dtype)
            b1, b2 = torch.zeros(f, device=dev), torch.zeros(h, device=dev)
            what = f"N={n} H={h} F={f} relu {dtype}"
            a = x.float() @ w1.float()
            near = int((a.abs() < K8_RELU_NEAR_ZERO).sum())
            del a
            amask = kd.dropout_mask_plain(key, kd.STREAM_ACT, n, f, rate, dev)
            k9 = lambda: kf.ffn_fused(x, w1, b1, w2, b2, "relu")
            k13 = lambda: kf.ffn_dropout(x, w1, b1, w2, b2, key, rate, "relu")
            k8 = lambda: kf.ffn_bwd(x, g, w1, b1, w2, "relu")
            k8d = lambda: kf.ffn_dropout_bwd(x, g, w1, b1, w2, key, rate,
                                             "relu")
            errs = {"K9": compare(f"K9 {what}", k9(), kf.ffn_fused_plain(
                x, w1, b1, w2, b2, "relu"))}
            ref = kf.ffn_dropout_plain(x, w1, b1, w2, b2, amask, "relu")
            tol = _dropout_tol(TOL[str(dtype).replace("torch.", "")], rate)
            errs["K13"] = compare(f"K13 {what}", k13(), ref,
                                  tol[0] + tol[1] * ref.float().abs(),
                                  f"atol {tol[0]:.4g}, rtol {tol[1]:.4g} "
                                  "(TOL / (1-r))")
            base_dw = K8_DW_BF16_TOL if dtype == bf16 else K8_DW_F32_TOL
            for label, run, m, scale in (("K8", k8, None, 1.0),
                                         ("K8 dropout", k8d, amask,
                                          1.0 / (1.0 - rate))):
                got = run()
                refs = kf.ffn_bwd_plain(x, g, w1, b1, w2, "relu", m)
                torch.cuda.synchronize()
                atol, rtol = (t_ * scale for t_ in TOL[
                    str(dtype).replace("torch.", "")])
                err = compare(f"{label} dx {what}", got[0], refs[0],
                              atol + rtol * refs[0].float().abs(),
                              f"atol {atol:.4g}, rtol {rtol:.4g}",
                              allow_count=near * h)
                dw_tol = tuple(t_ * scale for t_ in base_dw)
                for name_, o, r, count in zip(("dw1", "db1", "dw2"),
                                              got[1:4], refs[1:4],
                                              (h, 1, 0)):
                    err = max(err, compare(
                        f"{label} {name_} {what}", o, r,
                        dw_tol[0] + dw_tol[1] * r.abs(),
                        f"atol {dw_tol[0]:.4g}, rtol {dw_tol[1]:.4g}",
                        near * count))
                errs[label] = err
                if dtype == bf16:
                    expect_equal(f"{label} {what}", got, run())
                del got, refs
            if dtype == bf16:
                expect_equal(f"K9 {what}", (k9(),), (k9(),))
                expect_equal(f"K13 {what}", (k13(),), (k13(),))
            if dtype != bf16 or n == 4001:
                continue
            lx = x.detach().requires_grad_()
            lw1, lw2 = (w_.t().contiguous().requires_grad_() for w_ in (w1, w2))
            lib = lambda: F.linear(F.relu(F.linear(lx, lw1)), lw2)
            lib_y = lib()
            shape = f"{what} (t5-small FFN, zero biases)"
            ffn_flops = 4.0 * n * h * f
            ffn_bytes = (2 * n * h + 2 * h * f) * 2 + (f + h) * 4
            records[f"ffn_fused (t5-small, N={n})"] = dict(
                shape=shape, rows=n, max_abs_err=errs["K9"], ms=cuda_ms(k9),
                plain_ms=cuda_ms(lambda: kf.ffn_fused_plain(
                    x, w1, b1, w2, b2, "relu")),
                library_ms=cuda_ms(lambda: lib().detach()),
                flops=ffn_flops, bytes=ffn_bytes)
            records[f"ffn_dropout (t5-small, N={n})"] = dict(
                shape=f"{shape}, rate {rate}", rows=n,
                max_abs_err=errs["K13"], ms=cuda_ms(k13),
                plain_ms=cuda_ms(lambda: kf.ffn_dropout_plain(
                    x, w1, b1, w2, b2, kd.dropout_mask_plain(
                        key, kd.STREAM_ACT, n, f, rate, dev), "relu"),
                    iters=5),
                library_ms=cuda_ms(lambda: F.linear(F.dropout(F.relu(
                    F.linear(lx, lw1)), rate), lw2).detach()),
                flops=ffn_flops, bytes=ffn_bytes)
            records[f"ffn_bwd (t5-small, N={n})"] = dict(
                shape=f"{shape} (recompute + products)", rows=n,
                max_abs_err=errs["K8"], ms=cuda_ms(k8),
                plain_ms=cuda_ms(lambda: kf.ffn_bwd_plain(
                    x, g, w1, b1, w2, "relu")),
                library_ms=cuda_ms(lambda: torch.autograd.grad(
                    lib_y, (lx, lw1, lw2), g, retain_graph=True)),
                flops=10.0 * n * h * f,
                bytes=(3 * n * h + 2 * h * f) * 2 + f * 4 +
                (2 * h * f + f) * 4)
            del lib_y
    expect_refusal(f"K8 N=1000 H=192 bf16 (not a multiple of "
                   f"{kf.FWD_WIDTH})", lambda: kf.ffn_bwd(
                       randn(1000, 192, dtype=bf16),
                       randn(1000, 192, dtype=bf16),
                       randn(192, 768, dtype=bf16), randn(768),
                       randn(768, 192, dtype=bf16)))


def check_t5_decode(randn, gen, dev, records):
    """K4 and K5 at the T5 pairs' decoder shapes.  K4: the cross-attention
    steps, 16 rows over 400 encoder positions with kb = 1 (greedy) and
    kb = 4 (beams share K/V), t5-small's 8 heads and byt5-small's 6, at
    T5's attention scale 1.0 (unscaled scores, so larger logits than the
    flagship's), float and int8 K/V, bf16 and f32, each against its plain
    version (bf16: decode_bf16_limit, the split body, twice bit for bit);
    T5's self-attention steps carry the position bias and take the plain
    path.  K5: each pair's beam-4 self-attention cache (decoder layers, 64
    rows, 64 slots, heads, 64), bit-exact.  The bf16 cases that run_t5
    drives are recorded."""
    import torch
    from speechmix_tpu_torch import config
    from speechmix_tpu_torch.models.seq2seq import _quantize_kv

    log("K4 and K5 at the T5 pairs' decoder shapes")
    for model in T5_MODES:
        dec = config.SEQ2SEQ_PRESETS[model]
        heads, d, layers = dec.num_heads, dec.per_head_dim, dec.decoder_layers
        for name, bkv, kb, t in DECODE_SHAPES[2:4]:
            mask = decode_mask(name, bkv, t, dev)
            for dtype in (torch.bfloat16, torch.float32):
                q = randn(bkv * kb, 1, heads, d, dtype=dtype)
                k, v = (randn(bkv, t, heads, d, dtype=dtype)
                        for _ in range(2))
                (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
                for kind, kk, vv, scales in (("float", k, v, {}),
                                             ("int8", kq, vq,
                                              dict(k_scale=ks, v_scale=vs))):
                    err = check_decode_case(
                        f"{model} {name} B={bkv} kb={kb} T={t} {heads} "
                        f"heads scale 1.0 {kind} K/V {dtype}", q, kk, vv,
                        mask, scales, scale=1.0)
                    # recorded: the bf16 cases that run_t5 drives (int8
                    # cross K/V in t5-small's greedy-int8 only)
                    if dtype != torch.bfloat16 or kind == "int8" and (
                            model != "t5-small" or kb != 1):
                        continue
                    entry = ("decode_attention" if kind == "float"
                             else "decode_attention_q8")
                    records[f"{entry} ({model}, {name})"] = decode_record(
                        f"{model} {name}", kind, q, kk, vv, mask, scales,
                        err, 1.0, layers)
        args = beam_gather_case(randn, gen, dev, layers, heads)
        records[f"beam_gather ({model})"] = beam_gather_record(*args)


def _fingerprints(params):
    """{path: the int64 sum of the leaf's bits}: a leaf that moved changes
    it."""
    import torch
    from speechmix_tpu_torch.training.freezing import tree_paths
    return {path: int(p.view(torch.int32).sum(dtype=torch.int64))
            for path, p in tree_paths(params)}


def _profile_step(fn, what):
    """One call of fn under the profiler: (wall ms, busy ms, events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = device_totals(prof)
    busy_us = sum(e.self_device_time_total for e in events)
    log(f"  profiled {what}: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms ({busy_us / wall_us:.3f} of wall)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:14]:
        log(f"    {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  "
            f"{e.key[:90]}")
    return wall_us / 1e3, busy_us / 1e3, events


def run_large_pair(seed, card):
    """The large pair at full width and depth, random bf16 weights from the
    seed, B = LARGE_BATCH x 16 s: greedy generate (launch counts, tokens),
    then TrainConfig(bf16=True, freeze_epochs=2) train steps (Adafactor,
    dropout on, tensor-granularity unfreezing) at progress 0, 0.5 and 1.0:
    a finite, falling loss, the leaves the progress freezes bit-unchanged,
    the released ones moved, exact launch counts.  Returns the launch counts
    of a generate() and of the last step."""
    import torch
    from speechmix_tpu_torch import generation
    from speechmix_tpu_torch.models import speech_encoder, speechmix
    from speechmix_tpu_torch.ops import kernels
    from speechmix_tpu_torch.training import freezing, trainer

    cfg = large_config()
    enc, dec = cfg.encoder, cfg.decoder
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    b = LARGE_BATCH
    batch = _train_batch(cfg, gen, dev, b, SECONDS, TRAIN_LABELS)
    wav, lengths = batch["input_values"], batch["lengths"]
    params = speechmix.init_speechmix(cfg, gen, dev, torch.bfloat16)
    n_params = sum(p.numel() for _, p in freezing.tree_paths(params))
    log(f"large pair {enc.name} ({enc.num_layers} pre-LN layers, H="
        f"{enc.hidden_size}) + {dec.name} ({dec.encoder_layers} + "
        f"{dec.decoder_layers} layers, vocabulary {dec.vocab_size}), "
        f"{n_params / 1e6:.1f} M parameters, bf16, B={b} x {SECONDS} s, "
        f"max_length {MAX_LEN}")
    want = expected_large_generate_launches(
        MAX_LEN, (enc.num_layers, dec.encoder_layers, dec.decoder_layers))
    times = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(4):
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens, lens = generation.generate(params, cfg, wav, lengths,
                                           max_length=MAX_LEN,
                                           dtype=torch.bfloat16)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        gen_counts = {k.symbol: k.launches for k in kernels.kernels()}
        log(f"  large greedy generate call {i}: {dt * 1e3:.1f} ms")
        if gen_counts != want:
            raise AssertionError(f"large greedy: launches {gen_counts}, "
                                 f"expected {want}")
        if i:
            times.append(dt)
    if (tokens.shape != (b, MAX_LEN) or (lens < 0).any()
            or not ((tokens >= 0) & (tokens < dec.vocab_size)).all()):
        raise AssertionError(f"large greedy: bad tokens {tuple(tokens.shape)}")
    log(f"  large greedy launches {gen_counts}")
    med = sorted(times)[len(times) // 2]
    log(f"  large greedy: {med * 1e3:.1f} ms per call (median of "
        f"{len(times)}; all: {', '.join(f'{t * 1e3:.1f}' for t in times)}), "
        f"audio-seconds per second transcribed {b * SECONDS / med:.2f}, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
        f"on {card}")
    _profile_step(lambda: generation.generate(
        params, cfg, wav, lengths, max_length=MAX_LEN,
        dtype=torch.bfloat16), "large greedy generate")
    del params

    tc = trainer.TrainConfig(learning_rate=TRAIN_LR, warmup_steps=1,
                             bf16=True, freeze_epochs=LARGE_FREEZE_EPOCHS,
                             seed=seed)
    if not (tc.optimizer == "adafactor" and tc.dropout
            and tc.unfreeze_granularity == "tensor"):
        raise AssertionError(f"TrainConfig defaults changed: {tc}")
    state = trainer.create_train_state(gen, cfg, tc)
    step_fn = trainer.make_train_step(cfg, tc, state.params)
    log(f"large pair training: {n_params / 1e6:.1f} M float32 parameters, "
        f"bf16 compute, Adafactor lr {TRAIN_LR}, warmup 1, dropout on, "
        f"SpecAugment, LayerDrop {enc.layerdrop}, freeze_epochs "
        f"{LARGE_FREEZE_EPOCHS} (tensor granularity), progress "
        f"{list(LARGE_PROGRESS)}, B={b} x {SECONDS} s, {TRAIN_LABELS} label "
        f"positions")
    torch.cuda.empty_cache()
    losses, full, peaks = [], [], []
    for i, progress in enumerate(LARGE_PROGRESS):
        mask = freezing.reference_unfreeze_scale(
            state.params, freezing.unfreeze_epoch(progress,
                                                  LARGE_FREEZE_EPOCHS),
            LARGE_FREEZE_EPOCHS)
        frozen = {path for path, m in freezing.tree_paths(mask) if m == 0}
        skipped = layerdrop_replay(trainer, speech_encoder, tc, cfg,
                                   state.step)
        kept = [l for l in range(enc.num_layers) if l not in skipped]
        attn_bwd, ffn_bwd = speech_backward_layers(mask["speech_encoder"],
                                                   kept)
        want = expected_preln_train_launches(
            len(kept), len(attn_bwd), len(ffn_bwd), dec.encoder_layers,
            dec.decoder_layers, dropout=True)
        want.update(conv_backward_launches(mask["speech_encoder"]))
        held = {path: p.clone() for path, p in
                freezing.tree_paths(state.params) if path in frozen}
        prints = _fingerprints(state.params)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch, progress)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {k.symbol: k.launches for k in kernels.kernels()}
        loss, norm = metrics["loss"].item(), metrics["grad_norm"].item()
        now = dict(freezing.tree_paths(state.params))
        changed = [path for path, p in held.items()
                   if not torch.equal(now[path], p)]
        after = _fingerprints(state.params)
        moved = {path for path in prints if after[path] != prints[path]}
        released = set(prints) - frozen
        # a released leaf of a layer LayerDrop kept has a gradient
        must = {path for path in released
                if path.startswith("speech_encoder/layers/")
                and int(path.split("/")[2]) in kept}
        log(f"  step {i + 1} (progress {progress}): loss {loss:.4f}, "
            f"grad_norm {norm:.4f}, {dt * 1e3:.1f} ms, {len(frozen)} leaves "
            f"frozen, {len(moved)} of {len(released)} released leaves moved,"
            f" LayerDrop skipped {skipped}, attention / FFN backward in "
            f"{len(attn_bwd)} / {len(ffn_bwd)} speech layers")
        del held
        if changed:
            raise AssertionError(f"large step {i + 1}: frozen leaves moved: "
                                 f"{changed[:5]}")
        if moved & frozen:
            raise AssertionError("large step: a frozen leaf moved")
        if i and must - moved:
            raise AssertionError(f"large step {i + 1}: released leaves did "
                                 f"not move: {sorted(must - moved)[:5]}")
        if metrics["layers_skipped"] != [skipped]:
            raise AssertionError(f"large step {i + 1}: LayerDrop skipped "
                                 f"{metrics['layers_skipped']}, the key "
                                 f"chain gives {skipped}")
        if counts != want:
            raise AssertionError(f"large step {i + 1}: launches {counts}, "
                                 f"expected {want}")
        if not (math.isfinite(loss) and math.isfinite(norm)):
            raise AssertionError(f"large step {i + 1}: loss {loss}, "
                                 f"grad_norm {norm}")
        losses.append(loss)
        if i and not frozen:   # no copies of frozen leaves held
            full.append(dt)
            peaks.append(torch.cuda.max_memory_allocated())
    log(f"  launches of the last step: {counts}")
    if not losses[-1] < losses[1]:
        raise AssertionError(f"large pair: the loss did not fall: {losses}")
    med = sorted(full)[len(full) // 2]
    peak = max(peaks)
    log(f"  large train step (all leaves training): {med * 1e3:.1f} ms "
        f"(median of {len(full)}: {', '.join(f'{t * 1e3:.1f}' for t in full)}"
        f"), audio-seconds per second trained {b * SECONDS / med:.2f}, peak "
        f"memory {peak / 2 ** 30:.2f} GiB, loss {losses[1]:.4f} -> "
        f"{losses[-1]:.4f} on {card}")
    _, busy, events = _profile_step(
        lambda: step_fn(state, batch, 1.0), "large train step (progress 1.0)")
    conv_bwd = [e for e in events if "dgrad" in e.key.lower()
                or "wgrad" in e.key.lower()]
    conv_ms = sum(e.self_device_time_total for e in conv_bwd) / 1e3
    log(f"  cuDNN conv backward (dgrad / wgrad kernels) in the profiled "
        f"large train step: {conv_ms:.2f} ms of {busy:.1f} ms busy "
        f"({conv_ms / busy:.3f}): " + ", ".join(
            f"{e.key[:60]} {e.self_device_time_total / 1e3:.2f} ms "
            f"{e.count}x" for e in conv_bwd))
    return gen_counts, counts


def run_variants(seed, card):
    """adapter, self and gan at the flagship's width and depth (wav2vec2-base
    + bart-base, bf16 compute, B = 16 x 16 s), Adafactor with dropout on:
    adapter's greedy generate (the flagship's launch counts) and
    VARIANT_STEPS steps of each; self's batch carries text_input_ids; gan
    with des_update GAN_DES_UPDATE, its discriminator bit-unchanged in the
    generator's steps and everything else in the discriminator's.  Returns
    {mode: launch counts of the last call}."""
    import torch
    from speechmix_tpu_torch import generation
    from speechmix_tpu_torch.ops import kernels
    from speechmix_tpu_torch.training import freezing, trainer

    dev = torch.device("cuda")
    out = {}
    for variant in ("adapter", "self", "gan"):
        cfg = flagship_config(variant)
        gen = torch.Generator(device=dev).manual_seed(seed)
        batch = _train_batch(cfg, gen, dev, BATCH, SECONDS, TRAIN_LABELS)
        if variant in ("self", "gan"):
            text = torch.randint(3, cfg.decoder.vocab_size,
                                 (BATCH, TRAIN_LABELS), generator=gen,
                                 device=dev)
            text[1, TRAIN_LABELS - 9:] = cfg.decoder.pad_token_id
            batch["text_input_ids"] = text
        tc = trainer.TrainConfig(learning_rate=TRAIN_LR, warmup_steps=1,
                                 bf16=True, seed=seed)
        state = trainer.create_train_state(gen, cfg, tc)
        if variant == "adapter":
            serve = _cast_tree(state.params, torch.bfloat16)
            want = expected_launches("greedy", MAX_LEN)
            times = []
            for i in range(3):
                kernels.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tokens, _ = generation.generate(
                    serve, cfg, batch["input_values"], batch["lengths"],
                    max_length=MAX_LEN, dtype=torch.bfloat16)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                counts = {k.symbol: k.launches for k in kernels.kernels()}
                if counts != want:
                    raise AssertionError(f"adapter greedy: launches {counts}"
                                         f", expected {want}")
            if tokens.shape != (BATCH, MAX_LEN):
                raise AssertionError("adapter greedy: bad tokens")
            out["adapter-greedy"] = counts
            log(f"  adapter greedy generate: "
                f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms per call, "
                f"the flagship's launch counts, on {card}")
            del serve
        step_fn = trainer.make_train_step(cfg, tc, state.params)
        log(f"variant {variant}: Adafactor lr {TRAIN_LR}, dropout on, "
            f"{VARIANT_STEPS} steps, B={BATCH} x {SECONDS} s" +
            (f", des_update {GAN_DES_UPDATE}" if variant == "gan" else ""))
        times = {}
        for i in range(VARIANT_STEPS):
            disc_step = (state.step // GAN_DES_UPDATE) % 2 == 1
            held = ({path: p.clone() for path, p in
                     freezing.tree_paths(state.params)}
                    if variant == "gan" else {})
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = {k.symbol: k.launches for k in kernels.kernels()}
            terms = {name: v.item() for name, v in metrics.items()
                     if name.endswith("loss")}
            if not all(math.isfinite(v) for v in terms.values()):
                raise AssertionError(f"{variant} step {i + 1}: {terms}")
            log(f"  {variant} step {i + 1}" +
                (f" ({'discriminator' if disc_step else 'generator'})"
                 if variant == "gan" else "") +
                f": {dt * 1e3:.1f} ms, " +
                ", ".join(f"{k} {v:.4f}" for k, v in terms.items()) +
                f", grad_norm {metrics['grad_norm'].item():.4f}, K1 / K14 "
                f"launches {counts['smx_attention_fwd']} / "
                f"{counts['smx_attention_dropout_fwd']}")
            now = dict(freezing.tree_paths(state.params))
            for path, p in held.items():
                stays = (path.startswith("nlp") or
                         path.startswith("discriminator") != disc_step)
                if stays and not torch.equal(now[path], p):
                    raise AssertionError(f"gan step {i + 1}: {path} moved")
            if held and i:   # the first update has rate 0
                trained = ("discriminator/kernel" if disc_step
                           else "enc_to_dec_proj/kernel")
                if torch.equal(now[trained], held[trained]):
                    raise AssertionError(f"gan step {i + 1}: {trained} did "
                                         "not move")
            del held, now
            if i:   # the first step compiles and warms up
                kind = ("discriminator" if disc_step else "generator"
                        ) if variant == "gan" else "train"
                times.setdefault(kind, []).append(dt)
        for kind, ts in times.items():
            med = sorted(ts)[len(ts) // 2]
            log(f"  {variant} {kind} step: {med * 1e3:.1f} ms (median of "
                f"{len(ts)}; all: {', '.join(f'{t * 1e3:.1f}' for t in ts)})"
                f", audio-seconds per second trained "
                f"{BATCH * SECONDS / med:.2f} on {card}")
        out[f"{variant}-train"] = counts
    return out


# ---------------------------------------------------------------------------
# the loop around the step: Trainer.fit, eval, predict, checkpoints, teacher
# ---------------------------------------------------------------------------

# words per utterance of the four groups of 16 training utterances: an
# utterance of k words lasts 0.5 + 0.35 k s, so each group fills one of the
# 4, 8, 12 and 16 s buckets; the 16 eval utterances fill the 8 s bucket
TRAINER_WORDS = ((5, 10), (11, 21), (22, 32), (33, 44))
TRAINER_EVAL_WORDS = (11, 21)
TRAINER_EPOCHS, TRAINER_FREEZE_EPOCHS, TRAINER_EVAL_STEPS = 2, 2, 4
# the step of the resumed fit whose wall interval (its entry to the next
# step's) is profiled: the 16 s batch after the step that is compared bit
# for bit
TRAINER_PROFILED_STEP = 11
TEACHER_SENTENCES, TEACHER_MAX_LEN = 16, 64


def expected_postln_dropout_launches(kept, attn_bwd, dense_bwd, ffn_bwd,
                                     enc_layers, dec_layers):
    """Launches of every kernel in one micro-batch of a train step with
    dropout on, of a post-LN speech encoder whose layers may be frozen: a
    kept layer runs K14, K11 and K12 forward; K15 where its attention's
    backward runs (attn_bwd layers), K11's backward (K10 regenerating its
    output mask) where dense_bwd, and K12's backward (K13 recomputing the
    FFN, K10 the output mask, K8 with the activation mask) where ffn_bwd.
    The BART layers all run theirs.  With every layer training this is
    expected_dropout_train_launches(kept, enc_layers, dec_layers)."""
    nlp = enc_layers + dec_layers
    want = expected_train_launches(0, 0, 0)
    want.update({
        "smx_attention_dropout_fwd": kept + nlp,
        "smx_attention_dropout_bwd": attn_bwd + nlp,
        "smx_dense_dropout_res_ln": kept + nlp + dec_layers,
        **ffn_forward_launches(kept + nlp, ffn_bwd + nlp, dropout=True),
        **dict.fromkeys(K8_DROPOUT_ENTRIES["bf16"], ffn_bwd + nlp),
        "smx_dropout_mask": (4 + dec_layers + (dense_bwd + nlp + dec_layers)
                             + (ffn_bwd + nlp))})
    return want


def conv_backward_launches(enc_mask):
    """K6's backward launches under the speech encoder's mask: each of
    CONV_BWD once a fused layer where a leaf of the extractor trains (the
    stack's own, or layer 0's below it, whose gradient needs the stack's
    dx), none where the whole extractor is frozen."""
    from speechmix_tpu_torch.training.freezing import tree_paths
    trains = any(m > 0 for _, m in tree_paths(enc_mask["feature_extractor"]))
    return dict.fromkeys(CONV_BWD, FUSED_CONV_LAYERS if trains else 0)


def postln_backward_layers(enc_mask, kept):
    """The kept post-LN layers whose backward pieces run under the speech
    encoder's mask `enc_mask`: the attention's (K15) where its input needs
    a gradient (something below trains; below the layers are the
    extractor, the feature projection, the positional conv, the encoder
    LayerNorm and masked_spec_embed) or its q / k / v projections train;
    the out-projection epilogue's (K11) where that holds or its
    out-projection or LayerNorm trains; the FFN block's (K12) where that
    holds or the FFN or its LayerNorm trains."""
    from speechmix_tpu_torch.training.freezing import tree_paths
    trains = lambda tree: any(m > 0 for _, m in tree_paths(tree))
    below = trains({k: v for k, v in enc_mask.items() if k != "layers"})
    attn, dense, ffn = [], [], []
    for layer in kept:
        lm = enc_mask["layers"][layer]
        a = below or trains([lm["attention"][n] for n in (
            "q_proj", "k_proj", "v_proj")])
        d = a or trains(lm["attention"]["out_proj"]) or trains(
            lm["attention_layer_norm"])
        f = d or trains([lm[n] for n in ("ffn_in", "ffn_out",
                                         "final_layer_norm")])
        for hit, out in ((a, attn), (d, dense), (f, ffn)):
            if hit:
                out.append(layer)
        below = f
    return attn, dense, ffn


def expected_eval_launches(speech_layers, enc_layers, dec_layers):
    """The eval step: the train step's forward with dropout off and no
    backward (no K7, K8, K9 recomputing the FFN, nor K6's backward)."""
    layers = speech_layers + enc_layers + dec_layers
    want = expected_train_launches(speech_layers, enc_layers, dec_layers)
    want.update({"smx_attention_bwd": 0, **dict.fromkeys(K8_ALL, 0),
                 **dict.fromkeys(CONV_BWD, 0),
                 **ffn_forward_launches(layers, 0)})
    return want


def _state_prints(state):
    """Fingerprints of the parameters and of the optimizer's tensors."""
    import torch
    from speechmix_tpu_torch.training.freezing import tree_paths
    out = {f"params/{k}": v for k, v in _fingerprints(state.params).items()}
    for path, t in tree_paths(state.opt_state):
        if isinstance(t, torch.Tensor):
            out[f"opt_state/{path}"] = int(
                t.view(torch.int32).sum(dtype=torch.int64))
    return out


def _trainer_corpus(seed, datasets, model):
    """The training examples (64, four buckets) and the eval examples (16,
    the 8 s bucket): synthetic audio, byte-tokenized transcripts."""
    raw = []
    for g, (lo, hi) in enumerate(TRAINER_WORDS):
        raw += datasets.synthetic_corpus(16, seed=seed * 8 + g, min_sec=1.0,
                                         max_sec=16.0, min_words=lo,
                                         max_words=hi)
    eval_raw = datasets.synthetic_corpus(
        16, seed=seed * 8 + 4, min_sec=1.0, max_sec=16.0,
        min_words=TRAINER_EVAL_WORDS[0], max_words=TRAINER_EVAL_WORDS[1])
    return (datasets.prepare_examples(raw, model, use_teacher_targets=False),
            datasets.prepare_examples(eval_raw, model,
                                      use_teacher_targets=False))


def run_trainer(seed, card):
    """The flagship (bf16 compute, f32 master weights) through the port's
    Trainer with the default recipe (Adafactor, dropout on, tensor
    granularity unfreezing with freeze_epochs 2) for 2 epochs of 4 steps:
    the synthetic corpus through BucketBatcher at B = 16 over the 4-16 s
    buckets, the prefetcher, JSONL logging, eval + greedy predict every 4
    steps, npz checkpoints (keep 2) in a temporary directory; then a second
    Trainer resumes the directory for one step and loads the best step; then
    the teacher on 16 sentences with bart-base in f32.  Checks (a)-(g) of
    the phase; prints the loop's numbers."""
    import dataclasses
    import tempfile
    import types
    import torch
    from speechmix_tpu_torch.data import collator, datasets, teacher
    from speechmix_tpu_torch.data.tokenizer import ByteTokenizer
    from speechmix_tpu_torch.models import seq2seq, speech_encoder
    from speechmix_tpu_torch.ops import kernels
    from speechmix_tpu_torch.ops.layers import FUSED_MIN_ROWS
    from speechmix_tpu_torch.training import freezing, trainer

    cfg = flagship_config()
    enc, dec = cfg.encoder, cfg.decoder
    dev = torch.device("cuda")
    tok = ByteTokenizer(pad_token_id=dec.pad_token_id,
                        eos_token_id=dec.eos_token_id,
                        bos_token_id=dec.bos_token_id)
    model = types.SimpleNamespace(config=cfg, tokenizer=tok, params=None)
    train_ex, eval_ex = _trainer_corpus(seed, datasets, model)
    ccfg = collator.CollatorConfig(
        pad_token_id=dec.pad_token_id, bos_token_id=tok.bos_token_id,
        eos_token_id=dec.eos_token_id, max_label_length=dec.max_length,
        max_text_length=dec.max_length, align_samples=enc.aligned_samples)

    def train_batches_factory():
        batcher = collator.BucketBatcher(ccfg, BATCH, shuffle_seed=seed)
        return lambda: batcher(train_ex)
    eval_batcher = collator.BucketBatcher(ccfg, BATCH)
    eval_batches = lambda: eval_batcher(eval_ex)
    audio_s = sum(len(ex["input_values"]) for ex in train_ex) / 16000
    steps_per_epoch = len(list(train_batches_factory()()))
    if steps_per_epoch != 4:
        raise AssertionError(f"trainer: {steps_per_epoch} batches per epoch, "
                             "expected 4")

    out_dir = tempfile.mkdtemp(prefix="smx_trainer_")
    tc = trainer.TrainConfig(
        learning_rate=TRAIN_LR, warmup_steps=1, bf16=True,
        freeze_epochs=TRAINER_FREEZE_EPOCHS, num_epochs=TRAINER_EPOCHS,
        eval_steps=TRAINER_EVAL_STEPS, logging_steps=1,
        predict_with_generate=True, save_total_limit=2, prefetch_depth=2,
        output_dir=out_dir, seed=seed)
    if not (tc.optimizer == "adafactor" and tc.dropout
            and tc.unfreeze_granularity == "tensor"):
        raise AssertionError(f"TrainConfig defaults changed: {tc}")
    log(f"trainer: flagship, bf16 compute, f32 master weights, Adafactor lr "
        f"{TRAIN_LR}, dropout on, freeze_epochs {TRAINER_FREEZE_EPOCHS} "
        f"(tensor), {TRAINER_EPOCHS} epochs of {steps_per_epoch} steps at "
        f"B={BATCH} (synthetic corpus, {len(train_ex)} utterances, "
        f"{audio_s:.1f} audio-s, buckets 4-16 s; eval {len(eval_ex)} "
        f"utterances), eval + greedy predict every {TRAINER_EVAL_STEPS} "
        f"steps, save_total_limit {tc.save_total_limit}, prefetch depth "
        f"{tc.prefetch_depth}, output_dir {out_dir}")

    symbols = lambda: {k.symbol: k.launches for k in kernels.kernels()}
    steps, evals, predicts, saves = [], [], [], []
    profiled, capture = {}, {}
    orig_make = trainer.make_train_step

    def instrumented_make(*a, **kw):
        step_fn = orig_make(*a, **kw)

        def wrapped(state, batch, progress=0.0):
            entry = time.perf_counter()
            if "prof" in profiled:   # the profiled window ends here
                torch.cuda.synchronize()
                profiled["wall_ms"] = (time.perf_counter()
                                       - profiled["t0"]) * 1e3
                prof = profiled.pop("prof")
                prof.stop()
                profiled["events"] = device_totals(prof)
            if state.step + 1 == TRAINER_PROFILED_STEP:
                from torch.profiler import ProfilerActivity, profile
                prof = profile(activities=[ProfilerActivity.CUDA])
                torch.cuda.synchronize()
                prof.start()
                profiled.update(prof=prof, t0=time.perf_counter())
            kernels.reset_launch_counts()
            before = state.step
            state, metrics = step_fn(state, batch, progress)
            if capture.get("on") and "prints" not in capture:
                torch.cuda.synchronize()
                capture["prints"] = _state_prints(state)
                torch.backends.cudnn.deterministic = False
            steps.append(dict(step=before, progress=progress, entry=entry,
                              counts=symbols(), batch=batch,
                              samples=batch["input_values"].shape[1],
                              labels=batch["labels"].shape[1],
                              loss=metrics["loss"],
                              skipped=metrics["layers_skipped"]))
            return state, metrics
        return wrapped

    class TimedTrainer(trainer.Trainer):
        def evaluate(self, *a, **kw):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            out = super().evaluate(*a, **kw)
            torch.cuda.synchronize()
            evals.append((time.perf_counter() - t0, symbols()))
            return out

        def predict(self, *a, **kw):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            out = super().predict(*a, **kw)
            torch.cuda.synchronize()
            predicts.append((time.perf_counter() - t0, symbols(), out))
            return out

    def timed_saves(tr):
        orig = tr.ckpt.save

        def save(step, state, metrics=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = orig(step, state, metrics)
            saves.append(dict(step=step, s=time.perf_counter() - t0,
                              bytes=os.path.getsize(path),
                              prints=_state_prints(state)))
            return path
        tr.ckpt.save = save

    gen = torch.Generator(device=dev).manual_seed(seed)
    trainer.make_train_step = instrumented_make
    try:
        tr = TimedTrainer(cfg, tc, tokenizer=tok)
        timed_saves(tr)
        state = tr.init_state(gen)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t_fit = time.perf_counter()
        state = tr.fit(state, train_batches_factory(), eval_batches)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t_fit
        peak = torch.cuda.max_memory_allocated()
        fit_steps = list(steps)

        # (a) every step: a finite loss, the launches of its LayerDrop
        # draw, unfreezing mask and rows under the fused gate
        for rec in fit_steps:
            frames = int(enc.feature_lengths(rec["samples"]))
            rows = {"speech": BATCH * frames,
                    "text encoder": BATCH * (frames // cfg.down_scale),
                    "decoder": BATCH * rec["labels"]}
            if min(rows.values()) < FUSED_MIN_ROWS:
                raise AssertionError(f"trainer step {rec['step'] + 1}: rows "
                                     f"{rows} below the fused gate")
            skipped = layerdrop_replay(trainer, speech_encoder, tc, cfg,
                                       rec["step"])
            kept = [l for l in range(enc.num_layers) if l not in skipped]
            mask = freezing.reference_unfreeze_scale(
                state.params, freezing.unfreeze_epoch(
                    rec["progress"], TRAINER_FREEZE_EPOCHS),
                TRAINER_FREEZE_EPOCHS)
            attn, dense, ffn = postln_backward_layers(
                mask["speech_encoder"], kept)
            want = expected_postln_dropout_launches(
                len(kept), len(attn), len(dense), len(ffn),
                dec.encoder_layers, dec.decoder_layers)
            want.update(conv_backward_launches(mask["speech_encoder"]))
            loss = rec["loss"].item()
            log(f"  fit step {rec['step'] + 1} (progress {rec['progress']}, "
                f"{rec['samples'] / 16000:.2f} s bucket, rows "
                f"{rows['speech']} / {rows['text encoder']} / "
                f"{rows['decoder']}): loss {loss:.4f}, LayerDrop skipped "
                f"{skipped}, backward of attention / epilogue / FFN in "
                f"{len(attn)} / {len(dense)} / {len(ffn)} of {len(kept)} "
                f"kept speech layers")
            if rec["skipped"] != [skipped]:
                raise AssertionError(f"trainer step {rec['step'] + 1}: "
                                     f"LayerDrop skipped {rec['skipped']}, "
                                     f"the key chain gives {skipped}")
            if rec["counts"] != want:
                raise AssertionError(f"trainer step {rec['step'] + 1}: "
                                     f"launches {rec['counts']}, expected "
                                     f"{want}")
            if not math.isfinite(loss):
                raise AssertionError(f"trainer step {rec['step'] + 1}: loss "
                                     f"{loss}")
        if [r["progress"] for r in fit_steps] != [0.0] * 4 + [0.5] * 4:
            raise AssertionError(f"trainer: progress "
                                 f"{[r['progress'] for r in fit_steps]}")

        # (b) eval: a finite eval_loss, no backward kernel; predict: WER /
        # CER over the 16 examples, K4 launched
        records = [json.loads(line) for line in
                   open(os.path.join(out_dir, "metrics.jsonl"))]
        eval_recs = [r for r in records if "eval_loss" in r]
        want_eval = expected_eval_launches(enc.num_layers, dec.encoder_layers,
                                           dec.decoder_layers)
        want_pred = expected_launches("greedy", dec.max_length)
        if [r["step"] for r in eval_recs] != [4, 8]:
            raise AssertionError(f"trainer: eval records {eval_recs}")
        for r in eval_recs:
            if not (math.isfinite(r["eval_loss"]) and r["n_examples"] == 16
                    and math.isfinite(r["predict_wer"])
                    and math.isfinite(r["predict_cer"])):
                raise AssertionError(f"trainer: eval record {r}")
        for _, counts in evals:
            if counts != want_eval:
                raise AssertionError(f"trainer eval: launches {counts}, "
                                     f"expected {want_eval}")
        for _, counts, _ in predicts:
            if counts != want_pred:
                raise AssertionError(f"trainer predict: launches {counts}, "
                                     f"expected {want_pred}")
        log(f"  eval records: " + "; ".join(
            f"step {r['step']}: eval_loss {r['eval_loss']:.4f}, cer "
            f"{r['cer']:.4f}, wer {r['wer']:.4f}, predict_wer "
            f"{r['predict_wer']:.4f}, predict_cer {r['predict_cer']:.4f} "
            f"over {r['n_examples']}" for r in eval_recs))
        log(f"  eval step launches {evals[-1][1]}; predict launches "
            f"(greedy, max_length {dec.max_length}) "
            f"{predicts[-1][1]['smx_decode_attention']} K4")

        # (c) save_total_limit checkpoints kept, the best among them
        kept_steps = sorted(s for s, _ in tr.ckpt._step_paths())
        best = tr.ckpt.best_step()
        if len(kept_steps) != tc.save_total_limit or best not in kept_steps:
            raise AssertionError(f"trainer: checkpoints {kept_steps}, best "
                                 f"{best}")
        # (d) restore: the bits of the state at that step
        fresh = trainer.create_train_state(gen, cfg, tc)
        restores = []
        for rec in saves:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            back, meta = tr.ckpt.restore(fresh, step=rec["step"])
            torch.cuda.synchronize()
            restores.append(time.perf_counter() - t0)
            if back.step != rec["step"] or _state_prints(back) != \
                    rec["prints"]:
                raise AssertionError(f"trainer: checkpoint {rec['step']} "
                                     "restores other bits")
        log(f"  checkpoints kept {kept_steps}, best {best}; restore of steps "
            f"{[r['step'] for r in saves]}: parameters and Adafactor "
            f"statistics bit-identical to the saved state")

        # (e) a second Trainer resumes the directory for one step; (f) it
        # loads the best step at the end
        steps.clear()
        # no eval in the resumed run: its best step is fit's
        tc2 = dataclasses.replace(tc, max_steps=TRAINER_PROFILED_STEP + 1,
                                  eval_steps=100)
        tr2 = TimedTrainer(cfg, tc2, tokenizer=tok)
        timed_saves(tr2)
        state2 = trainer.create_train_state(gen, cfg, tc)
        capture["on"] = True
        # the port's kernels use no atomics; cuDNN's convolution backward
        # (the positional conv, layer 0's weight gradient) may, unless
        # asked for its deterministic algorithms: asked for in both runs
        # that are compared bit for bit
        torch.backends.cudnn.deterministic = True
        state2 = tr2.fit(state2, train_batches_factory(), eval_batches)
        records2 = [json.loads(line) for line in
                    open(os.path.join(out_dir, "metrics.jsonl"))][
            len(records):]
        if records2[0] != {"resumed_from_step": 8}:
            raise AssertionError(f"trainer resume: {records2[:2]}")
        ref = tr.ckpt.restore(fresh, step=8)[0]
        ref_step = orig_make(cfg, tc2, ref.params)
        torch.backends.cudnn.deterministic = True
        ref, _ = ref_step(ref, steps[0]["batch"], steps[0]["progress"])
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = False
        differ = sorted(k for k, v in _state_prints(ref).items()
                        if capture["prints"][k] != v)
        if differ:
            raise AssertionError(f"trainer resume: the first step after "
                                 f"resuming differs from step_fn on the "
                                 f"restored state in {len(differ)} leaves: "
                                 f"{differ[:12]}")
        best2 = tr2.ckpt.best_step()
        loaded = [r for r in records2 if "loaded_best_model_from_step" in r]
        best_prints = [r["prints"] for r in saves if r["step"] == best2]
        if loaded != [{"loaded_best_model_from_step": best2}] or \
                _state_prints(state2) != best_prints[0]:
            raise AssertionError(f"trainer: load_best_model_at_end: "
                                 f"{loaded}, best {best2}")
        log(f"  resume: {records2[0]}, step 9 bit-identical to step_fn on "
            f"the restored step-8 state and the same batch; "
            f"{loaded[0]}, the saved bits")
    finally:
        trainer.make_train_step = orig_make
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(out_dir, ignore_errors=True)

    # the loop's numbers.  The fit's step period (a step's entry to the
    # next's) over steps 5-7, the second epoch, where every bucket has been
    # seen once, against the bare step_fn on the same batches as one
    # sequence with one synchronisation at its end (as the loop runs them);
    # steps 1-3 are each bucket's first use.  Then the bare step of every
    # fit batch, warmed once and timed alone.
    period = lambda recs: [(b["entry"] - a["entry"]) * 1e3
                           for a, b in zip(recs, recs[1:])]
    first_ms, fit_ms = period(fit_steps[:4]), period(fit_steps[4:])
    step_fn = orig_make(cfg, tc, state.params)
    bare_ms = []
    for rec in fit_steps:
        for timed in (False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step_fn(state, rec["batch"], rec["progress"])
            torch.cuda.synchronize()
        bare_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for rec in fit_steps[4:7]:
        state, _ = step_fn(state, rec["batch"], rec["progress"])
    torch.cuda.synchronize()
    seq_ms = (time.perf_counter() - t0) * 1e3
    med = lambda xs: sorted(xs)[len(xs) // 2]
    bucket = lambda rec: rec["samples"] // 16000
    padded_s = sum(BATCH * rec["samples"] for rec in fit_steps[4:7]) / 16000
    log(f"  bare step_fn by fit step (bucket s, progress): " + ", ".join(
        f"{rec['step'] + 1} ({bucket(rec)}, {rec['progress']}) {t:.1f}"
        for rec, t in zip(fit_steps, bare_ms)) + " ms")
    log(f"  fit step period, steps 1-3 (each bucket's first use): "
        f"{', '.join(f'{t:.1f}' for t in first_ms)} ms; steps 5-7: "
        f"{', '.join(f'{t:.1f}' for t in fit_ms)} ms, median "
        f"{med(fit_ms):.1f}; bare step_fn on the same batches "
        f"{', '.join(f'{t:.1f}' for t in bare_ms[4:7])} ms, median "
        f"{med(bare_ms[4:7]):.1f}, as a sequence {seq_ms:.1f} ms; the "
        f"loop's host cost {(sum(fit_ms) - seq_ms) / len(fit_ms):.1f} ms "
        f"per step")
    log(f"  audio-seconds per second trained through fit: "
        f"{padded_s * 1e3 / sum(fit_ms):.2f} over steps 5-7 (padded "
        f"audio), {audio_s * TRAINER_EPOCHS / fit_s:.2f} over the whole "
        f"fit ({fit_s:.2f} s for {audio_s * TRAINER_EPOCHS:.1f} audio-s: 8 "
        f"steps, logging, 2 evals, 2 predicts, 2 checkpoints); peak memory "
        f"{peak / 2 ** 30:.2f} GiB on {card}")
    log(f"  eval pass (1 batch of {BATCH}): "
        f"{', '.join(f'{t * 1e3:.1f}' for t, _ in evals)} ms; predict "
        f"batch (greedy, max_length {dec.max_length}): "
        f"{', '.join(f'{t * 1e3:.1f}' for t, _, _ in predicts)} ms; "
        f"checkpoint save {', '.join('%.2f' % r['s'] for r in saves)} s "
        f"({saves[0]['bytes']} bytes each), restore "
        f"{', '.join(f'{t:.2f}' for t in restores)} s on {card}")
    events = profiled.get("events", [])
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if not events:
        raise AssertionError("trainer: the profiled fit step recorded no "
                             "device time")
    log(f"  profiled fit step {TRAINER_PROFILED_STEP} of the resumed run "
        f"(its entry to the next step's): wall {profiled['wall_ms']:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({busy_ms / profiled['wall_ms']:.3f} of wall)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"    {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  "
            f"{e.key[:90]}")
    del state, state2, fresh, ref, step_fn, ref_step, fit_steps
    steps.clear()
    torch.cuda.empty_cache()

    # (g) the teacher: bart-base in f32 on the card, K1-K4, tokens against
    # the plain path's
    nlp = seq2seq.init_seq2seq(dec, gen, dev, torch.float32)
    # random weights end every row on EOS at once; with the EOS logit
    # lowered the rows decode their max_length tokens
    nlp["final_logits_bias"][dec.eos_token_id] = -1e4
    pool = datasets.synthetic_corpus(64, seed=seed, min_words=6, max_words=9)
    sentences = [ex["text"] for ex in pool
                 if 32 < len(tok.encode(ex["text"])) <= 64]
    sentences = sentences[:TEACHER_SENTENCES]
    if len(sentences) != TEACHER_SENTENCES:
        raise AssertionError("teacher: too few sentences of 33-64 tokens")
    layers = dec.encoder_layers
    want = expected_train_launches(0, 0, 0, dtype="f32")
    want.update({"smx_attention_fwd": layers,
                 **dense_launches(layers, "f32"),
                 **ffn_forward_launches(layers, 0, "f32"),
                 "smx_conv_ln_gelu": 0, **dict.fromkeys(CONV_BWD, 0),
                 "smx_decode_attention": 2 * dec.decoder_layers
                 * TEACHER_MAX_LEN})
    run = lambda: teacher.create_self_decoder_inputs_batched(
        nlp, dec, tok, sentences, max_length=TEACHER_MAX_LEN,
        batch_size=TEACHER_SENTENCES)
    run()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pairs = run()
    torch.cuda.synchronize()
    teacher_ms = (time.perf_counter() - t0) * 1e3
    counts = symbols()
    if counts != want:
        raise AssertionError(f"teacher: launches {counts}, expected {want}")
    with plain_kernels():
        kernels.reset_launch_counts()
        ref_pairs = run()
        if any(k.launches for k in kernels.kernels()):
            raise AssertionError("the plain reference launched a kernel")
    width = TEACHER_MAX_LEN + 1
    grid = lambda ps: torch.tensor([lab + [-1] * (width - len(lab))
                                    for _, lab in ps])
    rate = (grid(pairs) == grid(ref_pairs)).float().mean().item()
    if [ids for ids, _ in pairs] != [ids for ids, _ in ref_pairs]:
        raise AssertionError("teacher: text ids differ")
    log(f"  teacher (bart-base f32, {TEACHER_SENTENCES} sentences of "
        f"{min(len(i) for i, _ in pairs)}-{max(len(i) for i, _ in pairs)} "
        f"tokens, text bucket {teacher._text_bucket(max(len(i) for i, _ in pairs))}"
        f", max_length {TEACHER_MAX_LEN}): {teacher_ms:.1f} ms, launches "
        f"K1 {counts['smx_attention_fwd']}, K2 "
        f"{counts['smx_dense_res_ln_f32']}, K3 "
        f"{counts['smx_ffn_down_res_f32']}, K4 "
        f"{counts['smx_decode_attention']}"
        f"; label lengths {sorted({len(l) for _, l in pairs})}; token "
        f"agreement with the plain path {rate:.4f} (at least "
        f"{TOKEN_AGREEMENT_F32}) on {card}")
    if rate < TOKEN_AGREEMENT_F32:
        raise AssertionError(f"teacher: the kernel path agrees with the "
                             f"plain path on {rate} of the tokens")


# the T5 pairs' modes: t5-small the three serving modes and both train
# steps, byt5-small greedy, beam-4 and the step without dropout
T5_MODES = {"t5-small": (("greedy", "greedy-int8", "beam-4"),
                         ("train", "train-dropout")),
            "byt5-small": (("greedy", "beam-4"), ("train",))}
T5_GENERATE_KWARGS = {"greedy": {}, "greedy-int8": {"kv_int8": True},
                      "beam-4": {"num_beams": BEAMS,
                                 "num_return_sequences": BEAMS,
                                 "output_scores": True}}
T5_TRAIN_STEPS = 6


def t5_config(name, layers=None):
    """wav2vec2-base (12 post-LN layers, the fused extractor) + t5-small (6
    + 6 layers, H = 512, relu, tied head, vocabulary 32128) or byt5-small
    (12 + 4 layers, H = 1472, gated GELU, untied head, vocabulary 384),
    down_scale 2.  `layers`: (speech, text encoder, decoder) depths of a cut
    copy, LayerDrop off."""
    import dataclasses
    from speechmix_tpu_torch import config
    enc = dataclasses.replace(config.SPEECH_ENCODER_PRESETS["wav2vec2-base"],
                              extractor_impl="fused")
    dec = config.SEQ2SEQ_PRESETS[name]
    if layers is not None:
        enc = dataclasses.replace(enc, num_layers=layers[0], layerdrop=0.0)
        dec = dataclasses.replace(dec, encoder_layers=layers[1],
                                  decoder_layers=layers[2])
    return config.SpeechMixConfig(encoder=enc, decoder=dec, down_scale=2)


def t5_ffn_fused(dcfg, rows):
    """Whether the T5 stack's FFN at `rows` rows takes K9 / K13 and K8: the
    JAX package's gate (relu, widths multiples of 128, >= 1024 rows)."""
    return (dcfg.activation == "relu" and dcfg.hidden_size % 128 == 0
            and dcfg.ffn_dim % 128 == 0 and rows >= 1024)


def expected_t5_launches(mode, steps, cfg, enc_rows):
    """Launches of every kernel in one generate() of a T5 pair: the speech
    encoder's K1, K2, K3 and K6 as the flagship's; the T5 text encoder's
    FFN as K9 where the gate admits it (its attention carries the position
    bias: plain); in the decoder K4 once per layer and step for the
    cross-attention only (the self-attention carries the position bias),
    its int8 entry with int8 cross K/V; K5 once per step with beams."""
    speech, dec = cfg.encoder.num_layers, cfg.decoder
    want = expected_launches(mode, steps)
    cross = dec.decoder_layers * steps
    int8 = mode.endswith("int8")
    want.update({"smx_attention_fwd": speech, "smx_dense_res_ln": speech,
                 "smx_decode_attention": 0 if int8 else cross,
                 "smx_decode_attention_q8": cross if int8 else 0,
                 **ffn_forward_launches(speech, dec.encoder_layers if
                                        t5_ffn_fused(dec, enc_rows) else 0)})
    return want


def expected_t5_train_launches(cfg, kept, rows, dtype="bf16",
                               dropout=False):
    """Launches of every kernel in one train step of a T5 pair: the speech
    encoder's `kept` post-LN layers as the flagship's; in the T5 stacks K9
    forward and K8 backward for each layer whose FFN the gate admits at
    its rows (rows = (text encoder, decoder)), K13 and K8 with the mask
    with dropout, nothing else (bias-carrying attention, plain
    out-projections, RMS norms).  With dropout K10 draws the speech
    encoder's two plain sites and regenerates its K11 / K12 output masks,
    and in the T5 stacks every plain site: the embedding and the final
    norm of each stack, per encoder layer the probabilities, the attention
    output and the FFN output, per decoder layer those of both attentions
    and the FFN output, and the activation where the FFN runs plain."""
    dec = cfg.decoder
    fused = [n * t5_ffn_fused(dec, r) for n, r in
             zip((dec.encoder_layers, dec.decoder_layers), rows)]
    t5 = sum(fused)
    if not dropout:
        want = expected_train_launches(kept, 0, 0, dtype=dtype)
        want.update({**dict.fromkeys(K8_ENTRIES[dtype], kept + t5),
                     **ffn_forward_launches(kept, kept + t5, dtype)})
        return want
    want = expected_dropout_train_launches(kept, 0, 0, dtype)
    plain_act = [n - f_ for n, f_ in zip((dec.encoder_layers,
                                          dec.decoder_layers), fused)]
    want.update({
        **ffn_forward_launches(kept, kept + t5, dtype, dropout=True),
        **dict.fromkeys(K8_DROPOUT_ENTRIES[dtype], kept + t5),
        "smx_dropout_mask": (2 + 2 * kept + 2 + 3 * dec.encoder_layers
                             + 2 + 5 * dec.decoder_layers + sum(plain_act))})
    return want


def run_t5(seed, card):
    """The T5 family under wav2vec2-base at full width and depth, random
    bf16 weights from the seed, B = BATCH x SECONDS s, MAX_LEN steps: for
    t5-small greedy, greedy-int8 and beam-4 generate() and a bf16 AdamW
    train step without and with dropout, for byt5-small greedy, beam-4 and
    a step without dropout.  Each: exact launches of every kernel (and K9 /
    K13 / K8 by rows), two calls (two steps from one state) bit-identical,
    median ms of the timed calls, audio-s/s, peak memory, the busy share of
    a profiled call.  In f32 the greedy and beam-4 tokens through the
    kernels must equal those through the plain versions.  Returns ({mode:
    launches per call}, {mode: launches by (entry, rows)})."""
    import torch
    from speechmix_tpu_torch import generation
    from speechmix_tpu_torch.models import speech_encoder, speechmix
    from speechmix_tpu_torch.ops import kernels
    from speechmix_tpu_torch.ops.kernels import decode_attention as kd
    from speechmix_tpu_torch.ops.kernels import ffn as kf
    from speechmix_tpu_torch.training import freezing, trainer

    dev = torch.device("cuda")
    # K9 / K13 / K8 by rows, K4 by key length (the argument after the K/V
    # and query row counts)
    rows = collections.Counter()
    tallied = {kf.FFN_DOWN: 0, kf.FFN_DROPOUT_UP: 0, kf.FFN_BWD_RECOMPUTE: 0,
               kf.FFN_DROPOUT_BWD_RECOMPUTE: 0, kd.KERNEL: 2,
               kd.KERNEL_Q8: 2}
    for kern, offset in tallied.items():
        kern.launch = _tally_by_length(kern, rows, offset)
    counts, by_rows = {}, {}

    def launches():
        return {k.symbol: k.launches for k in kernels.kernels()}

    for name, (serve_modes, train_modes) in T5_MODES.items():
        cfg = t5_config(name)
        dec = cfg.decoder
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = speechmix.init_speechmix(cfg, gen, dev, torch.bfloat16)
        n_params = sum(p.numel() for _, p in freezing.tree_paths(params))
        t_samples = int(SECONDS * 16000)
        wav = torch.zeros(BATCH, cfg.encoder.aligned_samples(t_samples),
                          device=dev)
        wav[:, :t_samples] = torch.randn(BATCH, t_samples, generator=gen,
                                         device=dev) * 0.1
        lengths = torch.full((BATCH,), t_samples, device=dev)
        enc_rows = BATCH * int(cfg.encoder.feature_lengths(wav.shape[1])
                               // 2 ** cfg.downloop)
        log(f"{name} pair: wav2vec2-base + {name} ({dec.encoder_layers} + "
            f"{dec.decoder_layers} layers, H={dec.hidden_size}, "
            f"{dec.activation}, vocabulary {dec.vocab_size}, "
            f"{'tied' if dec.tie_word_embeddings else 'untied'} head), "
            f"{n_params / 1e6:.1f} M parameters, bf16, B={BATCH} x {SECONDS}"
            f" s, max_length {MAX_LEN}, text-encoder rows {enc_rows}")
        for mode in serve_modes:
            kwargs = T5_GENERATE_KWARGS[mode]
            want = expected_t5_launches(mode, MAX_LEN, cfg, enc_rows)
            call = lambda: generation.generate(  # noqa: E731
                params, cfg, wav, lengths, max_length=MAX_LEN,
                dtype=torch.bfloat16, **kwargs)
            outs, times = [], []
            torch.cuda.reset_peak_memory_stats()
            for i in range(4):            # a warm-up call, then 3 timed
                kernels.reset_launch_counts()
                rows.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = call()
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                run_counts = launches()
                if run_counts != want:
                    raise AssertionError(f"{name} {mode}: launches "
                                         f"{run_counts}, expected {want}")
                outs.append(out)
                if i:
                    times.append(dt)
            tag = f"{name.split('-')[0]}-{mode}"
            counts[tag], by_rows[tag] = run_counts, dict(rows)
            expect_equal(f"{name} {mode} generate", outs[1], outs[2])
            tok = outs[-1][0]
            n_rows = BATCH * kwargs.get("num_return_sequences", 1)
            if (tok.shape != (n_rows, MAX_LEN) or (outs[-1][1] < 0).any()
                    or not ((tok >= 0) & (tok < dec.vocab_size)).all()):
                raise AssertionError(f"{name} {mode}: bad tokens "
                                     f"{tuple(tok.shape)}")
            med = sorted(times)[len(times) // 2]
            wall_us, busy_us, events = profile_call(call)
            log(f"  {name} {mode}: {med * 1e3:.1f} ms per call (median of "
                f"{len(times)}: {', '.join(f'{t * 1e3:.1f}' for t in times)}"
                f"), audio-seconds per second {BATCH * SECONDS / med:.2f}, "
                f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
                f" GiB, profiled call busy {busy_us / wall_us:.3f} of "
                f"{wall_us / 1e3:.1f} ms; launches "
                f"{ {k: v for k, v in run_counts.items() if v} }; K9 / K13 / "
                f"K8 by rows, K4 by key length "
                f"{ {f'{k[0]} {k[1]}': n for k, n in sorted(by_rows[tag].items())} } on {card}")
            log("    device ms by kernel, the profiled call: " + ", ".join(
                f"{e.key[:48]} {e.self_device_time_total / 1e3:.2f} "
                f"({e.count}x)" for e in sorted(
                    events, key=lambda e: -e.self_device_time_total)[:8]))
        # f32: the kernel path decodes what the plain path decodes
        p32 = _cast_tree(params, torch.float32)
        f32_run = lambda **kw: generation.generate(  # noqa: E731
            p32, cfg, wav, lengths, max_length=MAX_LEN, dtype=torch.float32,
            **kw)
        with torch.no_grad():
            got = [f32_run(), f32_run(**T5_GENERATE_KWARGS["beam-4"])]
            with plain_kernels():
                kernels.reset_launch_counts()
                ref = [f32_run(), f32_run(**T5_GENERATE_KWARGS["beam-4"])]
                if any(k.launches for k in kernels.kernels()):
                    raise AssertionError("the plain reference launched a "
                                         "kernel")
        for what, a, b in (("greedy", got[0][0], ref[0][0]),
                           ("beam-4", got[1][0], ref[1][0])):
            if not torch.equal(a, b):
                raise AssertionError(f"{name} {what}: f32 kernel tokens "
                                     f"differ from the plain path's on "
                                     f"{(a != b).float().mean().item():.4f}")
        score_diff = (got[1][2] - ref[1][2]).abs().max().item()
        log(f"  {name}: f32 kernels vs f32 plain path: greedy and beam-4 "
            f"tokens equal; beam scores max abs difference "
            f"{score_diff:.3e} (at most {BEAM_SCORE_TOL_F32})")
        if not score_diff <= BEAM_SCORE_TOL_F32:
            raise AssertionError(f"{name} beam-4: f32 scores differ by "
                                 f"{score_diff}")
        del params, p32, got, ref

        batch = _train_batch(cfg, gen, dev, BATCH, SECONDS, TRAIN_LABELS)
        step_rows = (enc_rows, BATCH * TRAIN_LABELS)
        for mode in train_modes:
            dropout = mode == "train-dropout"
            tc = trainer.TrainConfig(learning_rate=TRAIN_LR, warmup_steps=1,
                                     bf16=True, dropout=dropout,
                                     optimizer="adamw", seed=seed)
            state = trainer.create_train_state(
                torch.Generator(device=dev).manual_seed(seed + 1), cfg, tc)
            twin = trainer.create_train_state(
                torch.Generator(device=dev).manual_seed(seed + 1), cfg, tc)
            step_fn = trainer.make_train_step(cfg, tc, state.params)
            twin_fn = trainer.make_train_step(cfg, tc, twin.params)
            losses, times = [], []
            for i in range(T5_TRAIN_STEPS):
                skipped = (layerdrop_replay(trainer, speech_encoder, tc, cfg,
                                            state.step) if dropout else [])
                want = expected_t5_train_launches(
                    cfg, cfg.encoder.num_layers - len(skipped), step_rows,
                    dropout=dropout)
                kernels.reset_launch_counts()
                rows.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batch)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                run_counts = launches()
                loss = metrics["loss"].item()
                norm = metrics["grad_norm"].item()
                log(f"  {name} {mode} step {i + 1}: loss {loss:.4f}, "
                    f"grad_norm {norm:.4f}, {dt * 1e3:.1f} ms" +
                    (f", LayerDrop skipped {skipped}" if dropout else ""))
                if run_counts != want:
                    raise AssertionError(f"{name} {mode} {i + 1}: launches "
                                         f"{run_counts}, expected {want}")
                if not (math.isfinite(loss) and math.isfinite(norm)):
                    raise AssertionError(f"{name} {mode}: loss {loss}, "
                                         f"grad_norm {norm}")
                if i == 0:
                    tag = f"{name.split('-')[0]}-{mode}"
                    counts[tag], by_rows[tag] = run_counts, dict(rows)
                    twin, twin_metrics = twin_fn(twin, batch)
                    if (twin_metrics["loss"].item() != loss
                            or _fingerprints(twin.params)
                            != _fingerprints(state.params)):
                        raise AssertionError(f"{name} {mode}: two steps "
                                             "from one state differ")
                    log(f"  {name} {mode}: two steps from one state "
                        "bit-identical")
                    del twin, twin_fn
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                else:
                    times.append(dt)
                losses.append(loss)
            if not losses[-1] < losses[1]:
                raise AssertionError(f"{name} {mode}: the loss did not "
                                     f"fall: {losses}")
            med = sorted(times)[len(times) // 2]
            _, busy, _ = _profile_step(lambda: step_fn(state, batch),
                                       f"{name} {mode} step")
            log(f"  {name} {mode}: {med * 1e3:.1f} ms per step (median of "
                f"{len(times)}: {', '.join(f'{t * 1e3:.1f}' for t in times)}"
                f"), audio-seconds per second trained "
                f"{BATCH * SECONDS / med:.2f}, peak memory (steps 2-"
                f"{T5_TRAIN_STEPS}) "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, loss "
                f"{losses[0]:.4f} -> {losses[-1]:.4f}; launches "
                f"{ {k: v for k, v in counts[tag].items() if v} }"
                f"; K9 / K13 / K8 by rows (step 1) "
                f"{ {f'{k[0]} {k[1]}': n for k, n in sorted(by_rows[tag].items())} }"
                f" on {card}")
            del state, step_fn
            torch.cuda.empty_cache()
    for kern in tallied:
        del kern.launch   # the class's own again
    return counts, by_rows


# ----------------------------------------------------------------------------
# the serving surface (run_serving): int8 weights, fused q/k/v, CTC, the
# checkpoint loaders, the API classes and the transcription pipeline
# ----------------------------------------------------------------------------

SERVING_CALLS = 4             # a warm-up call, then 3 timed
CTC_VOCAB, CTC_STEPS, CTC_LABELS = 32, 8, 96
# int8 x int8 -> int32 products held against the CPU's int32 matmul: the
# decode step's rows (16), the encoder's (12800), widths of the flagship's
# denses and of the fused q/k/v, and one shape torch._int_mm refuses unpadded
INT8_MM_SHAPES = ((16, 768, 768), (16, 768, 3072), (16, 3072, 768),
                  (12800, 768, 2304), (5, 13, 7))
INT8_COMPUTE_BOUND = 0.08     # tests/test_quantize_remat.py's logits bound
PIPELINE_UTTERANCES = 64
# seconds of the serving phase by kind of work, across its parts
SERVING_SPENT = collections.Counter()


@contextlib.contextmanager
def spending(what):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        SERVING_SPENT[what] += time.perf_counter() - t0


def serving_launches(mode, steps, int8_weights=False, fused_extractor=True):
    """Launches of one flagship generate() in `mode` (expected_launches), on
    int8 weights (the fused-block gate sends a block whose weights are not
    a float `kernel` to the plain chain: no K2, K3 or K9) and / or with the
    library conv in the extractor (extractor_impl "auto": no K6)."""
    want = expected_launches(mode, steps)
    if int8_weights:
        want.update(ffn_forward_launches(0, 0))
        want["smx_dense_res_ln"] = 0
    if not fused_extractor:
        want["smx_conv_ln_gelu"] = 0
    return want


def _weight_bytes(params):
    from speechmix_tpu_torch.training.freezing import tree_paths
    return sum(t.numel() * t.element_size() for _, t in tree_paths(params))


def _launches():
    from speechmix_tpu_torch.ops import kernels
    return {k.symbol: k.launches for k in kernels.kernels()}


def serve_mode(label, call, want, card, audio_s, cross_check=False):
    """SERVING_CALLS calls of `call` (a warm-up, then the timed ones), each
    with exactly the launches `want`; the second and third bit-identical;
    median ms, audio-s/s, peak memory and the busy share of one profiled
    call (with cross_check, its device time held against key_averages()'s).
    Returns (launches of a call, the last output, median ms)."""
    import torch
    from speechmix_tpu_torch.ops import kernels
    outs, times = [], []
    torch.cuda.reset_peak_memory_stats()
    with spending("timed calls"):
        for i in range(SERVING_CALLS):
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = _launches()
            if counts != want:
                raise AssertionError(f"{label}: launches {counts}, expected "
                                     f"{want}")
            outs.append(out)
            if i:
                times.append(dt)
    expect_equal(label, outs[1], outs[2])
    med = sorted(times)[len(times) // 2]
    peak = torch.cuda.max_memory_allocated()
    with spending("profiled calls"):
        wall_us, busy_us, _ = profile_call(call, cross_check)
    log(f"  {label}: {med * 1e3:.1f} ms per call (median of {len(times)}: "
        f"{', '.join(f'{t * 1e3:.1f}' for t in times)}), audio-seconds per "
        f"second {audio_s / med:.2f}, peak memory {peak / 2 ** 30:.2f} GiB, "
        f"profiled call busy {busy_us / wall_us:.3f} of "
        f"{wall_us / 1e3:.1f} ms; launches "
        f"{ {k: v for k, v in counts.items() if v} } on {card}")
    return counts, outs[-1], med


def tokens_equal(label, got, want):
    import torch
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: tokens differ on "
                             f"{(got != want).float().mean().item():.4f}")
    log(f"  {label}: tokens equal")


def check_int8_matmul(dev):
    """int8_matmul on the card (torch._int_mm, padded where it refuses)
    against the CPU's int32 matmul, bit for bit."""
    import torch
    from speechmix_tpu_torch.ops import layers
    gen = torch.Generator().manual_seed(7)
    for m, k, n in INT8_MM_SHAPES:
        a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
        got = layers.int8_matmul(a.to(dev), b.to(dev)).cpu()
        if not torch.equal(got, layers.int8_matmul(a, b)):
            raise AssertionError(f"int8_matmul {(m, k, n)}: the card's "
                                 "product differs from the CPU's")
    log(f"  int8 x int8 -> int32 (torch._int_mm, rows padded to "
        f"{layers._INT_MM_MIN_ROWS}, widths to multiples of "
        f"{layers._INT_MM_MULTIPLE}) equal to the CPU's int32 matmul at "
        f"{INT8_MM_SHAPES}")


def serve_int8_and_fused(cfg, params, wav, lengths, card, counts):
    """int8 weights in greedy, greedy with int8 cross K/V and beam-4; the
    int8 product's error in the speech encoder; fused q/k/v on float and
    int8 weights; in f32 the int8 / fused tokens of the kernel path against
    the plain path's and the unfused tree's."""
    import torch
    from speechmix_tpu_torch import generation
    from speechmix_tpu_torch.models import speech_encoder
    from speechmix_tpu_torch.ops import layers
    from speechmix_tpu_torch.utils.quantize import (fuse_qkv_params,
                                                    quantization_report,
                                                    quantize_weights)
    bf16, audio_s = torch.bfloat16, BATCH * SECONDS
    t0 = time.perf_counter()
    qparams = quantize_weights(params)
    torch.cuda.synchronize()
    n_q, n_t = quantization_report(qparams)
    log(f"int8 weights (quantize_weights, defaults): {n_q / 1e6:.1f} M of "
        f"{n_t / 1e6:.1f} M elements int8, quantized in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms; weight bytes on the "
        f"card {_weight_bytes(qparams) / 2 ** 20:.1f} MiB against the bf16 "
        f"tree's {_weight_bytes(params) / 2 ** 20:.1f} MiB")
    modes = {"greedy": {}, "greedy-int8": {"kv_int8": True},
             "beam-4": {"num_beams": BEAMS}}
    # the bf16 tree's greedy call beside them, in the same stretch of time
    serve_mode("bf16 weights greedy generate",
               lambda: generation.generate(params, cfg, wav, lengths,
                                           max_length=MAX_LEN, dtype=bf16),
               serving_launches("greedy", MAX_LEN), card, audio_s)
    for mode, kwargs in modes.items():
        call = lambda kw=kwargs: generation.generate(  # noqa: E731
            qparams, cfg, wav, lengths, max_length=MAX_LEN, dtype=bf16, **kw)
        counts[f"int8w-{mode}"], _, _ = serve_mode(
            f"int8 weights {mode} generate", call,
            serving_launches(mode, MAX_LEN, int8_weights=True), card,
            audio_s)
    check_int8_matmul(wav.device)
    # the int8 product (per-token activation scales) against dequantizing
    with torch.no_grad():
        ref = speech_encoder.speech_encoder_apply(
            qparams["speech_encoder"], cfg.encoder, wav, lengths,
            dtype=bf16)["last_hidden_state"].float()
        layers.set_int8_dense_compute(True)
        try:
            got = speech_encoder.speech_encoder_apply(
                qparams["speech_encoder"], cfg.encoder, wav, lengths,
                dtype=bf16)["last_hidden_state"].float()
        finally:
            layers.set_int8_dense_compute(False)
    err = ((got - ref).abs().max() / ref.abs().max()).item()
    log(f"  set_int8_dense_compute(True): speech-encoder output max |int8 "
        f"product - dequantized| / max |dequantized| {err:.4f} (at most "
        f"{INT8_COMPUTE_BOUND})")
    if not err <= INT8_COMPUTE_BOUND:
        raise AssertionError(f"int8 dense compute: error {err}")

    fused = fuse_qkv_params(params)
    fused_q = fuse_qkv_params(qparams)
    for label, tree, int8 in (("fused q/k/v", fused, False),
                              ("fused q/k/v, int8 weights", fused_q, True)):
        counts[("fused-int8w" if int8 else "fused") + "-greedy"], _, _ = \
            serve_mode(f"{label} greedy generate",
                       lambda t=tree: generation.generate(
                           t, cfg, wav, lengths, max_length=MAX_LEN,
                           dtype=bf16),
                       serving_launches("greedy", MAX_LEN, int8), card,
                       audio_s)
    # f32: int8 weights through the kernels against the plain path, and the
    # fused trees against the unfused ones
    p32 = _cast_tree(params, torch.float32)
    q32 = quantize_weights(p32)
    run = lambda tree, **kw: generation.generate(  # noqa: E731
        tree, cfg, wav, lengths, max_length=MAX_LEN, dtype=torch.float32,
        **kw)[0]
    with torch.no_grad(), spending("f32 checks"):
        got = {mode: run(q32, **kw) for mode, kw in modes.items()}
        with plain_kernels():
            from speechmix_tpu_torch.ops import kernels
            kernels.reset_launch_counts()
            ref = {mode: run(q32, **kw) for mode, kw in modes.items()}
            if any(k.launches for k in kernels.kernels()):
                raise AssertionError("the plain reference launched a kernel")
        for mode in modes:
            tokens_equal(f"int8 weights {mode}, f32 kernels vs f32 plain "
                         "path", got[mode], ref[mode])
        tokens_equal("fused q/k/v greedy, f32, vs the unfused tree",
                     run(fuse_qkv_params(p32)), run(p32))
        tokens_equal("fused q/k/v greedy on int8 weights, f32, vs the "
                     "unfused int8 tree", run(fuse_qkv_params(q32)),
                     got["greedy"])
    del qparams, fused, fused_q, p32, q32


def serve_ctc(seed, cfg, wav, lengths, card, counts):
    """The CTC head on wav2vec2-base (12 layers, the flagship's encoder) with
    a CTC_VOCAB-token head: the bf16 forward's launches, the f32 logits of
    the kernels against the plain path, ctc_greedy_decode, then CTC_STEPS
    AdamW steps on the CTC loss (bf16 compute, f32 parameters)."""
    import torch
    from speechmix_tpu_torch.models import ctc
    from speechmix_tpu_torch.ops import kernels
    from speechmix_tpu_torch.training import trainer
    from speechmix_tpu_torch.training.freezing import tree_paths
    dev, enc = wav.device, cfg.encoder
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    params = ctc.init_ctc_model(enc, CTC_VOCAB, gen, dev, torch.float32)
    pb = _cast_tree(params, torch.bfloat16)
    want = serving_launches("greedy", 0)
    want.update({"smx_attention_fwd": enc.num_layers,
                 "smx_dense_res_ln": enc.num_layers,
                 **ffn_forward_launches(enc.num_layers, 0)})
    with torch.no_grad():
        counts["ctc-forward"], out, _ = serve_mode(
            "CTC forward (wav2vec2-base + 32-token head)",
            lambda: ctc.ctc_apply(pb, enc, wav, lengths,
                                  dtype=torch.bfloat16)["logits"], want,
            card, BATCH * SECONDS, cross_check=True)
        k32 = ctc.ctc_apply(params, enc, wav, lengths)
        with plain_kernels():
            ref = ctc.ctc_apply(params, enc, wav, lengths)["logits"]
    valid = k32["frame_mask"][..., None].float()
    rel = (((k32["logits"] - ref) * valid).norm() / (ref * valid).norm()
           ).item()
    log(f"  CTC logits, f32 kernels vs f32 plain path: relative error "
        f"{rel:.3e} (bound {REL_BOUND_F32})")
    if not rel <= REL_BOUND_F32:
        raise AssertionError(f"CTC logits: relative error {rel}")
    seqs = ctc.ctc_greedy_decode(out, k32["frame_mask"])
    n_frames = int(k32["frame_lengths"][0])
    if len(seqs) != BATCH or any(len(s) > n_frames or any(
            not 0 < t < CTC_VOCAB for t in s) for s in seqs):
        raise AssertionError("ctc_greedy_decode: bad output")
    log(f"  ctc_greedy_decode (bf16 logits): {BATCH} rows, "
        f"{sum(map(len, seqs)) / BATCH:.1f} labels a row of {n_frames} "
        f"frames; row 0 starts {seqs[0][:12]}")

    labels = torch.randint(1, CTC_VOCAB, (BATCH, CTC_LABELS), generator=gen,
                           device=dev)
    labels[1, CTC_LABELS - 20:] = 0          # a shorter row (blank-padded)
    tc = trainer.TrainConfig(learning_rate=TRAIN_LR, warmup_steps=1,
                             optimizer="adamw")
    opt = trainer.AdamW(tc)
    want = expected_train_launches(enc.num_layers, 0, 0)
    box = {"state": opt.init(params)}

    def step():
        """One AdamW step on the CTC loss: (loss, gradient norm) tensors."""
        leaves = trainer.tree_map(lambda p: p.detach().requires_grad_(),
                                  params)
        loss = ctc.ctc_apply(leaves, enc, wav, lengths, labels=labels,
                             dtype=torch.bfloat16)["loss"]
        flat = [p for _, p in tree_paths(leaves)]
        it = iter(torch.autograd.grad(loss, flat, allow_unused=True))
        # masked_spec_embed (no SpecAugment here) gets no gradient
        grads = trainer.tree_map(
            lambda p: (lambda g: torch.zeros_like(p) if g is None else g)(
                next(it)), params)
        norm = trainer.global_norm(grads)
        box["state"] = opt.update_(params, grads, box["state"], norm)
        return loss, norm

    losses, times = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(CTC_STEPS):
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, norm = step()
        loss = loss.item()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        run_counts = _launches()
        log(f"  CTC step {i + 1}: loss {loss:.3f}, grad_norm "
            f"{norm.item():.3f}, {dt * 1e3:.1f} ms")
        if run_counts != want:
            raise AssertionError(f"CTC step {i + 1}: launches {run_counts}, "
                                 f"expected {want}")
        if not math.isfinite(loss):
            raise AssertionError(f"CTC step {i + 1}: loss {loss}")
        losses.append(loss)
        if i >= 2:
            times.append(dt)
    counts["ctc-train"] = run_counts
    if not losses[-1] < losses[1]:
        raise AssertionError(f"CTC: the loss did not fall: {losses}")
    med = sorted(times)[len(times) // 2]
    log(f"  CTC AdamW step: {med * 1e3:.1f} ms (median of {len(times)}), "
        f"audio-seconds per second trained {BATCH * SECONDS / med:.2f}, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
        f"loss {losses[1]:.3f} -> {losses[-1]:.3f}, launches per step "
        f"{ {k: v for k, v in run_counts.items() if v} } on {card}")
    _profile_step(step, "CTC AdamW step")


def hf_config_dicts(cfg):
    """The HF config.json dicts of a wav2vec2 + BART SpeechMix config, in the
    reference's composite layout ({"model_type": "speechmix", "encoder",
    "decoder"})."""
    enc, dec = cfg.encoder, cfg.decoder
    return {"model_type": "speechmix", "encoder": {
        "model_type": "wav2vec2", "_name_or_path": enc.name,
        "conv_dim": list(enc.conv_dims), "conv_kernel": list(enc.conv_kernels),
        "conv_stride": list(enc.conv_strides), "conv_bias": enc.conv_bias,
        "feat_extract_norm": enc.feat_extract_norm,
        "hidden_size": enc.hidden_size, "num_hidden_layers": enc.num_layers,
        "num_attention_heads": enc.num_heads, "intermediate_size": enc.ffn_dim,
        "hidden_act": enc.activation, "layer_norm_eps": enc.layer_norm_eps,
        "do_stable_layer_norm": enc.do_stable_layer_norm,
        "num_conv_pos_embeddings": enc.pos_conv_kernel,
        "num_conv_pos_embedding_groups": enc.pos_conv_groups,
        "hidden_dropout": enc.dropout,
        "attention_dropout": enc.attention_dropout,
        "activation_dropout": enc.activation_dropout,
        "feat_proj_dropout": enc.feat_proj_dropout,
        "apply_spec_augment": enc.apply_spec_augment,
        "mask_time_prob": enc.mask_time_prob,
        "mask_time_length": enc.mask_time_length,
        "mask_time_min_masks": enc.mask_time_min_masks,
        "mask_feature_prob": enc.mask_feature_prob,
        "mask_feature_length": enc.mask_feature_length,
        "mask_feature_min_masks": enc.mask_feature_min_masks,
        "layerdrop": enc.layerdrop}, "decoder": {
        "model_type": "bart", "_name_or_path": dec.name,
        "vocab_size": dec.vocab_size, "d_model": dec.hidden_size,
        "encoder_layers": dec.encoder_layers,
        "decoder_layers": dec.decoder_layers,
        "encoder_attention_heads": dec.num_heads,
        "encoder_ffn_dim": dec.ffn_dim,
        "activation_function": dec.activation,
        "max_position_embeddings": dec.max_positions,
        "pad_token_id": dec.pad_token_id, "bos_token_id": dec.bos_token_id,
        "eos_token_id": dec.eos_token_id,
        "decoder_start_token_id": dec.decoder_start_token_id,
        "dropout": dec.dropout, "attention_dropout": dec.attention_dropout,
        "activation_dropout": dec.activation_dropout,
        "scale_embedding": dec.scale_embedding,
        "tie_word_embeddings": dec.tie_word_embeddings,
        "max_length": dec.max_length}}


def serve_loaders(cfg, params, wav, lengths, card, counts):
    """export_speechmix of the flagship's parameters through torch.save
    into pytorch_model.bin beside a composite config.json;
    HFSpeechMixEED.from_reference_checkpoint and load_hf_checkpoint (from
    the two backbones' files) on the card, their bf16 greedy tokens
    bit-identical to the source parameters'."""
    import dataclasses
    import tempfile
    import torch
    from speechmix_tpu_torch import api, convert, generation
    from speechmix_tpu_torch.training.freezing import tree_paths
    bf16 = torch.bfloat16
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        sd = convert.export_speechmix(params, cfg)
        t_export = time.perf_counter() - t0
        ckpt = os.path.join(tmp, "ckpt")
        os.makedirs(ckpt)
        with open(os.path.join(ckpt, "config.json"), "w") as f:
            json.dump(hf_config_dicts(cfg), f)
        t0 = time.perf_counter()
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   os.path.join(ckpt, "pytorch_model.bin"))
        t_save = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(ckpt, "pytorch_model.bin"))
        for name, prefix in (("speech", "encoder_model."),
                             ("nlp", "decoder_model.")):
            os.makedirs(os.path.join(tmp, name))
            torch.save({k[len(prefix):]: torch.from_numpy(v)
                        for k, v in sd.items() if k.startswith(prefix)},
                       os.path.join(tmp, name, "pytorch_model.bin"))
        del sd
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = api.HFSpeechMixEED.from_reference_checkpoint(
            ckpt, down_scale=2, dtype="bfloat16")
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        derived = model.config
        for part in ("encoder", "decoder"):
            want_d = dataclasses.asdict(getattr(cfg, part))
            got_d = dataclasses.asdict(getattr(derived, part))
            diff = [k for k in want_d if want_d[k] != got_d[k]
                    and k not in ("name", "extractor_impl")]
            if diff:
                raise AssertionError(f"config_from_hf: the {part} differs "
                                     f"from the flagship's in {diff}")
        got = dict(tree_paths(model.params))
        if sorted(got) != sorted(p for p, _ in tree_paths(params)) or any(
                not torch.equal(got[p], t) for p, t in tree_paths(params)):
            raise AssertionError("from_reference_checkpoint: parameters "
                                 "differ from the exported ones")
        log(f"loaders: export_speechmix {t_export:.2f} s, torch.save "
            f"{t_save:.2f} s ({size / 2 ** 20:.0f} MiB), "
            f"HFSpeechMixEED.from_reference_checkpoint on the card "
            f"{t_load:.2f} s; every parameter bit-identical to the source; "
            f"config_from_hf gives the flagship's configuration (extractor "
            f"{derived.encoder.extractor_impl!r}) on {card}")
        want, _ = generation.generate(params, derived, wav, lengths,
                                      max_length=MAX_LEN, dtype=bf16)
        counts["loaded-greedy"], out, _ = serve_mode(
            "from_reference_checkpoint greedy generate",
            lambda: generation.generate(model.params, derived, wav, lengths,
                                        max_length=MAX_LEN, dtype=bf16),
            serving_launches("greedy", MAX_LEN, fused_extractor=False),
            card, BATCH * SECONDS)
        tokens_equal("from_reference_checkpoint greedy, bf16, vs the source "
                     "parameters", out[0], want)
        model.params["speech_encoder"] = model.params["nlp"] = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.load_hf_checkpoint(os.path.join(tmp, "speech"),
                                 os.path.join(tmp, "nlp"))
        torch.cuda.synchronize()
        t_hf = time.perf_counter() - t0
        out, _ = generation.generate(model.params, derived, wav, lengths,
                                     max_length=MAX_LEN, dtype=bf16)
        tokens_equal(f"load_hf_checkpoint (backbones in {t_hf:.2f} s) "
                     "greedy, bf16, vs the source parameters", out, want)
    del model


def serve_api(seed, wav, lengths, card, counts):
    """SpeechMixEED("wav2vec2-base", "bart-base", down_scale=2,
    dtype="bfloat16") on the card: forward with labels, generate greedy and
    beam-4 against generation.generate on its parameters, save_pretrained
    -> from_pretrained."""
    import tempfile
    import torch
    from speechmix_tpu_torch import api, generation
    from speechmix_tpu_torch.training.freezing import tree_paths
    t0 = time.perf_counter()
    model = api.SpeechMixEED("wav2vec2-base", "bart-base", down_scale=2,
                             dtype="bfloat16", seed=seed)
    torch.cuda.synchronize()
    log(f"API: SpeechMixEED('wav2vec2-base', 'bart-base', down_scale=2, "
        f"dtype='bfloat16') on {model.device} in "
        f"{time.perf_counter() - t0:.2f} s; extractor "
        f"{model.config.encoder.extractor_impl!r} (the library conv: no K6)")
    n = int(lengths[0])
    wavs = [w[:n].cpu().numpy() for w in wav]
    gen = torch.Generator().manual_seed(seed)
    labels = torch.randint(3, model.config.decoder.vocab_size,
                           (BATCH, TRAIN_LABELS), generator=gen)
    out = model(wavs, labels=labels.numpy(), return_model_detail=True)
    loss = out["loss"].item()
    log(f"  forward with labels: loss {loss:.4f}, logits "
        f"{tuple(out['logits'].shape)}, predictions "
        f"{tuple(out['predictions'].shape)}, "
        f"shape_before_length_adapter {out['shape_before_length_adapter']}")
    if not math.isfinite(loss):
        raise AssertionError(f"API forward: loss {loss}")
    batch, lens = api._prepare_audio(wavs, encoder_cfg=model.config.encoder,
                                     device=model.device)
    direct = lambda **kw: generation.generate(  # noqa: E731
        model.params, model.config, batch, lens, max_length=MAX_LEN,
        dtype=torch.bfloat16, **kw)[0]
    for mode, kwargs in (("greedy", {}), ("beam-4", {"num_beams": BEAMS})):
        counts[f"api-{mode}"], got, _ = serve_mode(
            f"API {mode} generate",
            lambda kw=kwargs: model.generate(wavs, max_length=MAX_LEN, **kw),
            serving_launches(mode, MAX_LEN, fused_extractor=False), card,
            BATCH * SECONDS)
        tokens_equal(f"API {mode} vs generation.generate on its parameters",
                     got, direct(**kwargs))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        model.save_pretrained(tmp)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = api.SpeechMixEED.from_pretrained(tmp)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    got = dict(tree_paths(back.params))
    if any(not torch.equal(got[p], t) for p, t in tree_paths(model.params)):
        raise AssertionError("from_pretrained: parameters differ")
    tokens_equal(f"save_pretrained ({t_save:.2f} s) -> from_pretrained "
                 f"({t_load:.2f} s): parameters bit-identical, greedy",
                 back.generate(wavs, max_length=MAX_LEN),
                 model.generate(wavs, max_length=MAX_LEN))


def _pipeline_utterances(seed):
    """PIPELINE_UTTERANCES waveforms of 1-30 s from the seed: two longer
    than the largest bucket (20 s), one shorter than a conv frame, the rest
    over the buckets, at loudness from 0.01 to 1."""
    import numpy as np
    rng = np.random.RandomState(seed)
    secs = rng.uniform(1.0, 20.0, PIPELINE_UTTERANCES)
    secs[[5, 40]] = (27.3, 30.0)
    n = (secs * 16000).astype(int)
    n[17] = 300
    gains = 10.0 ** rng.uniform(-2, 0, PIPELINE_UTTERANCES)
    return [(rng.randn(k) * g).astype(np.float32) for k, g in zip(n, gains)]


class IdTokenizer:
    """Token ids as text, each as its decimal number, so that a transcript
    carries every token the decoder chose (the byte tokenizer, the port's
    stand-in without a local HF tokenizer, has no text for most of
    bart-base's ids)."""

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(i)) for i in ids)


def check_bucket_shapes(params, cfg, pipe, by_cap):
    """The first batch of each of the pipeline's buckets (`by_cap`: its
    segments by padded length; `pipe` transfers float32): the text
    encoder's output (K6, K1, K2 and K3 at the bucket's lengths) in bf16
    and in f32 through the kernels against the f32 plain path, and the f32
    greedy tokens through the kernels (K4 at the bucket's key length, with
    exact launches) equal to the plain path's."""
    import torch
    from speechmix_tpu_torch import generation
    from speechmix_tpu_torch.ops import kernels
    from speechmix_tpu_torch.ops.kernels import decode_attention as kd
    p32 = _cast_tree(params, torch.float32)
    want = f32_generate_launches("greedy", MAX_LEN)
    for cap in sorted(by_cap):
        chunk = by_cap[cap][:BATCH]
        chunk += [chunk[-1]] * (BATCH - len(chunk))
        host, lens, _ = pipe._host_batch(chunk, cap)
        wav = torch.from_numpy(host).to(pipe.device)
        lengths = torch.from_numpy(lens).to(pipe.device)
        run = lambda: generation.generate(  # noqa: E731
            p32, cfg, wav, lengths, max_length=MAX_LEN,
            dtype=torch.float32)[0]
        k4 = collections.Counter()
        kd.KERNEL.launch = _tally_by_length(kd.KERNEL, k4, 2)
        try:
            out_bf16, mask = encoder_output(params, cfg, wav, lengths,
                                            torch.bfloat16)
            out_k32, _ = encoder_output(p32, cfg, wav, lengths,
                                        torch.float32)
            kernels.reset_launch_counts()
            tokens = run()
            launched = _launches()
        finally:
            del kd.KERNEL.launch   # the class's own again
        if launched != want:
            raise AssertionError(f"bucket {cap}: f32 greedy launches "
                                 f"{launched}, expected {want}")
        with plain_kernels():
            kernels.reset_launch_counts()
            ref, _ = encoder_output(p32, cfg, wav, lengths, torch.float32)
            ref_tokens = run()
            if any(k.launches for k in kernels.kernels()):
                raise AssertionError("the plain reference launched a kernel")
        valid = mask[..., None].float()
        errs = []
        for name, a, bound in (("bf16", out_bf16, REL_BOUND_BF16),
                               ("f32", out_k32, REL_BOUND_F32)):
            r = (((a - ref) * valid).norm() / (ref * valid).norm()).item()
            if not (torch.isfinite(a).all() and r <= bound):
                raise AssertionError(f"bucket {cap}: {name} text-encoder "
                                     f"output relative error {r} > {bound}")
            errs.append(f"{name} {r:.3e} (bound {bound})")
        keys = sorted(t for _, t in k4 if t != MAX_LEN)
        tokens_equal(f"bucket {cap} samples ({mask.shape[1]} text-encoder "
                     f"positions, K4 cross-attention over {keys} keys): "
                     f"text-encoder output vs the f32 plain path "
                     f"{', '.join(errs)}; f32 greedy, kernels vs plain path",
                     tokens, ref_tokens)


def serve_pipeline(seed, card, counts, by_length):
    """TranscriptionPipeline(model, batch_size=16) over the utterances of
    _pipeline_utterances, with float32 and int16 transfer, the model the
    flagship's (fused extractor, bf16) with IdTokenizer: order, chunking
    and the short input, every transcript equal to the text of a direct
    generate() of its bucket's batch, wall time and audio-s/s; then the
    kernels at each bucket's shapes against their plain versions
    (check_bucket_shapes) and the busy share of a profiled float32 run.
    K4's launches by key length go into by_length."""
    import torch
    from speechmix_tpu_torch import api, generation
    from speechmix_tpu_torch.data import audio
    from speechmix_tpu_torch.ops import kernels
    from speechmix_tpu_torch.ops.kernels import decode_attention as kd
    from speechmix_tpu_torch.pipeline import TranscriptionPipeline
    cfg = flagship_config()
    model = api.SpeechMixEED(cfg.encoder, cfg.decoder, down_scale=2,
                             dtype="bfloat16", seed=seed)
    model.tokenizer = IdTokenizer()
    # the random flagship ends its rows at the first steps; EOS lowered, the
    # rows run every step, as a 16 s utterance's transcript would
    model.params["nlp"]["final_logits_bias"][cfg.decoder.eos_token_id] -= \
        EOS_LOW
    wavs = _pipeline_utterances(seed)
    total_s = sum(len(w) for w in wavs) / 16000
    for dtype in ("float32", "int16"):
        pipe = TranscriptionPipeline(model, batch_size=BATCH,
                                     max_length=MAX_LEN,
                                     transfer_dtype=dtype)
        t0 = time.perf_counter()
        pipe.warmup()
        t_warm = time.perf_counter() - t0
        calls = []
        real = generation.generate

        def spy(*a, **kw):
            calls.append(tuple(a[2].shape))
            return real(*a, **kw)
        from speechmix_tpu_torch import pipeline as pipe_mod
        pipe_mod.gen_lib.generate = spy
        k4_lengths = collections.Counter()
        kd.KERNEL.launch = _tally_by_length(kd.KERNEL, k4_lengths, 2)
        try:
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            texts = pipe(wavs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            pipe_mod.gen_lib.generate = real
            del kd.KERNEL.launch   # the class's own again
        run_counts = _launches()
        counts[f"pipeline-{dtype}"] = run_counts
        by_length[f"pipeline-{dtype}"] = dict(k4_lengths)
        per_call = serving_launches("greedy", 0)
        for sym in ("smx_attention_fwd", "smx_dense_res_ln",
                    "smx_conv_ln_gelu", "smx_ffn_up"):
            if run_counts[sym] != per_call[sym] * len(calls):
                raise AssertionError(f"pipeline: {sym} {run_counts[sym]} "
                                     f"launches in {len(calls)} calls")
        if run_counts["smx_decode_attention"] % (2 * DECODER_LAYERS):
            raise AssertionError("pipeline: K4 launches not whole steps")
        # the expected transcripts: every segment alone in a direct batch
        # of its bucket (rows do not interact), with the int16 round trip
        segs = []          # (utterance, segment, waveform)
        for i, w in enumerate(wavs):
            parts = (pipe.split_long(w)
                     if len(w) > pipe.buckets_sec[-1] * 16000 else [w])
            segs += [(i, j, p) for j, p in enumerate(parts)]
        by_cap = collections.defaultdict(list)
        for i, j, w in segs:
            if len(w) >= pipe._min_samples:
                cap = cfg.encoder.aligned_samples(
                    audio.bucket_length(len(w), pipe.buckets_sec))
                by_cap[cap].append((i, j, w))
        seg_text = {(i, j): "" for i, j, _ in segs}
        with spending("pipeline reference batches"):
            for cap, items in by_cap.items():
                for start in range(0, len(items), BATCH):
                    chunk = items[start:start + BATCH]
                    chunk += [chunk[-1]] * (BATCH - len(chunk))
                    host, lens, scale = pipe._host_batch(chunk, cap)
                    x = torch.from_numpy(host).to(model.device)
                    if dtype == "int16":
                        x = x.float() * (torch.from_numpy(scale).to(
                            model.device)[:, None] / 32767.0)
                    tok, _ = real(model.params, cfg, x,
                                  torch.from_numpy(lens).to(model.device),
                                  max_length=MAX_LEN, dtype=torch.bfloat16)
                    tok = tok.cpu().numpy()
                    for r, (i, j, _) in enumerate(chunk[:BATCH]):
                        seg_text[(i, j)] = model.tokenizer.decode(
                            tok[r], skip_special_tokens=True)
        want = []
        for i in range(len(wavs)):
            parts = [seg_text[k] for k in sorted(seg_text) if k[0] == i]
            want.append(" ".join(p for p in parts if p).strip()
                        if len(parts) > 1 else parts[0])
        if texts != want:
            bad = [i for i, (a, b) in enumerate(zip(texts, want)) if a != b]
            raise AssertionError(f"pipeline {dtype}: transcripts {bad} "
                                 "differ from direct generate()")
        filled = sum(bool(t) for t in texts)
        if texts[17] != "" or len(texts) != len(wavs) or \
                filled != len(wavs) - 1:
            raise AssertionError(f"pipeline: the short input, the count or "
                                 f"an empty transcript ({filled} filled)")
        busy = ""
        if dtype == "float32":
            with spending("f32 checks"):
                check_bucket_shapes(model.params, cfg, pipe, by_cap)
            with spending("profiled calls"):
                wall_us, busy_us, _ = profile_call(lambda: pipe(wavs))
            busy = (f"; profiled call busy {busy_us / wall_us:.3f} of "
                    f"{wall_us / 1e3:.1f} ms")
        log(f"pipeline ({dtype} transfer): {len(wavs)} utterances "
            f"({total_s:.1f} s of audio; 2 chunked, 1 too short), "
            f"{len(calls)} generate calls at {sorted(set(calls))}, "
            f"{wall * 1e3:.1f} ms, audio-seconds per second "
            f"{total_s / wall:.2f}; warmup {t_warm:.2f} s{busy}; "
            f"transcripts in order, each equal to a direct generate() of "
            f"its bucket's batch; launches "
            f"{ {k: v for k, v in run_counts.items() if v} }, K4 by key "
            f"length { {f'{k[0]} {k[1]}': n for k, n in sorted(k4_lengths.items())} } on {card}")
    del model


def run_serving(seed, card):
    """The serving surface at the flagship's full width and depth, B =
    BATCH x SECONDS s, MAX_LEN steps, bf16: int8 weights (greedy,
    greedy-int8, beam-4), fused q/k/v, the CTC head and its training, the
    checkpoint loaders, the API classes and the transcription pipeline.
    Returns ({mode: launches of a call, step or pipeline run}, {pipeline
    mode: K4's launches by (entry, key length)})."""
    import torch
    t_start = time.perf_counter()
    cfg, params, wav, lengths = flagship_inputs(seed)
    counts, by_length = {}, {}
    spent = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.empty_cache()
        spent[name] = time.perf_counter() - t0
    with torch.no_grad():
        part("int8 and fused", serve_int8_and_fused, cfg, params, wav,
             lengths, card, counts)
    part("CTC", serve_ctc, seed, cfg, wav, lengths, card, counts)
    with torch.no_grad():
        part("loaders", serve_loaders, cfg, params, wav, lengths, card,
             counts)
    del params
    part("API", serve_api, seed, wav, lengths, card, counts)
    part("pipeline", serve_pipeline, seed, card, counts, by_length)
    log(f"serving phase: {time.perf_counter() - t_start:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in spent.items())
        + "); across the parts: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in SERVING_SPENT.items()))
    return counts, by_length


# -- phases of the commands, remat, the profiler and the native runtime ----

# K number -> the entries that launch it (bf16, f32); K9 and K13 share the
# down pass (smx_ffn_down, smx_ffn_down_f32): K13's in a run with dropout,
# K9's without (kernel_launches)
K_ENTRIES = {
    "K1": ("smx_attention_fwd",), "K2": tuple(DENSE_ENTRIES.values()),
    "K3": ("smx_ffn_down_res", "smx_ffn_down_res_f32"),
    "K4": ("smx_decode_attention", "smx_decode_attention_q8"),
    "K5": ("smx_beam_gather",), "K6": ("smx_conv_ln_gelu",),
    "K7": ("smx_attention_bwd",), "K8": tuple(K8_ALL),
    "K9": ("smx_ffn_down", "smx_ffn_down_f32"),
    "K10": ("smx_dropout_mask",),
    "K11": tuple(DENSE_DROPOUT_ENTRIES.values()),
    "K12": ("smx_ffn_dropout_down_res", "smx_ffn_dropout_down_res_f32"),
    "K13": ("smx_ffn_down", "smx_ffn_down_f32"),
    "K14": ("smx_attention_dropout_fwd",),
    "K15": ("smx_attention_dropout_bwd",)}


def kernel_launches(counts, dropout):
    """Launches by K number in one run's counts; `dropout`: whether the
    run's FFN down passes (smx_ffn_down, smx_ffn_down_f32) are K13's, else
    K9's."""
    out = {k: sum(counts.get(e, 0) for e in entries)
           for k, entries in K_ENTRIES.items()}
    out["K9" if dropout else "K13"] -= sum(
        counts.get(e, 0) for e in K_ENTRIES["K9"])
    return out


def remat_launches(speech_kept, enc_layers, dec_layers, dtype="bf16",
                   dropout=False, preln=False):
    """The launches remat adds to a train step whose layers all train:
    every layer's forward kernels once more, in the backward.  A post-LN
    layer: K1 (K14), K2 (K11), K3 (K12) and, in a decoder layer, the second
    K2 (K11) and with dropout K10's probability mask of its plain
    cross-attention; a pre-LN speech layer (preln): K1 (K14), K9 (K13) and
    with dropout K10's two output masks.  Masks that a backward regenerates
    (K11's, K12's) and the backward's own kernels are not forward
    launches."""
    nlp = enc_layers + dec_layers
    post = nlp + (0 if preln else speech_kept)
    attn, dense = (("smx_attention_dropout_fwd", "smx_dense_dropout_res_ln")
                   if dropout else ("smx_attention_fwd", "smx_dense_res_ln"))
    want = {attn: speech_kept + nlp, dense: post + dec_layers,
            **ffn_forward_launches(post, speech_kept if preln else 0, dtype,
                                   dropout)}
    if dropout:
        want["smx_dropout_mask"] = dec_layers + (2 * speech_kept if preln
                                                 else 0)
    return want


def with_remat(want, extra):
    out = dict(want)
    for k, v in extra.items():
        out[k] = out.get(k, 0) + v
    return out


def expected_postln_launches(kept, attn_bwd, ffn_bwd, enc_layers,
                             dec_layers):
    """Launches of every kernel in one train step with dropout off, of a
    post-LN speech encoder whose layers may be frozen: a kept layer runs K1,
    K2 and K3 forward; K7 where its attention's backward runs (attn_bwd
    layers) and, where its FFN block's backward runs (ffn_bwd), K9
    recomputing the FFN and K8.  The BART layers all run theirs."""
    nlp = enc_layers + dec_layers
    want = expected_train_launches(0, 0, 0)
    want.update({
        "smx_attention_fwd": kept + nlp,
        "smx_attention_bwd": attn_bwd + nlp,
        "smx_dense_res_ln": kept + nlp + dec_layers,
        **ffn_forward_launches(kept + nlp, ffn_bwd + nlp),
        **dict.fromkeys(K8_ENTRIES["bf16"], ffn_bwd + nlp)})
    return want


@contextlib.contextmanager
def fused_extractor_preset(name="wav2vec2-base"):
    """The preset `name` with the fused extractor (K6) for the block.  The
    preset itself says "auto", which runs the library convolution (the JAX
    package's "auto" runs XLA's); every flagship phase of this script takes
    the fused extractor, and so do the commands here."""
    import dataclasses
    from speechmix_tpu_torch import config
    presets = config.SPEECH_ENCODER_PRESETS
    saved = presets[name]
    presets[name] = dataclasses.replace(saved, extractor_impl="fused")
    try:
        yield
    finally:
        presets[name] = saved


def _captured(fn, *args):
    """fn(*args) with its standard output captured: (result, lines)."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue().splitlines()


COMMAND_STEPS = 4      # train command steps, the last an eval step
COMMAND_MAX_LEN = 64   # the eval command's --max_length


def run_commands(seed, card):
    """The port's commands at the flagship's width (wav2vec2-base +
    bart-base, down_scale 2, the fused extractor): `speechmix_tpu_torch.
    train` with the default recipe (Adafactor, dropout, freeze_epochs 3) in
    bf16 on the synthetic corpus at B = 16 for COMMAND_STEPS steps, an eval
    + greedy predict at the last; again with --no-dropout for one step; then
    `speechmix_tpu_torch.eval` on the final weights: --synthetic_eval 16
    with 4 beams, and one utterance greedy.  Checks each step's, eval's and
    predict's launches, the finite logged losses, the npz files (the JAX
    package's layout, the trained bits), the eval outputs, and that K1-K15
    all launched.  Returns the phase's counts by run."""
    import tempfile
    import numpy as np
    import torch
    from speechmix_tpu_torch import api, convert
    from speechmix_tpu_torch import eval as eval_cmd
    from speechmix_tpu_torch import train as train_cmd
    from speechmix_tpu_torch.models import speech_encoder
    from speechmix_tpu_torch.ops import kernels
    from speechmix_tpu_torch.ops.layers import FUSED_MIN_ROWS
    from speechmix_tpu_torch.training import freezing, trainer
    from speechmix_tpu_torch.training.checkpoint import load_pytree_npz

    t_phase = time.perf_counter()
    symbols = lambda: {k.symbol: k.launches for k in kernels.kernels()}
    delta = lambda a, b: {k: b[k] - a.get(k, 0) for k in b}
    steps, evals, predicts, final = [], [], [], {}
    orig_make = trainer.make_train_step
    orig_eval, orig_predict = trainer.Trainer.evaluate, trainer.Trainer.predict

    def make(cfg, tc, *a, **kw):
        step_fn = orig_make(cfg, tc, *a, **kw)

        def wrapped(state, batch, progress=0.0):
            torch.cuda.synchronize()
            before, t0 = symbols(), time.perf_counter()
            step = state.step
            state, metrics = step_fn(state, batch, progress)
            loss = metrics["loss"].item()
            dt = time.perf_counter() - t0
            steps.append(dict(step=step, progress=progress, ms=dt * 1e3,
                              counts=delta(before, symbols()), loss=loss,
                              tc=tc, cfg=cfg, params=state.params,
                              samples=batch["input_values"].shape[1],
                              labels=batch["labels"].shape[1],
                              skipped=metrics["layers_skipped"]))
            final["params"] = state.params
            return state, metrics
        return wrapped

    def timed(orig, into):
        def call(self, params, *a, **kw):
            batches = a[1] if orig is orig_eval else a[0]
            torch.cuda.synchronize()
            before, t0 = symbols(), time.perf_counter()
            out = orig(self, params, *a, **kw)
            torch.cuda.synchronize()
            into.append(dict(s=time.perf_counter() - t0, out=out,
                             counts=delta(before, symbols()),
                             batches=len(list(batches())),
                             max_length=kw.get("max_length"),
                             num_beams=kw.get("num_beams", 1)))
            return out
        return call

    out_dir = tempfile.mkdtemp(prefix="smx_train_cmd_")
    flagship = ["--speech_model_config", "wav2vec2-base",
                "--nlp_model_config", "bart-base", "--down_scale", "2"]
    train_argv = ["--HFSpeechMixEED", *flagship, "--bf16", "--synthetic",
                  "--batch", str(BATCH), "--grad_accum", "1",
                  "--max_steps", str(COMMAND_STEPS), "--logging_steps", "1",
                  "--eval_step", str(COMMAND_STEPS),
                  "--predict_with_generate", "--seed", str(seed),
                  "--output_dir", out_dir]
    runs = {}
    trainer.make_train_step = make
    trainer.Trainer.evaluate = timed(orig_eval, evals)
    trainer.Trainer.predict = timed(orig_predict, predicts)
    try:
        with fused_extractor_preset():
            log(f"train command: python -m speechmix_tpu_torch.train "
                f"{' '.join(train_argv)} (the wav2vec2-base preset with the "
                f"fused extractor)")
            kernels.reset_launch_counts()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, lines = _captured(train_cmd.main, train_argv)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            runs["train"] = symbols()
            for line in lines:
                log(f"  | {line}")
            train_steps, train_evals, train_predicts = (
                list(steps), list(evals), list(predicts))
            weights = os.path.join(out_dir, "final_weights.npz")
            final_params = final.pop("params")

            # the deterministic step (K7, K9 and K8's deterministic entries
            # run only there)
            det_dir = tempfile.mkdtemp(prefix="smx_train_cmd_det_")
            det_argv = [a for a in train_argv
                        if a not in ("--predict_with_generate",)]
            det_argv[det_argv.index("--max_steps") + 1] = "1"
            det_argv[det_argv.index("--eval_step") + 1] = "100"
            det_argv[det_argv.index("--output_dir") + 1] = det_dir
            det_argv.append("--no-dropout")
            steps.clear()
            kernels.reset_launch_counts()
            _, det_lines = _captured(train_cmd.main, det_argv)
            runs["train --no-dropout"] = symbols()
            det_steps = list(steps)
            final.pop("params")
            shutil.rmtree(det_dir, ignore_errors=True)

            # the eval command on the trained weights
            eval_runs = {
                "eval --synthetic_eval 16 --beam 4": [
                    *flagship, "--weights", weights, "--synthetic_eval",
                    str(BATCH), "--batch", str(BATCH), "--beam",
                    str(BEAMS), "--max_length", str(COMMAND_MAX_LEN)],
                "eval (one utterance, greedy)": [
                    *flagship, "--weights", weights, "--max_length",
                    str(COMMAND_MAX_LEN)]}
            eval_out, eval_s = {}, {}
            predicts.clear()
            for name, argv in eval_runs.items():
                kernels.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, eval_out[name] = _captured(eval_cmd.main, argv)
                torch.cuda.synchronize()
                eval_s[name] = time.perf_counter() - t0
                runs[name] = symbols()
            eval_predicts = list(predicts)

            # the final weights: the JAX package's npz layout, the trained
            # bits, and the API's float32 model loads them
            stored = load_pytree_npz(weights)
            want_paths = convert.flatten_with_paths(
                convert.params_to_jax_paths(final_params))
            if list(stored) != [path for path, _ in want_paths]:
                raise AssertionError("train command: final_weights.npz "
                                     "paths differ from the JAX layout")
            for path, value in want_paths:
                if not np.array_equal(stored[path], value):
                    raise AssertionError(f"train command: {path} in "
                                         "final_weights.npz differs from "
                                         "the trained parameters")
            model = api.HFSpeechMixEED("wav2vec2-base", "bart-base",
                                       down_scale=2)
            model.load_weights(weights)
            loaded = _fingerprints(model.params)
            if loaded != _fingerprints(final_params):
                raise AssertionError("train command: the API model's "
                                     "loaded parameters differ")
            del model
    finally:
        trainer.make_train_step = orig_make
        trainer.Trainer.evaluate = orig_eval
        trainer.Trainer.predict = orig_predict
        shutil.rmtree(out_dir, ignore_errors=True)

    enc, dec = (train_steps[0]["cfg"].encoder, train_steps[0]["cfg"].decoder)
    cfg, tc = train_steps[0]["cfg"], train_steps[0]["tc"]
    if not (tc.optimizer == "adafactor" and tc.dropout and tc.bf16
            and tc.freeze_epochs == 3 and enc.extractor_impl == "fused"):
        raise AssertionError(f"train command: config {tc}, extractor "
                             f"{enc.extractor_impl}")
    # (1) every step: its launches, its LayerDrop draw, a finite loss
    records = [json.loads(l) for l in lines if l.startswith("{")]
    logged = [r for r in records if "grad_norm" in r]
    if [r["step"] for r in logged] != list(range(1, COMMAND_STEPS + 1)) or \
            not all(math.isfinite(r["loss"]) for r in logged):
        raise AssertionError(f"train command: logged {logged}")
    for rec in train_steps + det_steps:
        frames = int(enc.feature_lengths(rec["samples"]))
        rows = (BATCH * frames, BATCH * (frames // cfg.down_scale),
                BATCH * rec["labels"])
        if min(rows) < FUSED_MIN_ROWS:
            raise AssertionError(f"train command: rows {rows} below the "
                                 "fused gate")
        mask = freezing.reference_unfreeze_scale(
            rec["params"], freezing.unfreeze_epoch(rec["progress"],
                                                   rec["tc"].freeze_epochs),
            rec["tc"].freeze_epochs)
        if rec["tc"].dropout:
            skipped = layerdrop_replay(trainer, speech_encoder, rec["tc"],
                                       cfg, rec["step"])
        else:
            skipped = []
        kept = [l for l in range(enc.num_layers) if l not in skipped]
        attn, dense, ffn = postln_backward_layers(mask["speech_encoder"],
                                                  kept)
        if rec["tc"].dropout:
            want = expected_postln_dropout_launches(
                len(kept), len(attn), len(dense), len(ffn),
                dec.encoder_layers, dec.decoder_layers)
        else:
            want = expected_postln_launches(len(kept), len(attn), len(ffn),
                                            dec.encoder_layers,
                                            dec.decoder_layers)
        want.update(conv_backward_launches(mask["speech_encoder"]))
        what = "step" if rec["tc"].dropout else "--no-dropout step"
        log(f"  train command {what} {rec['step'] + 1} (progress "
            f"{rec['progress']}, {rec['samples'] / 16000:.2f} s bucket, rows "
            f"{' / '.join(map(str, rows))}): loss {rec['loss']:.4f}, "
            f"{rec['ms']:.1f} ms, LayerDrop skipped {skipped}, backward of "
            f"attention / epilogue / FFN in {len(attn)} / {len(dense)} / "
            f"{len(ffn)} of {len(kept)} kept speech layers")
        if rec["skipped"] != [skipped]:
            raise AssertionError(f"train command: LayerDrop skipped "
                                 f"{rec['skipped']}, the key chain gives "
                                 f"{skipped}")
        if rec["counts"] != want:
            raise AssertionError(f"train command {what} {rec['step'] + 1}: "
                                 f"launches {rec['counts']}, expected {want}")
        if not math.isfinite(rec["loss"]):
            raise AssertionError(f"train command: loss {rec['loss']}")
    # (2) the eval and the predict at the last step
    want_eval = expected_eval_launches(enc.num_layers, dec.encoder_layers,
                                       dec.decoder_layers)
    want_pred = expected_launches("greedy", dec.max_length)
    eval_recs = [r for r in records if "eval_loss" in r]
    if len(train_evals) != 1 or len(train_predicts) != 1 or \
            [r["step"] for r in eval_recs] != [COMMAND_STEPS]:
        raise AssertionError(f"train command: evals {eval_recs}")
    ev, pr = train_evals[0], train_predicts[0]
    for rec, per_batch, what in ((ev, want_eval, "eval"),
                                 (pr, want_pred, "predict")):
        want = {k: v * rec["batches"] for k, v in per_batch.items()}
        if rec["counts"] != want:
            raise AssertionError(f"train command {what}: launches "
                                 f"{rec['counts']}, expected {want}")
    r = eval_recs[0]
    if not all(math.isfinite(r[k]) for k in ("eval_loss", "predict_wer",
                                             "predict_cer")):
        raise AssertionError(f"train command: eval record {r}")
    log(f"  train command eval at step {r['step']}: eval_loss "
        f"{r['eval_loss']:.4f}, cer {r['cer']:.4f}, wer {r['wer']:.4f}, "
        f"predict_wer {r['predict_wer']:.4f} over {r['n_examples']} "
        f"({ev['batches']} batches: eval {ev['s'] * 1e3:.1f} ms, greedy "
        f"predict at max_length {dec.max_length} {pr['s'] * 1e3:.1f} ms); "
        f"launches as expected_eval_launches / expected_launches('greedy')")
    ms = [rec["ms"] for rec in train_steps]
    audio = BATCH * train_steps[-1]["samples"] / 16000
    med = sorted(ms[1:])[len(ms[1:]) // 2]
    log(f"  train command: {train_s:.1f} s for model, data, "
        f"{COMMAND_STEPS} steps, eval, predict, a checkpoint and the final "
        f"weights; steps {', '.join(f'{t:.1f}' for t in ms)} ms (B={BATCH} "
        f"x {audio / BATCH:.2f} s padded: {audio * 1e3 / med:.2f} audio-s/s "
        f"at the median of steps 2-{COMMAND_STEPS}, {med:.1f} ms), peak "
        f"memory {peak / 2 ** 30:.2f} GiB on {card}")
    log(f"  final_weights.npz: {len(stored)} arrays in the JAX package's "
        f"layout, the trained parameters' bits; HFSpeechMixEED.load_weights "
        f"(float32) holds the same bits")
    det = det_steps[0]
    log(f"  train command --no-dropout: 1 step, loss {det['loss']:.4f}, "
        f"{det['ms']:.1f} ms; " + " | ".join(det_lines[:1]))

    # (3) the eval command's outputs and launches
    synth, one = eval_out.values()
    synth_name, one_name = eval_runs
    metrics = json.loads(synth[-1])
    if metrics.get("n_examples") != BATCH or not all(
            math.isfinite(metrics[k]) for k in ("predict_wer",
                                                "predict_cer")):
        raise AssertionError(f"eval command: {synth}")
    decoded = [l for l in one if l.startswith("decoded:")]
    refs = [l for l in one if l.startswith("reference text:")]
    if len(decoded) != 1 or len(refs) != 1:
        raise AssertionError(f"eval command: output {one}")
    want = f32_generate_launches("beam-4", COMMAND_MAX_LEN)
    if runs[synth_name] != want or len(eval_predicts) != 1 or \
            eval_predicts[0]["batches"] != 1:
        raise AssertionError(f"eval command {synth_name}: launches "
                             f"{runs[synth_name]}, expected {want}")
    # one utterance of 1-3 s: its rows are below the fused gate, so K2 /
    # K3 give way to the plain chain, as in every decode step
    want = expected_launches("greedy", COMMAND_MAX_LEN)
    want.update({**dense_launches(0), **ffn_forward_launches(0, 0)})
    if runs[one_name] != want:
        raise AssertionError(f"eval command {one_name}: launches "
                             f"{runs[one_name]}, expected {want}")
    for name in eval_runs:
        k = kernel_launches(runs[name], dropout=False)
        log(f"  {name}: {eval_s[name]:.2f} s (f32, as the JAX package's "
            f"eval.py), launches " + ", ".join(
                f"{n} {k[n]}" for n in ("K1", "K2", "K3", "K4", "K5", "K6")))
        for line in eval_out[name]:
            log(f"  | {line}")
    across = collections.Counter()
    for name in ("eval --synthetic_eval 16 --beam 4",
                 "eval (one utterance, greedy)"):
        across.update(kernel_launches(runs[name], dropout=False))
    if any(across[k] < 1 for k in ("K1", "K2", "K3", "K4", "K5", "K6")):
        raise AssertionError(f"eval command: launches {dict(across)}")
    for name, counts in runs.items():
        across.update(kernel_launches(counts, dropout=(name == "train")))
    missing = [k for k in K_ENTRIES if across[k] < 1]
    log(f"  kernels launched across the commands: " + ", ".join(
        f"{k} {across[k]}" for k in K_ENTRIES))
    if missing:
        raise AssertionError(f"commands: {missing} never launched")
    log(f"commands phase: {time.perf_counter() - t_phase:.1f} s")
    return runs


REMAT_KEY_SEED = 0x5EED
REMAT_TIMED_STEPS = 3   # train steps timed each way, in turns


def run_remat(seed, card):
    """remat off and on for one train step of the flagship and of the
    large pair (bf16 compute, f32 weights, dropout on with one key, every
    leaf training): the loss equal, every gradient leaf bit-identical where
    two remat-off steps are (cuDNN asked for deterministic algorithms) and
    otherwise within GRAD_REL / GRAD_FLOOR, the launches with
    remat_launches added, the bytes the forward leaves allocated; then
    REMAT_TIMED_STEPS train steps each way in turns: median ms and peak
    memory."""
    import dataclasses
    import torch
    from speechmix_tpu_torch.models import speechmix
    from speechmix_tpu_torch.ops import kernels
    from speechmix_tpu_torch.ops.kernels.dropout import DropoutKey
    from speechmix_tpu_torch.training import trainer
    from speechmix_tpu_torch.training.freezing import tree_map, tree_paths

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    key = DropoutKey.from_seed(seed + REMAT_KEY_SEED)
    symbols = lambda: {k.symbol: k.launches for k in kernels.kernels()}

    def remat_cfg(cfg, on):
        return dataclasses.replace(
            cfg, encoder=dataclasses.replace(cfg.encoder, remat=on),
            decoder=dataclasses.replace(cfg.decoder, remat=on))

    for name, cfg, b in (("flagship", flagship_config(), BATCH),
                         ("large pair", large_config(), LARGE_BATCH)):
        enc, dec = cfg.encoder, cfg.decoder
        gen = torch.Generator(device=dev).manual_seed(seed)
        batch = _train_batch(cfg, gen, dev, b, SECONDS, TRAIN_LABELS)
        params = speechmix.init_speechmix(cfg, gen, dev, torch.float32)

        def grads(on):
            """(loss, LayerDrop's skips, launches, gradients, the bytes
            the forward left allocated for the backward)."""
            leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            out = speechmix.speechmix_forward(
                leaves, remat_cfg(cfg, on), batch["input_values"],
                lengths=batch["lengths"], labels=batch["labels"],
                dtype=torch.bfloat16, dropout_rng=key)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated() - base
            flat = [(p, l) for p, l in tree_paths(leaves)]
            g = torch.autograd.grad(out["loss"], [l for _, l in flat],
                                    allow_unused=True)
            torch.cuda.synchronize()
            return (out["loss"].item(), out["layers_skipped"], symbols(),
                    {p: x for (p, _), x in zip(flat, g) if x is not None},
                    held)

        torch.backends.cudnn.deterministic = True
        try:
            runs = [grads(False), grads(False), grads(True)]
        finally:
            torch.backends.cudnn.deterministic = False
        (loss0, skip0, counts0, g0, held0), (loss1, _, _, g1, _), \
            (loss2, skip2, counts2, g2, held2) = runs
        kept = enc.num_layers - len(skip0)
        if enc.do_stable_layer_norm:
            want = expected_preln_train_launches(
                kept, kept, kept, dec.encoder_layers, dec.decoder_layers,
                dropout=True)
        else:
            want = expected_dropout_train_launches(
                kept, dec.encoder_layers, dec.decoder_layers)
        want_remat = with_remat(want, remat_launches(
            kept, dec.encoder_layers, dec.decoder_layers, dropout=True,
            preln=enc.do_stable_layer_norm))
        if counts0 != want or counts2 != want_remat or skip2 != skip0:
            raise AssertionError(f"remat {name}: launches off {counts0} / "
                                 f"on {counts2}, expected {want} / "
                                 f"{want_remat}")
        if loss2 != loss0 or loss1 != loss0 or g2.keys() != g0.keys():
            raise AssertionError(f"remat {name}: losses {loss0} / {loss1} "
                                 f"/ {loss2}")
        top = max(g.abs().max().item() for g in g0.values())
        same = [p for p in g0 if torch.equal(g0[p], g1[p])]
        worst, unequal = 0.0, []
        for p in g0:
            if torch.equal(g2[p], g0[p]):
                continue
            if p in same:
                unequal.append(p)
            limit = GRAD_REL * g0[p].abs().max().item() + GRAD_FLOOR * top
            worst = max(worst, (g2[p] - g0[p]).abs().max().item() / limit)
        log(f"  remat {name} (B={b} x {SECONDS} s, bf16, dropout on, one "
            f"key, LayerDrop skipped {skip0}): loss {loss0:.6f} with and "
            f"without; {len(same)} of {len(g0)} gradient leaves "
            f"bit-identical between two remat-off runs, "
            f"{sum(torch.equal(g2[p], g0[p]) for p in g0)} between remat on "
            f"and off, worst err/limit elsewhere {worst:.3f}; the forward "
            f"leaves {held0 / 2 ** 30:.2f} GiB allocated for the backward "
            f"off, {held2 / 2 ** 30:.2f} on; launches on "
            f"= off + remat_launches: " + ", ".join(
                f"{k} +{v}" for k, v in sorted(remat_launches(
                    kept, dec.encoder_layers, dec.decoder_layers,
                    dropout=True, preln=enc.do_stable_layer_norm).items())
                if v))
        if unequal or worst > 1.0:
            raise AssertionError(f"remat {name}: gradients differ: "
                                 f"{unequal[:5]}, worst {worst}")
        del runs, g0, g1, g2

        # a whole train step each way, in turns (off, on, off, on, off,
        # on): the median ms and the largest peak memory of each, the
        # bytes the step requested (the caching allocator's allocated
        # bytes count whole cached blocks that a request takes unsplit,
        # which depends on what ran before: the flagship's peaks, equal in
        # requested bytes, differ by ~2 MB there)
        tc = trainer.TrainConfig(learning_rate=TRAIN_LR, warmup_steps=1,
                                 bf16=True, seed=seed)
        state = trainer.TrainState(
            params, trainer.make_optimizer(tc).init(params), 0)
        step_fns = {on: trainer.make_train_step(remat_cfg(cfg, on), tc,
                                                params) for on in (0, 1)}
        ms, peaks = {0: [], 1: []}, {0: 0, 1: 0}
        for on in (0, 1) * REMAT_TIMED_STEPS:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, metrics = step_fns[on](state, batch)
            torch.cuda.synchronize()
            ms[on].append((time.perf_counter() - t0) * 1e3)
            peaks[on] = max(peaks[on], torch.cuda.memory_stats()[
                "requested_bytes.all.peak"])
            if not math.isfinite(metrics["loss"].item()):
                raise AssertionError(f"remat {name}: loss {metrics}")
        med = {on: sorted(t)[len(t) // 2] for on, t in ms.items()}
        log(f"  remat {name} train step (Adafactor, dropout on; "
            f"{REMAT_TIMED_STEPS} each, in turns): off {med[0]:.1f} ms "
            f"({', '.join(f'{t:.1f}' for t in ms[0])}), peak requested "
            f"{peaks[0] / 2 ** 30:.2f} GiB; on {med[1]:.1f} ms "
            f"({', '.join(f'{t:.1f}' for t in ms[1])}), peak requested "
            f"{peaks[1] / 2 ** 30:.2f} GiB ({peaks[1] / peaks[0]:.3f} of the "
            f"memory, {med[1] / med[0]:.3f}x the time) on {card}")
        if peaks[1] > peaks[0]:
            raise AssertionError(f"remat {name}: peak memory {peaks}")
        del state, params, step_fns, batch
        torch.cuda.empty_cache()
    log(f"remat phase: {time.perf_counter() - t_phase:.1f} s")


def run_profiler(seed, card):
    """utils/profiling.trace around one flagship greedy generate, with
    annotate spans opened here; the trace file must hold the spans' names
    and K1's and K4's kernel names, so a trace that lost its CUDA events
    fails.  Returns the generate's tokens."""
    import tempfile
    import torch
    from speechmix_tpu_torch import generation
    from speechmix_tpu_torch.utils import profiling

    cfg, params, wav, lengths = flagship_inputs(seed)
    run = lambda: generation.generate(params, cfg, wav, lengths,
                                      max_length=MAX_LEN,
                                      dtype=torch.bfloat16)
    run()
    logdir = tempfile.mkdtemp(prefix="smx_trace_")
    spans = ("chip_smoke/greedy_generate", "chip_smoke/tokens_to_host")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profiling.trace(logdir):
            with profiling.annotate(spans[0]):
                tokens, _ = run()
            with profiling.annotate(spans[1]):
                tokens = tokens.cpu()
        wall = time.perf_counter() - t0
        files = [os.path.join(logdir, f) for f in os.listdir(logdir)
                 if f.endswith(".pt.trace.json")]
        if len(files) != 1:
            raise AssertionError(f"profiler: trace files {files}")
        size = os.path.getsize(files[0])
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    names = collections.Counter(e.get("name") for e in events)
    # device kernels by the launcher's name: K1's and K4's bodies
    device = collections.Counter()
    for e in events:
        if e.get("cat") == "kernel":
            for k in (ATTN_FWD_KERNEL, *DECODE_KERNELS):
                device[k] += k in e.get("name", "")
    missing = [s for s in spans if names[s] < 1]
    if device[ATTN_FWD_KERNEL] < 1:
        missing.append(f"K1 ({ATTN_FWD_KERNEL})")
    if not any(device[k] for k in DECODE_KERNELS):
        missing.append(f"K4 ({', '.join(DECODE_KERNELS)})")
    log(f"profiler: trace() around one greedy generate, {len(events)} "
        f"events, {size / 2 ** 20:.1f} MiB, {wall:.2f} s with the trace's "
        f"writing; spans {', '.join(f'{s} {names[s]}' for s in spans)}; "
        f"device kernels " + ", ".join(
            f"{k} {device[k]}" for k in (ATTN_FWD_KERNEL, *DECODE_KERNELS))
        + f" on {card}")
    if missing:
        raise AssertionError(f"profiler: the trace lacks {missing}")
    return tokens


NATIVE_UTTERANCES = 64
NATIVE_RATES = (8000, 22050, 44100, 48000)


def run_native(seed, card, tokens):
    """The native runtime on the card's host against the numpy plain
    versions: resample 64 synthetic utterances from each of 8, 22.05, 44.1
    and 48 kHz to 16 kHz (1e-6), normalize them (1e-6 + 1e-6 |x|), and
    WER / CER (edit distances, exact) of hypotheses against their
    transcripts: the greedy generate's decoded rows and the transcripts
    with seeded word and character edits.  Host ms both ways."""
    import numpy as np
    from speechmix_tpu_torch import metrics
    from speechmix_tpu_torch.data import audio, datasets
    from speechmix_tpu_torch.data.tokenizer import ByteTokenizer
    from speechmix_tpu_torch.runtime import native

    # the library is loaded since the commands' WER; built again here
    # from the source, to time the build
    native.lib_path().unlink(missing_ok=True)
    t0 = time.perf_counter()
    native.build()
    build_s = time.perf_counter() - t0
    raw = datasets.synthetic_corpus(NATIVE_UTTERANCES, seed=seed)
    wavs = [ex["audio"] for ex in raw]

    def timed(fn, repeat=3):
        """fn() and its median host ms over `repeat` calls."""
        times = []
        for _ in range(repeat):
            t = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t) * 1e3)
        return out, sorted(times)[len(times) // 2]

    parts = []
    for sr in NATIVE_RATES:
        got, ms_n = timed(lambda: [audio.resample(w, sr) for w in wavs])
        want, ms_p = timed(lambda: [audio.resample_plain(w, sr)
                                    for w in wavs], repeat=1)
        err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
        if any(len(g) != len(w) for g, w in zip(got, want)) or err > 1e-6:
            raise AssertionError(f"native resample from {sr}: err {err}")
        parts.append(f"resample {sr} Hz: {ms_n:.1f} / {ms_p:.1f} ms (err "
                     f"{err:.2e})")
    got, ms_n = timed(lambda: [audio.normalize(w) for w in wavs])
    want, ms_p = timed(lambda: [audio.normalize_plain(w) for w in wavs])
    ratio = max(float((np.abs(g - w) / (1e-6 + 1e-6 * np.abs(w))).max())
                for g, w in zip(got, want))
    if ratio > 1.0:
        raise AssertionError(f"native normalize: err/limit {ratio}")
    parts.append(f"normalize: {ms_n:.1f} / {ms_p:.1f} ms (err/limit "
                 f"{ratio:.3f})")
    rng = np.random.RandomState(seed)
    refs = [ex["text"] for ex in raw]
    tok = ByteTokenizer(vocab_size=50265)
    decoded = [tok.decode(row) for row in np.asarray(tokens)]
    hyps = []
    for i, ref in enumerate(refs):
        words = ref.split()
        keep = [w for w in words if rng.rand() > 0.2]
        if rng.rand() < 0.5:
            keep.insert(rng.randint(len(keep) + 1), "zzz")
        hyps.append(" ".join(keep) + " " + decoded[i % len(decoded)])
    saved = metrics._edit_distance
    (wer_n, cer_n), ms_n = timed(lambda: (metrics.wer(refs, hyps),
                                          metrics.cer(refs, hyps)))
    metrics._edit_distance = metrics._edit_distance_plain
    try:
        (wer_p, cer_p), ms_p = timed(lambda: (metrics.wer(refs, hyps),
                                              metrics.cer(refs, hyps)))
    finally:
        metrics._edit_distance = saved
    if (wer_n, cer_n) != (wer_p, cer_p):
        raise AssertionError(f"native edit distance: {wer_n, cer_n} vs "
                             f"{wer_p, cer_p}")
    parts.append(f"WER {wer_n:.4f} / CER {cer_n:.4f}: {ms_n:.1f} / "
                 f"{ms_p:.1f} ms, equal")
    audio_s = sum(len(w) for w in wavs) / 16000
    log(f"native runtime ({native.lib_path().name}, built in "
        f"{build_s:.2f} s) against numpy on {NATIVE_UTTERANCES} synthetic "
        f"utterances ({audio_s:.1f} s of audio), host ms native / numpy "
        f"(median of 3, numpy resample once): "
        + "; ".join(parts) + f"; host of {card}")


PARALLEL_MAX_LEN = 32          # the sharded pipeline's decode steps
GLOO_NOTE = "4 ranks sharing one card over gloo, not a multi-card time"


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def mesh_train_launches(cfg, speech_attn, kept=None, dropout=False):
    """Launches of every kernel in one step of the flagship on a rank of a
    tensor- or sequence-parallel mesh: the FFN and dense epilogues take the
    plain chain there (the JAX package's gate), so K2, K3, K8, K9 and their
    dropout twins never run; K1 / K7 (K14 / K15 with dropout) run on the
    local heads of every attention without a bias: `speech_attn` speech
    layers (0 when the ring takes them) and every text-encoder and decoder
    self-attention; K6 once per extractor layer.  With dropout every mask of
    the plain chain comes from K10, one launch per site whose rate is above
    0 (`kept` speech layers ran)."""
    enc, dec = cfg.encoder, cfg.decoder
    text = dec.encoder_layers + dec.decoder_layers
    want = expected_train_launches(0, 0, 0, dtype="f32")
    if not dropout:
        want.update({"smx_attention_fwd": speech_attn + text,
                     "smx_attention_bwd": speech_attn + text})
        return want
    live = lambda *rates: sum(1 for r in rates if r > 0)
    masks = (live(enc.feat_proj_dropout, enc.dropout, dec.dropout,
                  dec.dropout)
             + kept * live(enc.dropout, enc.activation_dropout, enc.dropout)
             + dec.encoder_layers * live(dec.dropout, dec.activation_dropout,
                                         dec.dropout)
             + dec.decoder_layers * live(dec.dropout, dec.attention_dropout,
                                         dec.dropout, dec.activation_dropout,
                                         dec.dropout))
    want.update({"smx_attention_dropout_fwd": kept + text,
                 "smx_attention_dropout_bwd": kept + text,
                 "smx_dropout_mask": masks})
    return want


def mesh_generate_launches(cfg, steps):
    """Launches of one greedy generate() of the flagship on a rank of a
    tensor-parallel mesh: K1 on the local heads of every encoder layer, K6,
    and K4 for the self- and cross-attention of every decoder layer and
    step; no K2 / K3 (the plain chain)."""
    want = expected_launches("greedy", steps)
    want.update({**dict.fromkeys(FWD_ENTRIES, 0), **dense_launches(0)})
    return want


def _launch_counts():
    from speechmix_tpu_torch.ops import kernels
    return {k.symbol: k.launches for k in kernels.kernels()}


def _parallel_model(seed, dtype):
    """The flagship as an API model in `dtype` for the sharded pipeline,
    EOS lowered so that every row runs every step, ids as text."""
    from speechmix_tpu_torch import api
    cfg = flagship_config()
    model = api.SpeechMixEED(cfg.encoder, cfg.decoder, down_scale=2,
                             dtype=dtype, seed=seed)
    model.tokenizer = IdTokenizer()
    model.params["nlp"]["final_logits_bias"][cfg.decoder.eos_token_id] -= \
        EOS_LOW
    return model


def _parallel_utterances(seed):
    import numpy as np
    rng = np.random.RandomState(seed + 17)
    return [(rng.randn(int(SECONDS * 16000)) * 0.1).astype(np.float32)
            for _ in range(BATCH)]


def _parallel_pipe(model, mesh=None):
    from speechmix_tpu_torch.pipeline import TranscriptionPipeline
    return TranscriptionPipeline(model, batch_size=BATCH,
                                 max_length=PARALLEL_MAX_LEN,
                                 early_stop=False, mesh=mesh)


def _f32_state_and_batch(seed, cfg, tc, dev):
    """The f32 flagship state and the B = BATCH x SECONDS batch of `seed`,
    drawn in one order, so that every process gets the same."""
    import torch
    from speechmix_tpu_torch.training import trainer
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = trainer.create_train_state(gen, cfg, tc, dev)
    return state, _train_batch(cfg, gen, dev, BATCH, SECONDS, TRAIN_LABELS)


def _grad_tc(zero1=False, model_parallel=1, sequence_parallel=1):
    from speechmix_tpu_torch.training import trainer
    return trainer.TrainConfig(
        learning_rate=TRAIN_LR, warmup_steps=1, grad_accum=1, bf16=False,
        dropout=False, optimizer="adamw", fixed_nlp=False, zero1=zero1,
        model_parallel=model_parallel, sequence_parallel=sequence_parallel)


def parallel_rank(rank, seed, ref_path, shapes):
    """One of the four ranks on cuda:0 (gloo): the f32 gradient of the
    flagship's step (layers rematerialised) at each mesh of `shapes`
    ((shape, zero1)) against the one-card reference in ref_path, its
    launches, ms per step, peak memory,
    optimizer bytes and bytes staged through the host; a bf16 dropout-on
    step at (2, 2, 1) twice from one state; the f32 and bf16 pipeline over
    (2, 2)."""
    import dataclasses
    import hashlib
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    from speechmix_tpu_torch.models import speech_encoder
    from speechmix_tpu_torch.ops import kernels
    from speechmix_tpu_torch.parallel import collectives
    from speechmix_tpu_torch.parallel import mesh as mesh_lib
    from speechmix_tpu_torch.training import sharded, trainer
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = flagship_config()
    out = {"rank": rank, "cases": []}

    def barrier():
        import torch.distributed as dist
        torch.cuda.synchronize()
        dist.barrier()

    ref = torch.load(ref_path, map_location="cpu") if rank == 0 else None
    # four f32 ranks of the full flagship share the card's memory: their
    # layers are rematerialised (the same gradients, bit for bit, PR 16;
    # each layer's forward, K1 included, runs again in the backward)
    remat = dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, remat=True),
        decoder=dataclasses.replace(cfg.decoder, remat=True))
    for shape, zero1 in shapes:
        mesh = mesh_lib.make_mesh(*shape, device=dev)
        tc = _grad_tc(zero1, shape[1], shape[2])
        full, batch = _f32_state_and_batch(seed, remat, tc, dev)
        state = trainer.shard_train_state(full, mesh, remat, tc)
        del full
        step_fn = trainer.make_train_step(remat, tc, state.params, mesh=mesh)
        local = mesh_lib.local_batch(mesh, batch)
        kernels.reset_launch_counts()
        collectives.reset_staged_bytes()
        grads, norm, metrics = step_fn.gradients(state, local)
        counts = _launch_counts()
        staged = collectives.STAGED_BYTES["count"]
        want = mesh_train_launches(cfg, 0 if shape[2] > 1 else
                                   cfg.num_speech_encoder_layers)
        want["smx_attention_fwd"] *= 2     # the recomputed forwards
        if counts != want:
            raise AssertionError(f"rank {rank} {shape}: launches {counts}, "
                                 f"expected {want}")
        whole = {p: sharded._gather_model(g, step_fn.layout.model_dim(t),
                                          mesh)
                 for (p, g), (_, t) in zip(trainer.tree_paths(grads),
                                           trainer.tree_paths(state.params))}
        case = {"shape": shape, "zero1": zero1, "coords": (
            mesh.data_rank, mesh.model_rank, mesh.seq_rank),
            "loss": metrics["loss"].item(), "grad_norm": norm.item(),
            "launches": {k: v for k, v in counts.items() if v},
            "staged_bytes": staged}
        if rank == 0:
            top = max(g.abs().max().item() for g in ref["grads"].values())
            worst, where = 0.0, None
            for path, want_g in ref["grads"].items():
                got = whole[path].float().cpu()
                limit = GRAD_REL * want_g.abs().max().item() + \
                    GRAD_FLOOR * top
                ratio = (got - want_g).abs().max().item() / limit
                if ratio > worst:
                    worst, where = ratio, path
            case.update(worst=worst, worst_path=where, leaves=len(whole),
                        ref_loss=ref["loss"], ref_norm=ref["grad_norm"])
        del grads, whole
        # time whole steps (update included), every rank in step
        times = []
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(1):
            barrier()
            t0 = time.perf_counter()
            state, _ = step_fn(state, local)
            barrier()
            times.append((time.perf_counter() - t0) * 1e3)
        plain = sharded.StepLayout(mesh, remat, state.params, tc.optimizer,
                                   False, shape[2] > 1)
        case.update(
            ms=times, peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
            opt_bytes=sharded.opt_state_bytes(state.opt_state),
            unsharded_opt_bytes=sharded.opt_state_bytes(
                trainer.make_optimizer(tc, plain).init(state.params)))
        out["cases"].append(case)
        del state, step_fn, local, batch
        torch.cuda.empty_cache()

    # bf16, dropout on (presets' rates, SpecAugment, LayerDrop), twice,
    # cuDNN's grouped conv backward deterministic in both
    torch.backends.cudnn.deterministic = True
    mesh = mesh_lib.make_mesh(2, 2, 1, device=dev)
    tc = trainer.TrainConfig(learning_rate=TRAIN_LR, warmup_steps=1,
                             grad_accum=1, bf16=True, dropout=True,
                             optimizer="adamw", seed=seed, zero1=True,
                             model_parallel=2)
    runs = []
    for _ in range(2):
        gen = torch.Generator(device=dev).manual_seed(seed)
        full = trainer.create_train_state(gen, cfg, tc, dev)
        batch = _train_batch(cfg, gen, dev, BATCH, SECONDS, TRAIN_LABELS)
        state = trainer.shard_train_state(full, mesh, cfg, tc)
        del full
        step_fn = trainer.make_train_step(cfg, tc, state.params, mesh=mesh)
        local = mesh_lib.local_batch(mesh, batch)
        skipped = layerdrop_replay(trainer, speech_encoder, tc, cfg, 0)
        kernels.reset_launch_counts()
        state, metrics = step_fn(state, local)
        counts = _launch_counts()
        want = mesh_train_launches(
            cfg, 0, cfg.num_speech_encoder_layers - len(skipped), True)
        if counts != want or metrics["layers_skipped"] != [skipped]:
            raise AssertionError(f"rank {rank} dropout step: launches "
                                 f"{counts}, expected {want}; skipped "
                                 f"{metrics['layers_skipped']} {skipped}")
        digest = hashlib.sha256()
        for _, t in trainer.tree_paths(state.params):
            digest.update(t.detach().cpu().numpy().tobytes())
        runs.append({"loss": metrics["loss"].item(), "skipped": skipped,
                     "params": digest.hexdigest(),
                     "launches": {k: v for k, v in counts.items() if v}})
        del state, step_fn, local, batch
        torch.cuda.empty_cache()
    out["dropout"] = runs

    # the pipeline over (2, 2), f32 and bf16
    mesh = mesh_lib.make_mesh(2, 2, 1, device=dev)
    wavs = _parallel_utterances(seed)
    out["pipeline"] = {}
    for dtype in ("float32", "bfloat16"):
        pipe = _parallel_pipe(_parallel_model(seed, dtype), mesh)
        kernels.reset_launch_counts()
        barrier()
        t0 = time.perf_counter()
        texts = pipe(wavs)
        barrier()
        ms = (time.perf_counter() - t0) * 1e3
        counts = _launch_counts()
        want = mesh_generate_launches(cfg, PARALLEL_MAX_LEN)
        if counts != want:
            raise AssertionError(f"rank {rank} pipeline {dtype}: launches "
                                 f"{counts}, expected {want}")
        out["pipeline"][dtype] = {"texts": texts, "ms": ms, "launches": {
            k: v for k, v in counts.items() if v}}
        del pipe
        torch.cuda.empty_cache()
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return out


def run_parallel(seed, card):
    """Parallelism on torch.distributed, at the flagship's full width and
    depth (B = 16 x 16 s): an NCCL group of world size 1 through the mesh
    code (the bf16 step and the greedy pipeline bit-equal to the no-mesh
    path, with the same launches), then four ranks sharing cuda:0 over
    gloo: the f32 gradient at (2, 2, 1) with ZeRO-1 and at (1, 2, 2) with
    the ring against the one-card f32 step's, a bf16 dropout-on step at
    (2, 2, 1) twice, and the pipeline over (2, 2); every rank's launches
    exact."""
    import tempfile
    import torch
    import torch.distributed as dist
    from speechmix_tpu_torch.ops import kernels
    from speechmix_tpu_torch.parallel import launch
    from speechmix_tpu_torch.parallel import mesh as mesh_lib
    from speechmix_tpu_torch.training import trainer
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = flagship_config()
    log(f"parallel phase: flagship at full width and depth (12 + 6 + 6 "
        f"layers, vocabulary {cfg.decoder.vocab_size}), B={BATCH} x "
        f"{SECONDS} s; card {card}")

    # 1. the 1x1x1 mesh over an NCCL group of one rank; cuDNN's grouped
    # conv backward is asked for its deterministic algorithms in both runs
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    torch.backends.cudnn.deterministic = True
    try:
        mesh = mesh_lib.make_mesh(device=dev)
        tc = trainer.TrainConfig(learning_rate=TRAIN_LR, warmup_steps=0,
                                 grad_accum=1, bf16=True, optimizer="adamw",
                                 seed=seed)
        got = []
        for m in (None, mesh):
            state, batch = _f32_state_and_batch(seed, cfg, tc, dev)
            if m is not None:
                state = trainer.shard_train_state(state, m, cfg, tc)
            step_fn = trainer.make_train_step(cfg, tc, state.params, mesh=m)
            kernels.reset_launch_counts()
            state, metrics = step_fn(state, batch)
            got.append((metrics["loss"].item(), metrics["grad_norm"].item(),
                        [t.clone() for _, t in
                         trainer.tree_paths(state.params)], _launch_counts()))
            del state, step_fn
        (l0, n0, p0, c0), (l1, n1, p1, c1) = got
        same = all(torch.equal(a, b) for a, b in zip(p0, p1))
        if (l0, n0) != (l1, n1) or not same or c0 != c1:
            raise AssertionError(f"NCCL 1x1x1 bf16 step: loss {l1} vs {l0}, "
                                 f"grad norm {n1} vs {n0}, parameters equal "
                                 f"{same}, launches equal {c0 == c1}")
        log(f"  NCCL world size 1, mesh 1x1x1: bf16 dropout-on step "
            f"(cuDNN deterministic) bit-identical to the no-mesh step "
            f"(loss {l0:.6f}, grad norm "
            f"{n0:.6f}, every parameter), launches equal: "
            f"{ {k: v for k, v in c0.items() if v} }")
        del got, p0, p1
        model = _parallel_model(seed, "bfloat16")
        wavs = _parallel_utterances(seed)
        texts = []
        for m in (None, mesh):
            kernels.reset_launch_counts()
            texts.append((_parallel_pipe(model, m)(wavs), _launch_counts()))
        if texts[0] != texts[1]:
            raise AssertionError("NCCL 1x1x1: the pipeline's greedy tokens "
                                 "or launches differ from the no-mesh path")
        log(f"  NCCL 1x1x1 pipeline, {BATCH} utterances x {SECONDS} s, bf16 "
            f"greedy, {PARALLEL_MAX_LEN} steps: tokens and launches equal to "
            f"the no-mesh path "
            f"({ {k: v for k, v in texts[0][1].items() if v} })")
        del model
    finally:
        torch.backends.cudnn.deterministic = False
        dist.destroy_process_group()

    # 2. the one-card references: the f32 gradient and the pipeline tokens
    tmp = tempfile.mkdtemp(prefix="smx_parallel_")
    ref_path = os.path.join(tmp, "f32_reference.pt")
    tc = _grad_tc()
    state, batch = _f32_state_and_batch(seed, cfg, tc, dev)
    step_fn = trainer.make_train_step(cfg, tc, state.params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grads, norm, metrics = step_fn.gradients(state, batch)
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) * 1e3
    torch.save({"loss": metrics["loss"].item(), "grad_norm": norm.item(),
                "grads": {p: g.cpu() for p, g in trainer.tree_paths(grads)}},
               ref_path)
    log(f"  one-card f32 reference: loss {metrics['loss'].item():.6f}, grad "
        f"norm {norm.item():.6f}, gradient {ref_ms:.1f} ms ({card})")
    del state, grads, step_fn, batch
    ref_texts = {}
    wavs = _parallel_utterances(seed)
    for dtype in ("float32", "bfloat16"):
        ref_texts[dtype] = _parallel_pipe(_parallel_model(seed, dtype))(wavs)
    torch.cuda.empty_cache()

    # 3. four ranks on the one card over gloo
    shapes = (((2, 2, 1), True), ((1, 2, 2), False))
    t0 = time.perf_counter()
    results = launch.spawn(parallel_rank, 4, (seed, ref_path, shapes),
                           init_method=launch.file_store(tmp),
                           backend="gloo", threads=2, timeout_s=600,
                           group_timeout_s=300)
    spawn_s = time.perf_counter() - t0
    shutil.rmtree(tmp, ignore_errors=True)
    for k, (shape, zero1) in enumerate(shapes):
        c0 = results[0]["cases"][k]
        what = (f"{shape} f32" + (" ZeRO-1" if zero1 else "")
                + (" ring" if shape[2] > 1 else ""))
        losses = {r["cases"][k]["loss"] for r in results}
        rel = abs(c0["loss"] - c0["ref_loss"]) / abs(c0["ref_loss"])
        if len(losses) != 1 or rel > 1e-5 or c0["worst"] > 1.0:
            raise AssertionError(f"{what}: losses {losses} vs one-card "
                                 f"{c0['ref_loss']}, worst gradient "
                                 f"err/limit {c0['worst']} at "
                                 f"{c0['worst_path']}")
        log(f"  {what}: loss {c0['loss']:.6f} vs one-card "
            f"{c0['ref_loss']:.6f} (rel {rel:.2e}), grad norm "
            f"{c0['grad_norm']:.6f} vs {c0['ref_norm']:.6f}; {c0['leaves']} "
            f"gradients, worst err/limit {c0['worst']:.3f} at "
            f"{c0['worst_path']} (limit {GRAD_REL} * max|leaf| + "
            f"{GRAD_FLOOR} * largest)")
        for r in results:
            c = r["cases"][k]
            log(f"    rank {r['rank']} {c['coords']}: {c['ms'][-1]:.1f} ms "
                f"per step ({GLOO_NOTE}; {card}), peak {c['peak_gib']:.2f} "
                f"GiB, optimizer state {c['opt_bytes'] / 2**20:.1f} MiB of "
                f"{c['unsharded_opt_bytes'] / 2**20:.1f} MiB unsharded, "
                f"{c['staged_bytes'] / 2**20:.1f} MiB staged through host "
                f"in the gradient, launches {c['launches']}")
            # ZeRO-1: half the state plus at most the largest leaf's (the
            # tied embedding's two AdamW moments)
            largest = 8 * cfg.decoder.vocab_size * cfg.decoder.hidden_size
            if zero1 and c["opt_bytes"] > c["unsharded_opt_bytes"] / 2 + \
                    largest:
                raise AssertionError(f"ZeRO-1 rank {r['rank']}: "
                                     f"{c['opt_bytes']} bytes")
    runs = [r["dropout"] for r in results]
    for r in runs:
        if r[0]["loss"] != r[1]["loss"] or r[0]["params"] != r[1]["params"]:
            raise AssertionError("(2,2,1) bf16 dropout step: two runs "
                                 "differ")
    if len({r[0]["loss"] for r in runs}) != 1 or \
            len({str(r[0]["skipped"]) for r in runs}) != 1:
        raise AssertionError("(2,2,1) bf16 dropout step: ranks disagree on "
                             "the loss or LayerDrop")
    log(f"  (2, 2, 1) bf16 dropout-on step, ZeRO-1: two runs bit-identical on "
        f"every rank (loss {runs[0][0]['loss']:.6f}, LayerDrop skipped "
        f"{runs[0][0]['skipped']} on every rank), rank 0 launches "
        f"{runs[0][0]['launches']}")
    for dtype in ("float32", "bfloat16"):
        ref = [t.split() for t in ref_texts[dtype]]
        for r in results:
            got = [t.split() for t in r["pipeline"][dtype]["texts"]]
            pairs = [(a, b) for x, y in zip(got, ref) for a, b in zip(x, y)]
            agree = sum(a == b for a, b in pairs) / max(len(pairs), 1)
            if dtype == "float32" and got != ref:
                raise AssertionError(f"pipeline (2, 2) f32 rank {r['rank']}: "
                                     f"tokens differ from one card's")
            if agree < TOKEN_AGREEMENT_F32:
                raise AssertionError(f"pipeline (2, 2) {dtype}: agreement "
                                     f"{agree}")
        p0 = results[0]["pipeline"][dtype]
        log(f"  pipeline over (2, 2), {dtype}, {BATCH} utterances x "
            f"{SECONDS} s, greedy {PARALLEL_MAX_LEN} steps: tokens "
            f"{'equal to' if dtype == 'float32' else 'agree with'} the "
            f"one-card call's on every rank ({agree:.4f}); rank 0 "
            f"{p0['ms']:.1f} ms ({GLOO_NOTE}; {card}), launches "
            f"{p0['launches']}")
    log(f"  ranks' peak memory (GiB): "
        f"{[round(r['peak_gib'], 2) for r in results]}; spawn {spawn_s:.1f} s")
    log(f"parallel phase: {time.perf_counter() - t_phase:.1f} s")


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_tree(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


# ---------------------------------------------------------------------------
# the widths the TPU kernels take beyond the port's first bodies: head widths
# other than 64 (wav2vec2-xls-r-1b's 16 heads of 80, the tiny presets' 16,
# t5-3b's d_kv 128), f32 widths above 1024, bf16 extractor widths but 512
# ---------------------------------------------------------------------------

WIDTH_HEADS = 16
# (head width, batch, length) of the K1 / K14 / K7 / K15 cases, timed:
# XLS-R 1B / HuBERT-XL (80) and XLS-R 2B (120) at the speech encoder's
# shape, the tiny presets' 16 and t5-3b's 128 smaller
ATTN_WIDTHS = ((80, 16, 800), (120, 16, 800), (16, 4, 400), (128, 4, 400))
# K4's widths: the tiny decoders (16), an XLS-R-wide head (80), t5-3b (128)
DECODE_WIDTHS = (16, 80, 128)
# t5-3b's cross-attention step: 16 rows over 400 encoder positions, 32
# heads of 128, scale 1.0
T5_3B_CROSS = (16, 400, 32, 128)
# the f32 FFN / epilogue widths (XLS-R 1B, XLS-R 2B) at the rows of the XL
# pair's f32 gradient (8 x 8 s: 8 x 399 frames, rounded up)
F32_WIDTHS, F32_ROWS = (1280, 1920), 3200
# K6 in bf16 off the flagship's 512: tiny-speech's 32 (no LayerNorm, 4 s
# of audio into layer 1), 256 and 1024 (a cluster of 8) with LayerNorm
BF16_CONV_CASES = ((32, 12799, False), (256, 3199, True), (1024, 801, True))


@contextlib.contextmanager
def tallied(counter, pairs):
    """Each (kernel, offset) of `pairs` also counts its accepted launches in
    `counter` under (symbol, the integer argument `offset` places after the
    pointers), as _tally_by_length does, for the block only."""
    saved = [(kern, kern.launch) for kern, _ in pairs]
    for kern, offset in pairs:
        kern.launch = _tally_by_length(kern, counter, offset)
    try:
        yield counter
    finally:
        for kern, launch in saved:
            kern.launch = launch


def width_tallies():
    """The launchers whose widths this PR's phases count: K1 / K14 / K7 /
    K15 and K4 by head width, K6 and its backward's passes by C, the f32
    FFN and epilogue entries by H."""
    from speechmix_tpu_torch.ops.kernels import attention as ka
    from speechmix_tpu_torch.ops.kernels import conv_extractor as kc
    from speechmix_tpu_torch.ops.kernels import decode_attention as kd
    from speechmix_tpu_torch.ops.kernels import ffn as kf
    return ((ka.KERNEL, 4), (ka.DROPOUT_KERNEL, 4), (ka.BWD_KERNEL, 4),
            (ka.DROPOUT_BWD_KERNEL, 4), (kd.KERNEL, 4), (kd.KERNEL_Q8, 4),
            (kc.KERNEL, 2), (kc.ACT_KERNEL, 2), (kc.DATA_KERNEL, 2),
            (kc.WEIGHT_KERNEL, 2), (kf.FFN_DOWN_F32, 1),
            (kf.FFN_DOWN_RES_F32, 1), (kf.FFN_BWD_RECOMPUTE_F32, 1),
            (kf.FFN_BWD_PRODUCTS_F32, 1),
            (kf.DENSE_RES_LN_F32, 2))


def _int8_kv(gen, dev, bkv, t, heads, d):
    """int8 K / V codes with positive float32 scales per (row, key, head)."""
    import torch
    codes = [torch.randint(-127, 128, (bkv, t, heads, d), generator=gen,
                           device=dev, dtype=torch.int8) for _ in range(2)]
    scales = [torch.rand(bkv, t, heads, generator=gen, device=dev) * 0.02
              + 1e-3 for _ in range(2)]
    return codes, {"k_scale": scales[0], "v_scale": scales[1]}


def check_head_widths(randn, gen, dev, records):
    """The widths the TPU kernels take that the port's first bodies (D = 64,
    f32 H <= 1024, bf16 C = 512) refused, each against its plain version at
    the limits stated for D = 64, two calls bit-identical: K1 / K14 / K7 /
    K15 in bf16 at ATTN_WIDTHS (one row ragged; K1 and K7 also against their
    tiled plain versions) and in f32 at B = 2, T = 200 (and causal with a
    masked row) at D = 16, 80, 120, 128; K4 at D = 16, 80, 128 over 64 keys
    (the serial body) and 400 (the cluster body), kb = 1 and 4, bf16 float
    and int8 K/V and f32, and t5-3b's cross step; the f32 K9 / K3 / K2 / K8
    at H = 1280 and 1920; K6 in bf16 at C = 32 and 256.  Each width timed
    with its bound and the library call."""
    import torch
    import torch.nn.functional as F
    from speechmix_tpu_torch.ops.kernels import attention as ka
    from speechmix_tpu_torch.ops.kernels import conv_extractor as kc
    from speechmix_tpu_torch.ops.kernels import decode_attention as kd
    from speechmix_tpu_torch.ops.kernels import dropout as kdrop
    from speechmix_tpu_torch.ops.kernels import ffn as kf

    t_phase = time.perf_counter()
    bf16, f32, heads, rate = (torch.bfloat16, torch.float32, WIDTH_HEADS,
                              DROP_RATE)
    key = kdrop.DropoutKey.from_seed(20261018)
    rule15 = K7_BF16_RULE + ", p^T as (p m)^T"
    log(f"head widths: K1 / K14 / K7 / K15 at {heads} heads, scale "
        f"D^-0.5, dropout rate {rate}")
    for d, b, t in ATTN_WIDTHS:
        scale = d ** -0.5
        lens = torch.full((b,), t, device=dev)
        lens[1] = t - 37
        mask = torch.arange(t, device=dev)[None, :] < lens[:, None]
        q, k, v, g = (randn(b, t, heads * d, dtype=bf16) for _ in range(4))
        what = f"B={b} T={t} H={heads} D={d} bf16"
        e1 = check_attention_fwd(f"K1 {what}", q, k, v, mask, heads, False,
                                 scale)
        out, lse = ka.attention_fwd(q, k, v, mask, heads, scale,
                                    return_lse=True)
        ref = ka.attention_fwd_plain(q, k, v, mask, heads, scale)
        k7 = lambda: ka.attention_bwd(q, k, v, mask, out, lse, g, heads,
                                      scale)
        got = k7()
        refs = ka.attention_bwd_plain(q, k, v, mask, g, heads, scale)
        tiled = ka.attention_bwd_tiled_plain(q, k, v, mask, out, lse, g,
                                             heads, scale)
        torch.cuda.synchronize()
        e7 = None
        for against, ref3 in (("", refs), (" vs tiled", tiled)):
            limits = attention_bwd_bf16_limits(q, k, v, mask, ref, g, heads,
                                               scale, False, ref3)
            err = max(compare(f"K7 {n_} {what}{against}", o, r, lim,
                              K7_BF16_RULE)
                      for n_, o, r, lim in zip(("dq", "dk", "dv"), got, ref3,
                                               limits))
            e7 = err if e7 is None else e7
        expect_equal(f"K7 {what}", got, k7())
        del got, refs, tiled, limits
        dmask = kdrop.attention_mask_plain(key, b, heads, t, t, rate, dev)
        k14 = lambda: ka.attention_dropout_fwd(q, k, v, mask, heads, scale,
                                               False, key, rate,
                                               return_lse=True)
        out_d, lse_d = k14()
        ref_d = ka.attention_fwd_plain(q, k, v, mask, heads, scale,
                                       dmask=dmask)
        torch.cuda.synchronize()
        e14 = compare(f"K14 {what}", out_d, ref_d, attention_bf16_limit(
            q, k, v, mask, heads, scale, False, ref_d, dmask), K14_BF16_RULE)
        expect_equal(f"K14 {what}", (out_d, lse_d), k14())
        k15 = lambda: ka.attention_dropout_bwd(
            q, k, v, mask, out_d, lse_d, g, heads, scale, False, key, rate)
        got = k15()
        refs = ka.attention_bwd_plain(q, k, v, mask, g, heads, scale, False,
                                      dmask)
        torch.cuda.synchronize()
        limits = attention_bwd_bf16_limits(q, k, v, mask, ref_d, g, heads,
                                           scale, False, refs, dmask)
        e15 = max(compare(f"K15 {n_} {what}", o, r, lim, rule15)
                  for n_, o, r, lim in zip(("dq", "dk", "dv"), got, refs,
                                           limits))
        expect_equal(f"K15 {what}", got, k15())
        del got, refs, limits, dmask, ref, ref_d
        allowed = int(lens.sum()) * t
        flops, nbytes = 4.0 * heads * d * allowed, 4 * b * t * heads * d * 2
        qh, kh, vh = (x_.view(b, t, heads, d).transpose(1, 2).detach()
                      .requires_grad_() for x_ in (q, k, v))
        gh = g.view(b, t, heads, d).transpose(1, 2)
        sdpa = lambda p: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask[:, None, None, :], dropout_p=p,
            scale=scale)
        dmask_plain = lambda: kdrop.attention_mask_plain(key, b, heads, t, t,
                                                         rate, dev)
        # XLS-R 1B's 80 runs on the main path (the XL pair: K1, K14, K15 in
        # bf16, K7 in its f32 gradient), the tiny presets' 16 in the tiny
        # commands (K1 in the eval command, K14 / K15 in training); 120
        # and 128 only here
        shape = f"{what}, one row ragged"
        common = dict(head_dim=d, on_path=d in (16, 80))
        records[f"attention_fwd (D={d})"] = dict(
            shape=shape, max_abs_err=e1, **common,
            ms=cuda_ms(lambda: ka.attention_fwd(q, k, v, mask, heads, scale)),
            plain_ms=cuda_ms(lambda: ka.attention_fwd_plain(
                q, k, v, mask, heads, scale), iters=5),
            library_ms=cuda_ms(lambda: sdpa(0.0).detach()), flops=flops,
            bytes=nbytes + b * t)
        lib_out = sdpa(0.0)
        records[f"attention_bwd (D={d})"] = dict(
            shape=shape, max_abs_err=e7, **dict(common, on_path=d == 80),
            ms=cuda_ms(k7),
            plain_ms=cuda_ms(lambda: ka.attention_bwd_plain(
                q, k, v, mask, g, heads, scale), iters=5),
            library_ms=cuda_ms(lambda: torch.autograd.grad(
                lib_out, (qh, kh, vh), gh, retain_graph=True)),
            flops=2.5 * flops, bytes=2 * nbytes + b * heads * t * 4 + b * t)
        records[f"attention_dropout_fwd (D={d})"] = dict(
            shape=f"{shape}, rate {rate}", max_abs_err=e14, **common,
            ms=cuda_ms(lambda: ka.attention_dropout_fwd(
                q, k, v, mask, heads, scale, False, key, rate)),
            plain_ms=cuda_ms(lambda: ka.attention_fwd_plain(
                q, k, v, mask, heads, scale, dmask=dmask_plain()), iters=5),
            library_ms=cuda_ms(lambda: sdpa(rate).detach()), flops=flops,
            bytes=nbytes + b * t)
        lib_out = sdpa(rate)
        records[f"attention_dropout_bwd (D={d})"] = dict(
            shape=f"{shape}, rate {rate}", max_abs_err=e15, **common,
            ms=cuda_ms(k15),
            plain_ms=cuda_ms(lambda: ka.attention_bwd_plain(
                q, k, v, mask, g, heads, scale, False, dmask=dmask_plain()),
                iters=5),
            library_ms=cuda_ms(lambda: torch.autograd.grad(
                lib_out, (qh, kh, vh), gh, retain_graph=True)),
            flops=2.5 * flops, bytes=2 * nbytes + b * heads * t * 4 + b * t)
        del lib_out, q, k, v, g, out, lse, out_d, lse_d, qh, kh, vh
    tol15 = _dropout_tol(TOL["float32"], rate)
    rule_f32 = f"atol {tol15[0]:.4g}, rtol {tol15[1]:.4g} (TOL / (1-r))"
    for d in (16, 80, 120, 128):
        for causal, lens in ((False, [200, 163]), (True, [0, 200, 41])):
            b, t, scale = len(lens), 200, d ** -0.5
            lens = torch.tensor(lens, device=dev)
            mask = torch.arange(t, device=dev)[None, :] < lens[:, None]
            q, k, v, g = (randn(b, t, heads * d) for _ in range(4))
            what = f"B={b} T={t} H={heads} D={d} f32 causal={causal}"
            check_attention_fwd(f"K1 {what}", q, k, v, mask, heads, causal,
                                scale)
            out, lse = ka.attention_fwd(q, k, v, mask, heads, scale, causal,
                                        return_lse=True)
            got = ka.attention_bwd(q, k, v, mask, out, lse, g, heads, scale,
                                   causal)
            refs = ka.attention_bwd_plain(q, k, v, mask, g, heads, scale,
                                          causal)
            for n_, o, r in zip(("dq", "dk", "dv"), got, refs):
                compare(f"K7 {n_} {what}", o, r)
            dmask = kdrop.attention_mask_plain(key, b, heads, t, t, rate,
                                               dev)
            out_d, lse_d = ka.attention_dropout_fwd(
                q, k, v, mask, heads, scale, causal, key, rate,
                return_lse=True)
            ref_d = ka.attention_fwd_plain(q, k, v, mask, heads, scale,
                                           causal, dmask=dmask)
            compare(f"K14 {what}", out_d, ref_d,
                    tol15[0] + tol15[1] * ref_d.abs(), rule_f32)
            got = ka.attention_dropout_bwd(q, k, v, mask, out_d, lse_d, g,
                                           heads, scale, causal, key, rate)
            refs = ka.attention_bwd_plain(q, k, v, mask, g, heads, scale,
                                          causal, dmask)
            for n_, o, r in zip(("dq", "dk", "dv"), got, refs):
                compare(f"K15 {n_} {what}", o, r,
                        tol15[0] + tol15[1] * r.abs(), rule_f32)

    log("head widths: K4")
    bkv = 16
    for d in DECODE_WIDTHS:
        for t in (64, 400):
            name = "self" if t == 64 else "cross"
            mask = decode_mask(name, bkv, t, dev)
            for kb in (1, 4):
                q = randn(bkv * kb, 1, heads, d, dtype=bf16)
                k, v = (randn(bkv, t, heads, d, dtype=bf16)
                        for _ in range(2))
                what = f"{name} D={d} T={t} kb={kb} {heads} heads"
                err = check_decode_case(f"K4 {what} float K/V bf16", q, k, v,
                                        mask, {}, d ** -0.5)
                (kq, vq), scales = _int8_kv(gen, dev, bkv, t, heads, d)
                err_q = check_decode_case(f"K4 {what} int8 K/V bf16", q, kq,
                                          vq, mask, scales, d ** -0.5)
                check_decode_case(f"K4 {what} f32", q.float(), k.float(),
                                  v.float(), mask, {}, d ** -0.5)
                check_decode_case(f"K4 {what} int8 K/V f32", q.float(), kq,
                                  vq, mask, scales, d ** -0.5)
                if kb != 1 or (d, t) not in ((16, 64), (80, 400)):
                    continue
                rec = decode_record(f"{name} greedy D={d} T={t}", "float",
                                    q, k, v, mask, {}, err, d ** -0.5,
                                    1 if t == 64 else 6)
                rec.pop("length")
                # the tiny decoders' 16 runs on the main path (the tiny
                # commands), the XLS-R-wide 80 only here
                records[f"decode_attention (D={d}, T={t})"] = dict(
                    rec, head_dim=d, on_path=d == 16)
    rows, t, h5, d = T5_3B_CROSS
    mask = decode_mask("cross", rows, t, dev)
    q = randn(rows, 1, h5, d, dtype=bf16)
    k, v = (randn(rows, t, h5, d, dtype=bf16) for _ in range(2))
    (kq, vq), scales = _int8_kv(gen, dev, rows, t, h5, d)
    what = f"t5-3b cross greedy B={rows} T={t} {h5} heads of {d}"
    err = check_decode_case(f"K4 {what} float K/V bf16, scale 1.0", q, k, v,
                            mask, {}, 1.0)
    err_q = check_decode_case(f"K4 {what} int8 K/V bf16, scale 1.0", q, kq,
                              vq, mask, scales, 1.0)
    for kind, name, kk, vv, sc, e in (
            ("float", "decode_attention", k, v, {}, err),
            ("int8", "decode_attention_q8", kq, vq, scales, err_q)):
        rec = decode_record(f"t5-3b cross greedy", kind, q, kk, vv, mask, sc,
                            e, 1.0, 2)
        rec.pop("length")
        records[f"{name} (t5-3b cross, D={d})"] = dict(rec, head_dim=d,
                                                        on_path=False)

    log(f"f32 widths: K9 / K3 / K2 / K8 at H = {F32_WIDTHS}, "
        f"N = {F32_ROWS}")
    n = F32_ROWS
    dw_rule = f"atol {K8_DW_F32_TOL[0]}, rtol {K8_DW_F32_TOL[1]}"
    for h in F32_WIDTHS:
        f = 4 * h
        x, g, res = randn(n, h), randn(n, h), randn(n, h)
        w = randn(h, h, scale=0.03)
        w1, w2 = randn(h, f, scale=0.03), randn(f, h, scale=0.03)
        b1, b2, beta = randn(f, scale=0.1), randn(h, scale=0.1), randn(
            h, scale=0.1)
        gamma = randn(h, scale=0.1) + 1.0
        what = f"N={n} H={h} F={f} gelu f32"
        k9 = lambda: kf.ffn_fused(x, w1, b1, w2, b2)
        k3 = lambda: kf.ffn_res_ln(x, w1, b1, w2, b2, res, gamma, beta)
        k2 = lambda: kf.dense_res_ln(x, w, b2, res, gamma, beta)
        k8 = lambda: kf.ffn_bwd(x, g, w1, b1, w2)
        e9 = compare(f"K9 {what}", k9(), kf.ffn_fused_plain(x, w1, b1, w2,
                                                             b2))
        e3 = compare(f"K3 {what}", k3(), kf.ffn_res_ln_plain(
            x, w1, b1, w2, b2, res, gamma, beta))
        e2 = compare(f"K2 {what}", k2(), kf.dense_res_ln_plain(
            x, w, b2, res, gamma, beta))
        got, refs = k8(), kf.ffn_bwd_plain(x, g, w1, b1, w2)
        torch.cuda.synchronize()
        e8 = compare(f"K8 dx {what}", got[0], refs[0])
        for name_, o, r in zip(("dw1", "db1", "dw2"), got[1:4], refs[1:4]):
            e8 = max(e8, compare(f"K8 {name_} {what}", o, r,
                                 K8_DW_F32_TOL[0] + K8_DW_F32_TOL[1] *
                                 r.abs(), dw_rule))
        as_tuple = lambda r: r if isinstance(r, tuple) else (r,)
        for label, fn in (("K9", k9), ("K3", k3), ("K2", k2), ("K8", k8)):
            expect_equal(f"{label} {what}", as_tuple(fn()), as_tuple(fn()))
        del got, refs
        lx = x.detach().requires_grad_()
        lw1, lw2 = (w_.t().contiguous().requires_grad_() for w_ in (w1, w2))
        lb1 = b1.detach().requires_grad_()
        lib_y = F.linear(F.gelu(F.linear(lx, lw1, lb1)), lw2, b2)
        w1t, w2t, wt = w1.t(), w2.t(), w.t()
        ffn_flops, ffn_bytes = 4.0 * n * h * f, (2 * n * h + 2 * h * f) * 4
        # XLS-R 1B's 1280 reaches K9 and K8 on the main path (the XL pair's
        # f32 gradient); its pre-LN layers take no K2 / K3, and 1920 runs
        # only here
        common = dict(width=h, peak_flops=PEAK_F32_FLOPS)
        shape = f"{what} (the f32 path)"
        records[f"ffn_fused (f32, H={h})"] = dict(
            shape=shape, max_abs_err=e9, on_path=h == 1280, **common,
            ms=cuda_ms(k9, iters=5), plain_ms=cuda_ms(lambda: kf.ffn_fused_plain(
                x, w1, b1, w2, b2), iters=5),
            library_ms=cuda_ms(lambda: F.linear(F.gelu(F.linear(x, w1t, b1)),
                                                w2t, b2), iters=5),
            flops=ffn_flops, bytes=ffn_bytes + (f + h) * 4)
        records[f"ffn_bwd (f32, H={h})"] = dict(
            shape=f"{shape}, dx + dw", max_abs_err=e8, on_path=h == 1280,
            **common, ms=cuda_ms(k8, iters=3, warmup=1),
            plain_ms=cuda_ms(lambda: kf.ffn_bwd_plain(x, g, w1, b1, w2),
                             iters=3, warmup=1),
            library_ms=cuda_ms(lambda: torch.autograd.grad(
                lib_y, (lx, lw1, lb1, lw2), g, retain_graph=True), iters=3,
                warmup=1),
            flops=2.5 * ffn_flops,
            bytes=(3 * n * h + 2 * h * f) * 4 + f * 4 + (2 * h * f + f) * 4)
        records[f"ffn_res_ln (f32, H={h})"] = dict(
            shape=shape, max_abs_err=e3, on_path=False, **common,
            ms=cuda_ms(k3, iters=5), plain_ms=cuda_ms(
                lambda: kf.ffn_res_ln_plain(x, w1, b1, w2, b2, res, gamma,
                                            beta), iters=5),
            library_ms=cuda_ms(lambda: F.layer_norm(
                res + F.linear(F.gelu(F.linear(x, w1t, b1)), w2t, b2), (h,),
                gamma, beta, 1e-5), iters=5),
            flops=ffn_flops, bytes=(3 * n * h + 2 * h * f) * 4 + (f + 3 * h) * 4)
        records[f"dense_res_ln (f32, H={h})"] = dict(
            shape=f"N={n} Din=H={h} f32 (the f32 path)",
            max_abs_err=e2, on_path=False, **common, ms=cuda_ms(k2, iters=5),
            plain_ms=cuda_ms(lambda: kf.dense_res_ln_plain(
                x, w, b2, res, gamma, beta), iters=5),
            library_ms=cuda_ms(lambda: F.layer_norm(
                res + F.linear(x, wt, b2), (h,), gamma, beta, 1e-5), iters=5),
            flops=2.0 * n * h * h, bytes=(3 * n * h + h * h) * 4 + 3 * h * 4)
        del lib_y, x, g, res, w, w1, w2, lx, lw1, lw2

    log("bf16 extractor widths: K6 off the tensor-core kernel's C = 512")
    for c, t_in, ln in BF16_CONV_CASES:
        b = BATCH
        x = randn(b, t_in, c, dtype=bf16)
        w = randn(c, c, 3, scale=(3 * c) ** -0.5, dtype=bf16)
        bias = randn(c, scale=0.1)
        lnp = ({"scale": randn(c, scale=0.1) + 1.0, "bias": randn(
            c, scale=0.1)} if ln else None)
        k6 = lambda: kc.fused_conv_layer(x, w, bias, lnp)
        what = f"B={b} T_in={t_in} C={c} k=3 bf16 LayerNorm={ln}"
        e6 = compare(f"K6 {what}", k6(), kc.fused_conv_layer_plain(
            x, w, bias, lnp))
        expect_equal(f"K6 {what}", (k6(),), (k6(),))
        t_out = (t_in - 3) // 2 + 1
        wc, bc = w, bias.to(bf16)

        def library():
            y = F.conv1d(x.transpose(1, 2), wc, bc, stride=2).transpose(1, 2)
            if lnp is not None:
                y = F.layer_norm(y, (c,), lnp["scale"].to(bf16),
                                 lnp["bias"].to(bf16))
            return F.gelu(y)
        # tiny-speech's 32 runs on the main path (the tiny commands)
        records[f"conv_ln_gelu (bf16, C={c})"] = dict(
            shape=what, max_abs_err=e6, width=c, on_path=c == 32,
            ms=cuda_ms(k6), plain_ms=cuda_ms(
                lambda: kc.fused_conv_layer_plain(x, w, bias, lnp)),
            library_ms=cuda_ms(library),
            flops=2.0 * b * t_out * 3 * c * c,
            bytes=(b * t_in * c + 3 * c * c + b * t_out * c) * 2 + 3 * c * 4)
    # what stays outside the limits raises on CUDA tensors, launching
    # nothing and never running a plain version
    slab = randn(2, 64, heads * 136, dtype=bf16)
    expect_refusal("K1 bf16 D=136", lambda: ka.attention_fwd(
        slab, slab, slab, None, heads, 0.125))
    slab = randn(2, 64, heads * 20)
    expect_refusal("K7 f32 D=20", lambda: ka.attention_bwd(
        slab, slab, slab, None, slab, randn(2, heads, 64), slab, heads,
        0.125))
    q, kv = randn(2, 1, heads, 136, dtype=bf16), randn(2, 64, heads, 136,
                                                       dtype=bf16)
    expect_refusal("K4 bf16 D=136", lambda: kd.decode_attention(
        q, kv, kv, torch.ones(2, 64, dtype=torch.bool, device=dev),
        scale=0.125, num_heads=heads))
    x, w1, w2 = randn(8, 2176), randn(2176, 256), randn(256, 2176)
    expect_refusal("K9 f32 H=2176", lambda: kf.ffn_fused(
        x, w1, randn(256), w2, randn(2176)))
    log(f"head widths and f32 / bf16 widths: "
        f"{time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# the f32 path: SpeechMixConfig.dtype's default, what the eval command always
# runs and the train command runs without --bf16
# ---------------------------------------------------------------------------

# the attention shapes of the flagship's f32 path: (record suffix, B, T,
# causal): speech encoder, text encoder, decoder self-attention (the train
# step's; generate decodes through K4)
F32_ATTN = (("", BATCH, 800, False), (", text encoder", BATCH, 400, False),
            (", decoder, causal", BATCH, 64, True))
# f32 K7 / K15 also at the XL pair's speech encoder (XLS-R 1B: 16 heads of
# 80, B = 16 x 16 s): (B, T, H, D)
F32_ATTN_XL = (BATCH, 800, 16, 80)
# its row counts: speech encoder, text encoder, decoder (64 label positions)
F32_PATH_ROWS = (12800, 6400, 1024)
# the K8 f32 body against its plain version at every flagship width
K8_F32_WIDTHS = (256, 512, 768, 1024, 1280, 1920)
F32_CALLS = 4          # a warm-up call, then three timed


def port_kernel_names():
    """The names of the __global__ functions of the port's CUDA sources, as
    a regex that finds them in the profiler's kernel names."""
    from speechmix_tpu_torch.ops.kernels import _cuda
    names = set()
    for path in sorted(_cuda.CSRC.glob("*.cu")):
        for decl in re.findall(r"__global__([^{;]*)\{", path.read_text()):
            calls = [n for n in re.findall(r"(\w+)\s*\(", decl)
                     if n not in ("__launch_bounds__", "sizeof")]
            if calls:
                names.add(calls[-1])
    return re.compile(r"(?<!\w)(" + "|".join(sorted(names)) + r")(?=[<(])")


def f32_ms(fn, budget_ms=120.0):
    """cuda_ms with as many calls (2 to 20) as fit in about budget_ms, from
    one timed warm-up call."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    return cuda_ms(fn, iters=int(max(2, min(20, budget_ms / once))), warmup=0)


def f32_path_rows():
    """The `kernels` line's entries of check_f32_rows' records: name ->
    (source, TPU kernel file:line, the f32 run that launches it, entry)."""
    fa, fb = "flash_attention_kernel.py", "ffn_kernel.py"
    rows = {}
    for suffix, _, t, causal in F32_ATTN:
        plain_mode = "f32-train-no-dropout" if causal else "f32-greedy"
        rows.update({
            f"attention_fwd (f32{suffix})": (
                "attention_fwd.cu", f"{fa}:985", plain_mode,
                "smx_attention_fwd"),
            f"attention_dropout_fwd (f32{suffix})": (
                "attention_fwd.cu", f"{fa}:727", "f32-train",
                "smx_attention_dropout_fwd"),
            f"attention_bwd (f32{suffix})": (
                "attention_bwd.cu", f"{fa}:378", "f32-train-no-dropout",
                "smx_attention_bwd"),
            f"attention_dropout_bwd (f32{suffix})": (
                "attention_bwd.cu", f"{fa}:815", "f32-train",
                "smx_attention_dropout_bwd")})
    for n in F32_PATH_ROWS:
        # f32 K2 / K11 are one entry of ffn_fwd.cu each; K3 / K12 counted
        # by the pass only they run (the down pass to z), K9 / K13 by the
        # down pass to the output in the run without / with dropout
        greedy_or_step = "f32-greedy" if n > 1024 else "f32-train-no-dropout"
        rows.update({
            f"dense_res_ln (f32, N={n})": (
                "ffn_fwd.cu", f"{fb}:381", greedy_or_step,
                "smx_dense_res_ln_f32"),
            f"dense_dropout_res_ln (f32, N={n})": (
                "ffn_fwd.cu", f"{fb}:1097", "f32-train",
                "smx_dense_dropout_res_ln_f32"),
            f"ffn_res_ln (f32, N={n})": (
                "ffn_fwd.cu", f"{fb}:203", greedy_or_step,
                "smx_ffn_down_res_f32"),
            f"ffn_fused (f32, N={n})": (
                "ffn_fwd.cu", f"{fb}:128", "f32-train-no-dropout",
                "smx_ffn_down_f32"),
            f"ffn_dropout_res_ln (f32, N={n})": (
                "ffn_fwd.cu", f"{fb}:1016", "f32-train",
                "smx_ffn_dropout_down_res_f32"),
            f"ffn_dropout (f32, N={n})": (
                "ffn_fwd.cu", f"{fb}:945", "f32-train", "smx_ffn_down_f32"),
            f"ffn_bwd (f32, N={n})": (
                "ffn_bwd.cu", f"{fb}:631", "f32-train-no-dropout",
                "smx_ffn_bwd_recompute_f32"),
            f"ffn_dropout_bwd (f32, N={n})": (
                "ffn_bwd.cu", f"{fb}:700", "f32-train",
                "smx_ffn_dropout_bwd_recompute_f32")})
    rows.update({
        **{f"decode_attention (f32, {name})": (
            "decode_attention.cu", "decode_attention.py:31", "f32-greedy",
            "smx_decode_attention") for name in ("cross greedy",
                                                  "self greedy")},
        **{f"conv_ln_gelu (f32, layer {layer})": (
            "conv_ln_gelu.cu", "conv_extractor.py:88", "f32-greedy",
            "smx_conv_ln_gelu") for layer in range(1, 7)}})
    return rows


def check_k8_f32_body(randn, dev):
    """K8's f32 body (the f32 recompute pass, then the f32 products) at every
    flagship width, 1000 rows (a ragged row tile, one row range), with and
    without the activation mask, against its plain version at K8's f32
    limits, and twice, bit for bit."""
    import torch
    from speechmix_tpu_torch.ops.kernels import dropout as kdrop
    from speechmix_tpu_torch.ops.kernels import ffn as kf
    key = kdrop.DropoutKey.from_seed(20261019)
    n, rate = 1000, DROP_RATE
    log(f"K8 f32 body at H = {K8_F32_WIDTHS}, N = {n}, with and without the "
        f"activation mask (rate {rate})")
    for h in K8_F32_WIDTHS:
        f = 4 * h
        x, g = randn(n, h), randn(n, h)
        w1, w2 = randn(h, f, scale=0.03), randn(f, h, scale=0.03)
        b1 = randn(f, scale=0.1)
        amask = kdrop.dropout_mask_plain(key, kdrop.STREAM_ACT, n, f, rate,
                                         dev)
        for r, call, ref in (
                (0.0, lambda: kf.ffn_bwd(x, g, w1, b1, w2),
                 kf.ffn_bwd_plain(x, g, w1, b1, w2)),
                (rate, lambda: kf.ffn_dropout_bwd(x, g, w1, b1, w2, key,
                                                  rate),
                 kf.ffn_bwd_plain(x, g, w1, b1, w2, amask=amask))):
            got = call()
            torch.cuda.synchronize()
            what = f"K8 f32 N={n} H={h} F={f} rate={r}"
            tol = _dropout_tol(TOL["float32"], r)
            dw = _dropout_tol(K8_DW_F32_TOL, r)
            compare(f"{what} dx", got[0], ref[0], tol[0] + tol[1] *
                    ref[0].abs(), f"atol {tol[0]:.4g}, rtol {tol[1]:.4g}")
            for name, o, rr in zip(("dw1", "db1", "dw2"), got[1:4],
                                   ref[1:4]):
                compare(f"{what} {name}", o, rr, dw[0] + dw[1] * rr.abs(),
                        f"atol {dw[0]:.4g}, rtol {dw[1]:.4g}")
            expect_equal(what, got, call())
        del x, g, w1, w2, amask


def check_f32_forward_widths(randn, dev):
    """The f32 passes of ffn_fwd.cu off the model's widths: K9 / K3 / K13 /
    K12 at H = 100, F = 400 (tiles the TMA fills with zeros) under every
    activation, H = 2048, F = 256 (the widest H) and H = 99, F = 390 (the
    wrapper's padding to multiples of 4), K2 / K11 at Din = H = 100, Din =
    99 with H = 101 and Din = 512 with H = 768, 77 or 1000 rows (ragged
    tiles), each against its plain version at the f32 limits (over 1 - r
    with a mask) and twice, bit for bit."""
    from speechmix_tpu_torch.ops.kernels import dropout as kdrop
    from speechmix_tpu_torch.ops.kernels import ffn as kf

    rate, key = DROP_RATE, kdrop.DropoutKey.from_seed(20)
    tol = _dropout_tol(TOL["float32"], rate)
    rule = f"atol {tol[0]:.4g}, rtol {tol[1]:.4g} (TOL / (1-r))"
    log("f32 forward passes off the model's widths")
    for n, h, f, acts in ((1000, 100, 400, tuple(kf.ACT_CODES)),
                          (1000, 2048, 256, ("gelu",)),
                          (77, 99, 390, ("gelu", "relu"))):
        x, res = randn(n, h), randn(n, h)
        w1, w2 = randn(h, f, scale=0.03), randn(f, h, scale=0.03)
        b1, b2, beta = randn(f, scale=0.1), randn(h, scale=0.1), randn(
            h, scale=0.1)
        gamma = randn(h, scale=0.1) + 1.0
        amask = kdrop.dropout_mask_plain(key, kdrop.STREAM_ACT, n, f, rate,
                                         dev)
        omask = kdrop.dropout_mask_plain(key, kdrop.STREAM_OUT, n, h, rate,
                                         dev)
        for act in acts:
            k9, k3 = (x, w1, b1, w2, b2), (x, w1, b1, w2, b2, res, gamma,
                                           beta)
            what = f"N={n} H={h} F={f} {act} f32"
            for label, fn, ref, r in (
                    ("K9", lambda: kf.ffn_fused(*k9, act),
                     kf.ffn_fused_plain(*k9, act), 0.0),
                    ("K3", lambda: kf.ffn_res_ln(*k3, act),
                     kf.ffn_res_ln_plain(*k3, act), 0.0),
                    ("K13", lambda: kf.ffn_dropout(*k9, key, rate, act),
                     kf.ffn_dropout_plain(*k9, amask, act), rate),
                    ("K12", lambda: kf.ffn_dropout_res_ln(
                        *k3, key, rate, rate, act),
                     kf.ffn_dropout_res_ln_plain(*k3, amask, omask, act),
                     rate)):
                t = _dropout_tol(TOL["float32"], r)
                compare(f"{label} {what}", fn(), ref, t[0] + t[1] * ref.abs(),
                        rule if r else f"atol {t[0]:.4g}, rtol {t[1]:.4g}")
                expect_equal(f"{label} {what}", (fn(),), (fn(),))
    for n, din, h in ((1000, 100, 100), (77, 99, 101), (1000, 512, 768)):
        x, res = randn(n, din), randn(n, h)
        w = randn(din, h, scale=0.03)
        b, beta = randn(h, scale=0.1), randn(h, scale=0.1)
        k2 = (x, w, b, res, randn(h, scale=0.1) + 1.0, beta)
        omask = kdrop.dropout_mask_plain(key, kdrop.STREAM_OUT, n, h, rate,
                                         dev)
        what = f"N={n} Din={din} H={h} f32"
        compare(f"K2 {what}", kf.dense_res_ln(*k2), kf.dense_res_ln_plain(*k2))
        expect_equal(f"K2 {what}", (kf.dense_res_ln(*k2),),
                     (kf.dense_res_ln(*k2),))
        ref = kf.dense_dropout_res_ln_plain(*k2, omask)
        out = kf.dense_dropout_res_ln(*k2, key, rate)
        compare(f"K11 {what}", out, ref, tol[0] + tol[1] * ref.abs(), rule)
        expect_equal(f"K11 {what}", (out,),
                     (kf.dense_dropout_res_ln(*k2, key, rate),))


def check_f32_attention_xl(randn, dev, records, key):
    """f32 K1 / K14 and K7 / K15 at F32_ATTN_XL (the XL pair's f32
    gradient runs K1 and K7 there; the head padded to 128 columns) against
    their plain versions, two calls bit for bit, timed beside them and the
    library call."""
    import torch
    import torch.nn.functional as F
    from speechmix_tpu_torch.ops.kernels import attention as ka
    from speechmix_tpu_torch.ops.kernels import dropout as kdrop

    b, t, heads, d = F32_ATTN_XL
    scale, rate = d ** -0.5, DROP_RATE
    tol_d = _dropout_tol(TOL["float32"], rate)
    rule_d = f"atol {tol_d[0]:.4g}, rtol {tol_d[1]:.4g} (TOL / (1-r))"
    mask = torch.ones(b, t, dtype=torch.bool, device=dev)
    q, k, v, g = (randn(b, t, heads * d) for _ in range(4))
    qh, kh, vh = (x_.view(b, t, heads, d).transpose(1, 2).detach()
                  .requires_grad_() for x_ in (q, k, v))
    gh = g.view(b, t, heads, d).transpose(1, 2)
    dmask = lambda: kdrop.attention_mask_plain(  # noqa: E731
        key, b, heads, t, t, rate, dev)
    what = f"B={b} T={t} H={heads} D={d}"
    fwd_io = 4 * b * t * heads * d * 4 + b * t
    k1 = lambda: ka.attention_fwd(q, k, v, mask, heads, scale,  # noqa: E731
                                  return_lse=True)
    p1 = lambda: ka.attention_fwd_plain(  # noqa: E731
        q, k, v, mask, heads, scale, return_lse=True)
    e1 = max(compare(f"K1 {n_} {what} f32", o, r)
             for n_, o, r in zip(("out", "lse"), k1(), p1()))
    expect_equal(f"K1 {what} f32", k1(), k1())
    # the XL pair's f32 gradient launches K1 at this width
    _f32_row(records, f"attention_fwd (f32, D={d})", what, e1, k1, p1,
             lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                    scale=scale).detach(),
             4.0 * heads * d * b * t * t, fwd_io, head_dim=d, on_path=True)
    k14 = lambda: ka.attention_dropout_fwd(  # noqa: E731
        q, k, v, mask, heads, scale, False, key, rate, return_lse=True)
    p14 = lambda: ka.attention_fwd_plain(  # noqa: E731
        q, k, v, mask, heads, scale, False, True, dmask())
    # the lse is undropped: held at TOL, the output over (1 - r)
    e14 = max(compare(f"K14 out {what} f32", o_, r_,
                      tol_d[0] + tol_d[1] * r_.abs(), rule_d) if n_ == "out"
              else compare(f"K14 lse {what} f32", o_, r_)
              for n_, o_, r_ in zip(("out", "lse"), k14(), p14()))
    expect_equal(f"K14 {what} f32", k14(), k14())
    # no run of this script trains the XL pair in f32 with dropout
    _f32_row(records, f"attention_dropout_fwd (f32, D={d})",
             f"{what}, rate {rate}", e14, k14, p14,
             lambda: F.scaled_dot_product_attention(
                 qh, kh, vh, dropout_p=rate, scale=scale).detach(),
             4.0 * heads * d * b * t * t, fwd_io, head_dim=d, on_path=False)
    flops = 10.0 * heads * d * b * t * t
    bwd_io = 8 * b * t * heads * d * 4 + b * heads * t * 4 + b * t
    out, lse = ka.attention_fwd(q, k, v, mask, heads, scale,
                                return_lse=True)
    k7 = lambda: ka.attention_bwd(q, k, v, mask, out, lse, g, heads, scale)
    p7 = lambda: ka.attention_bwd_plain(q, k, v, mask, g, heads, scale)
    e7 = max(compare(f"K7 {n_} {what} f32", o, r)
             for n_, o, r in zip(("dq", "dk", "dv"), k7(), p7()))
    expect_equal(f"K7 {what} f32", k7(), k7())
    lib_out = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
    # the XL pair's f32 gradient launches K7 at this width
    _f32_row(records, f"attention_bwd (f32, D={d})", what, e7, k7, p7,
             lambda: torch.autograd.grad(lib_out, (qh, kh, vh), gh,
                                         retain_graph=True),
             flops, bwd_io, head_dim=d, on_path=True)
    out_d, lse_d = ka.attention_dropout_fwd(q, k, v, mask, heads, scale,
                                            False, key, rate, return_lse=True)
    k15 = lambda: ka.attention_dropout_bwd(q, k, v, mask, out_d, lse_d, g,
                                           heads, scale, False, key, rate)
    p15 = lambda: ka.attention_bwd_plain(q, k, v, mask, g, heads, scale,
                                         False, dmask())
    e15 = max(compare(f"K15 {n_} {what} f32", o, r,
                      tol_d[0] + tol_d[1] * r.abs(), rule_d)
              for n_, o, r in zip(("dq", "dk", "dv"), k15(), p15()))
    expect_equal(f"K15 {what} f32", k15(), k15())
    lib_out = F.scaled_dot_product_attention(qh, kh, vh, dropout_p=rate,
                                             scale=scale)
    # no run of this script trains the XL pair in f32 with dropout
    _f32_row(records, f"attention_dropout_bwd (f32, D={d})",
             f"{what}, rate {rate}", e15, k15, p15,
             lambda: torch.autograd.grad(lib_out, (qh, kh, vh), gh,
                                         retain_graph=True),
             flops, bwd_io, head_dim=d, on_path=False)


def _f32_row(records, name, shape, err, kernel, plain, library, flops,
             nbytes, **at):
    records[name] = dict(
        shape=f"{shape} f32", max_abs_err=err, ms=f32_ms(kernel),
        plain_ms=f32_ms(plain), library_ms=f32_ms(library), flops=flops,
        bytes=nbytes, peak_flops=PEAK_F32_FLOPS, **at)


def check_f32_rows(randn, dev, records):
    """The f32 rows of phase 3: every kernel of the flagship's f32 path (the
    f32 greedy generate and train step, B = 16 x 16 s) at that path's
    shapes, each against its plain version, then timed beside its plain
    version and one library call in full f32 (TF32 off): K1 / K14 / K7 /
    K15 at F32_ATTN; K2 / K11 and K3 / K9 / K12 / K13 (the f32 passes of
    ffn_fwd.cu, two calls bit for bit) at F32_PATH_ROWS; K4 with an f32 q (cross greedy at T = 400, self at 64); K6
    at the six extractor layers (C = 512, without LayerNorm as the
    flagship, and with it); K8 with and without the activation mask at
    F32_PATH_ROWS."""
    import torch
    import torch.nn.functional as F
    from speechmix_tpu_torch.ops.kernels import attention as ka
    from speechmix_tpu_torch.ops.kernels import conv_extractor as kc
    from speechmix_tpu_torch.ops.kernels import dropout as kdrop
    from speechmix_tpu_torch.ops.kernels import ffn as kf

    t_phase = time.perf_counter()
    heads, d, scale, rate = 12, 64, 0.125, DROP_RATE
    key = kdrop.DropoutKey.from_seed(20261019)
    tol_d = _dropout_tol(TOL["float32"], rate)
    rule_d = f"atol {tol_d[0]:.4g}, rtol {tol_d[1]:.4g} (TOL / (1-r))"
    lim_d = lambda r: tol_d[0] + tol_d[1] * r.abs()  # noqa: E731
    log("f32 rows: the flagship's f32 path at its shapes, rate "
        f"{rate} where a mask enters")
    for suffix, b, t, causal in F32_ATTN:
        mask = torch.ones(b, t, dtype=torch.bool, device=dev)
        q, k, v, g = (randn(b, t, heads * d) for _ in range(4))
        qh, kh, vh = (x_.view(b, t, heads, d).transpose(1, 2).detach()
                      .requires_grad_() for x_ in (q, k, v))
        gh = g.view(b, t, heads, d).transpose(1, 2)
        sdpa = lambda p: F.scaled_dot_product_attention(  # noqa: E731
            qh, kh, vh, dropout_p=p, is_causal=causal, scale=scale)
        dmask = lambda: kdrop.attention_mask_plain(  # noqa: E731
            key, b, heads, t, t, rate, dev)
        what = f"B={b} T={t} H={heads} D={d} causal={causal}"
        allowed = b * t * (t + 1) // 2 if causal else b * t * t
        io = 4 * b * t * heads * d * 4 + b * t
        common = dict(length=t)
        k1 = lambda: ka.attention_fwd(q, k, v, mask, heads, scale, causal)
        p1 = lambda: ka.attention_fwd_plain(q, k, v, mask, heads, scale,
                                            causal)
        e1 = compare(f"K1 {what} f32", k1(), p1())
        _f32_row(records, f"attention_fwd (f32{suffix})", what, e1, k1, p1,
                 lambda: sdpa(0.0).detach(), 4.0 * heads * d * allowed, io,
                 **common)
        k14 = lambda: ka.attention_dropout_fwd(q, k, v, mask, heads, scale,
                                               causal, key, rate)
        p14 = lambda: ka.attention_fwd_plain(q, k, v, mask, heads, scale,
                                             causal, dmask=dmask())
        ref = p14()
        e14 = compare(f"K14 {what} f32", k14(), ref, lim_d(ref), rule_d)
        _f32_row(records, f"attention_dropout_fwd (f32{suffix})",
                 f"{what}, rate {rate}", e14, k14, p14,
                 lambda: sdpa(rate).detach(), 4.0 * heads * d * allowed, io,
                 **common)
        out, lse = ka.attention_fwd(q, k, v, mask, heads, scale, causal,
                                    return_lse=True)
        k7 = lambda: ka.attention_bwd(q, k, v, mask, out, lse, g, heads,
                                      scale, causal)
        p7 = lambda: ka.attention_bwd_plain(q, k, v, mask, g, heads, scale,
                                            causal)
        e7 = max(compare(f"K7 {n_} {what} f32", o, r)
                 for n_, o, r in zip(("dq", "dk", "dv"), k7(), p7()))
        lib_out = sdpa(0.0)
        bwd_io = 8 * b * t * heads * d * 4 + b * heads * t * 4 + b * t
        _f32_row(records, f"attention_bwd (f32{suffix})", what, e7, k7, p7,
                 lambda: torch.autograd.grad(lib_out, (qh, kh, vh), gh,
                                             retain_graph=True),
                 10.0 * heads * d * allowed, bwd_io, **common)
        out_d, lse_d = ka.attention_dropout_fwd(
            q, k, v, mask, heads, scale, causal, key, rate, return_lse=True)
        k15 = lambda: ka.attention_dropout_bwd(
            q, k, v, mask, out_d, lse_d, g, heads, scale, causal, key, rate)
        p15 = lambda: ka.attention_bwd_plain(q, k, v, mask, g, heads, scale,
                                             causal, dmask())
        e15 = max(compare(f"K15 {n_} {what} f32", o, r, lim_d(r), rule_d)
                  for n_, o, r in zip(("dq", "dk", "dv"), k15(), p15()))
        lib_out = sdpa(rate)
        _f32_row(records, f"attention_dropout_bwd (f32{suffix})",
                 f"{what}, rate {rate}", e15, k15, p15,
                 lambda: torch.autograd.grad(lib_out, (qh, kh, vh), gh,
                                             retain_graph=True),
                 10.0 * heads * d * allowed, bwd_io, **common)
        # no atomics: each call the same bits (K1 / K14: out and lse)
        k1l = lambda: ka.attention_fwd(  # noqa: E731
            q, k, v, mask, heads, scale, causal, return_lse=True)
        k14l = lambda: ka.attention_dropout_fwd(  # noqa: E731
            q, k, v, mask, heads, scale, causal, key, rate, return_lse=True)
        expect_equal(f"K1 {what} f32", k1l(), k1l())
        expect_equal(f"K14 {what} f32", k14l(), k14l())
        expect_equal(f"K7 {what} f32", k7(), k7())
        expect_equal(f"K15 {what} f32", k15(), k15())
        del q, k, v, g, qh, kh, vh, out, lse, out_d, lse_d, lib_out, ref
    check_f32_attention_xl(randn, dev, records, key)

    h, f = 768, 3072
    omask = lambda n: kdrop.dropout_mask_plain(  # noqa: E731
        key, kdrop.STREAM_OUT, n, h, rate, dev)
    amask = lambda n: kdrop.dropout_mask_plain(  # noqa: E731
        key, kdrop.STREAM_ACT, n, f, rate, dev)
    dw_tol = _dropout_tol(K8_DW_F32_TOL, rate)
    for n in F32_PATH_ROWS:
        x, g, res = randn(n, h), randn(n, h), randn(n, h)
        w = randn(h, h, scale=0.03)
        w1, w2 = randn(h, f, scale=0.03), randn(f, h, scale=0.03)
        b1, b2, beta = randn(f, scale=0.1), randn(h, scale=0.1), randn(
            h, scale=0.1)
        gamma = randn(h, scale=0.1) + 1.0
        wt, w1t, w2t = w.t(), w1.t(), w2.t()
        what = f"N={n} H={h}"
        k2 = (x, w, b2, res, gamma, beta)
        e2 = compare(f"K2 {what} f32", kf.dense_res_ln(*k2),
                     kf.dense_res_ln_plain(*k2))
        dense_io = (3 * n * h + h * h) * 4 + 3 * h * 4
        _f32_row(records, f"dense_res_ln (f32, N={n})", f"{what} Din=H", e2,
                 lambda: kf.dense_res_ln(*k2),
                 lambda: kf.dense_res_ln_plain(*k2),
                 lambda: F.layer_norm(res + F.linear(x, wt, b2), (h,),
                                      gamma, beta, 1e-5),
                 2.0 * n * h * h, dense_io, rows=n)
        ref = kf.dense_dropout_res_ln_plain(*k2, omask(n))
        e11 = compare(f"K11 {what} f32", kf.dense_dropout_res_ln(
            *k2, key, rate), ref, lim_d(ref), rule_d)
        _f32_row(records, f"dense_dropout_res_ln (f32, N={n})",
                 f"{what} Din=H, rate {rate}", e11,
                 lambda: kf.dense_dropout_res_ln(*k2, key, rate),
                 lambda: kf.dense_dropout_res_ln_plain(*k2, omask(n)),
                 lambda: F.layer_norm(res + F.dropout(F.linear(x, wt, b2),
                                                      rate), (h,), gamma,
                                      beta, 1e-5),
                 2.0 * n * h * h, dense_io, rows=n)
        what = f"N={n} H={h} F={f} gelu"
        ffn_io = (2 * n * h + 2 * h * f) * 4 + (f + h) * 4
        lib_ffn = lambda drop: F.linear(  # noqa: E731
            F.dropout(F.gelu(F.linear(x, w1t, b1)), drop), w2t, b2)
        k3 = (x, w1, b1, w2, b2, res, gamma, beta)
        e3 = compare(f"K3 {what} f32", kf.ffn_res_ln(*k3),
                     kf.ffn_res_ln_plain(*k3))
        _f32_row(records, f"ffn_res_ln (f32, N={n})", what, e3,
                 lambda: kf.ffn_res_ln(*k3),
                 lambda: kf.ffn_res_ln_plain(*k3),
                 lambda: F.layer_norm(res + lib_ffn(0.0), (h,), gamma,
                                      beta, 1e-5),
                 4.0 * n * h * f, ffn_io + (n * h + 2 * h) * 4, rows=n)
        k9 = (x, w1, b1, w2, b2)
        e9 = compare(f"K9 {what} f32", kf.ffn_fused(*k9),
                     kf.ffn_fused_plain(*k9))
        _f32_row(records, f"ffn_fused (f32, N={n})", what, e9,
                 lambda: kf.ffn_fused(*k9),
                 lambda: kf.ffn_fused_plain(*k9),
                 lambda: lib_ffn(0.0), 4.0 * n * h * f, ffn_io, rows=n)
        ref = kf.ffn_dropout_res_ln_plain(*k3, amask(n), omask(n))
        e12 = compare(f"K12 {what} f32", kf.ffn_dropout_res_ln(
            *k3, key, rate, rate), ref, lim_d(ref), rule_d)
        # the f32 passes, each call the same bits
        for label, fn in (
                ("K2", lambda: kf.dense_res_ln(*k2)),
                ("K11", lambda: kf.dense_dropout_res_ln(*k2, key, rate)),
                ("K3", lambda: kf.ffn_res_ln(*k3)),
                ("K9", lambda: kf.ffn_fused(*k9)),
                ("K12", lambda: kf.ffn_dropout_res_ln(*k3, key, rate, rate)),
                ("K13", lambda: kf.ffn_dropout(*k9, key, rate))):
            expect_equal(f"{label} {what} f32", (fn(),), (fn(),))
        _f32_row(records, f"ffn_dropout_res_ln (f32, N={n})",
                 f"{what}, rates {rate}", e12,
                 lambda: kf.ffn_dropout_res_ln(*k3, key, rate, rate),
                 lambda: kf.ffn_dropout_res_ln_plain(*k3, amask(n),
                                                     omask(n)),
                 lambda: F.layer_norm(res + F.dropout(lib_ffn(rate),
                                                      rate), (h,),
                                      gamma, beta, 1e-5),
                 4.0 * n * h * f, ffn_io + (n * h + 2 * h) * 4, rows=n)
        ref = kf.ffn_dropout_plain(*k9, amask(n))
        e13 = compare(f"K13 {what} f32", kf.ffn_dropout(*k9, key, rate),
                      ref, lim_d(ref), rule_d)
        _f32_row(records, f"ffn_dropout (f32, N={n})",
                 f"{what}, rate {rate}", e13,
                 lambda: kf.ffn_dropout(*k9, key, rate),
                 lambda: kf.ffn_dropout_plain(*k9, amask(n)),
                 lambda: lib_ffn(rate), 4.0 * n * h * f, ffn_io, rows=n)
        lx = x.detach().requires_grad_()
        lw1, lw2 = (w_.t().contiguous().requires_grad_() for w_ in (w1, w2))
        lb1 = b1.detach().requires_grad_()
        k8_io = (3 * n * h + 2 * h * f) * 4 + f * 4 + (2 * h * f + f) * 4
        for r in (0.0, rate):
            if r:
                k8 = lambda: kf.ffn_dropout_bwd(x, g, w1, b1, w2, key, rate)
                p8 = lambda: kf.ffn_bwd_plain(x, g, w1, b1, w2,
                                              amask=amask(n))
            else:
                k8 = lambda: kf.ffn_bwd(x, g, w1, b1, w2)
                p8 = lambda: kf.ffn_bwd_plain(x, g, w1, b1, w2)
            lib_y = F.linear(F.dropout(F.gelu(F.linear(lx, lw1, lb1)), r),
                             lw2, b2)
            got, ref = k8(), p8()
            tol = _dropout_tol(TOL["float32"], r)
            dw = _dropout_tol(K8_DW_F32_TOL, r)
            e8 = compare(f"K8 dx {what} rate={r} f32", got[0], ref[0],
                         tol[0] + tol[1] * ref[0].abs(),
                         f"atol {tol[0]:.4g}, rtol {tol[1]:.4g}")
            for name_, o, rr in zip(("dw1", "db1", "dw2"), got[1:4],
                                    ref[1:4]):
                e8 = max(e8, compare(f"K8 {name_} {what} rate={r} f32", o, rr,
                                     dw[0] + dw[1] * rr.abs(),
                                     f"atol {dw[0]:.4g}, rtol {dw[1]:.4g}"))
            del got, ref
            _f32_row(records, f"ffn_{'dropout_' if r else ''}bwd (f32, N={n})",
                     f"{what}, dx + dw" + (f", rate {r}" if r else ""), e8,
                     k8, p8, lambda: torch.autograd.grad(
                         lib_y, (lx, lw1, lb1, lw2), g, retain_graph=True),
                     10.0 * n * h * f, k8_io, rows=n)
            del lib_y
        del x, g, res, w, w1, w2, lx, lw1, lw2, lb1

    from speechmix_tpu_torch.ops.kernels import decode_attention as kd
    for name, t in (("cross greedy", 400), ("self greedy", 64)):
        mask = decode_mask(name, BATCH, t, dev)
        q = randn(BATCH, 1, heads, d)
        k, v = (randn(BATCH, t, heads, d) for _ in range(2))
        err = check_decode_case(f"K4 {name} T={t} f32", q, k, v, mask, {})
        rec = decode_record(name, "float", q, k, v, mask, {}, err, scale,
                            DECODER_LAYERS if t == 400 else 1)
        rec.pop("serial_ms")   # an f32 q takes the serial body
        records[f"decode_attention (f32, {name})"] = dict(
            rec, peak_flops=PEAK_F32_FLOPS)

    c = 512
    for layer, (t_in, k) in enumerate(extractor_geometry(), start=1):
        b = BATCH
        x = randn(b, t_in, c)
        w = randn(c, c, k, scale=(k * c) ** -0.5)
        bias = randn(c, scale=0.1)
        xt = x.transpose(1, 2).contiguous()
        n = b * ((t_in - k) // 2 + 1)
        for ln in (None, {"scale": randn(c, scale=0.1) + 1.0,
                          "bias": randn(c, scale=0.1)}):
            what = f"x ({b}, {t_in}, {c}) k={k} stride 2, " + (
                "LayerNorm" if ln else "no LayerNorm")
            k6 = lambda: kc.fused_conv_layer(x, w, bias, ln)
            p6 = lambda: kc.fused_conv_layer_plain(x, w, bias, ln)

            def library():
                y = F.conv1d(xt, w, bias, stride=2)
                if ln is not None:
                    y = F.layer_norm(y.transpose(1, 2), (c,), ln["scale"],
                                     ln["bias"])
                return F.gelu(y)
            e6 = compare(f"K6 {what} f32", k6(), p6())
            _f32_row(records, f"conv_ln_gelu (f32, layer {layer}" +
                     (", LayerNorm)" if ln else ")"), what, e6, k6, p6,
                     library, 2.0 * n * k * c * c,
                     (x.numel() + n * c + w.numel()) * 4 + 3 * c * 4,
                     t_in=t_in)
        del x, xt
    log(f"f32 rows: {time.perf_counter() - t_phase:.1f} s")


def run_f32_flagship(seed, card, check=True):
    """The flagship's f32 path end to end at B = 16 x 16 s: greedy generate
    (64 steps) and the default recipe's train step (Adafactor, dropout on,
    the presets' rates, SpecAugment and LayerDrop), each a warm-up call and
    three timed (median), its peak memory and one profiled call's busy
    share and the port's kernels' device ms beside the wall time; then one
    step with dropout off (the train command's --no-dropout), whose
    launches the deterministic f32 entries' rows read.  `check`: hold each
    call's launches against the expected counts (off for a tree whose
    entries are named otherwise).  Returns ({mode: launches of the last
    call}, {mode: launches by (entry, T / rows / T_in)})."""
    import torch
    from speechmix_tpu_torch import generation
    from speechmix_tpu_torch.models import speech_encoder
    from speechmix_tpu_torch.ops import kernels
    from speechmix_tpu_torch.ops.kernels import attention as ka
    from speechmix_tpu_torch.ops.kernels import conv_extractor as kc
    from speechmix_tpu_torch.ops.kernels import decode_attention as kd
    from speechmix_tpu_torch.ops.kernels import ffn as kf
    from speechmix_tpu_torch.training import trainer

    t_phase = time.perf_counter()
    ours = port_kernel_names()
    # the f32 entries by rows (a tree from before they were named so, run
    # with check=False, tallies those it has)
    pairs = [(kern, offset) for kern, offset in (
        (ka.KERNEL, 1), (ka.DROPOUT_KERNEL, 1), (ka.BWD_KERNEL, 1),
        (ka.DROPOUT_BWD_KERNEL, 1), (kd.KERNEL, 2), (kc.KERNEL, 1),
        (kc.ACT_KERNEL, 1), (kc.DATA_KERNEL, 1), (kc.WEIGHT_KERNEL, 1),
        *((getattr(kf, name, None), 0) for name in (
            "DENSE_RES_LN_F32", "DENSE_DROPOUT_RES_LN_F32", "FFN_UP_F32",
            "FFN_DROPOUT_UP_F32", "FFN_DOWN_F32", "FFN_DOWN_RES_F32",
            "FFN_DROPOUT_DOWN_RES_F32", "RES_LN_ROWS_F32",
            "FFN_BWD_RECOMPUTE_F32", "FFN_DROPOUT_BWD_RECOMPUTE_F32")))
        if kern is not None]
    counts, shapes = {}, {}

    def timed(label, mode, call, want, calls=F32_CALLS):
        """calls of `call` (the first a warm-up), each holding its launches
        against want() (None: no check); the median of the rest, the peak
        memory, a profiled call's busy share and our kernels' device ms."""
        times = []
        torch.cuda.reset_peak_memory_stats()
        for i in range(calls):
            expected = want() if want is not None else None
            kernels.reset_launch_counts()
            tally = collections.Counter()
            with tallied(tally, pairs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            got = {k_.symbol: k_.launches for k_ in kernels.kernels()}
            if check and expected is not None and got != expected:
                raise AssertionError(f"{label} call {i}: launches {got}, "
                                     f"expected {expected}")
            if i:
                times.append(dt)
        peak = torch.cuda.max_memory_allocated()
        counts[mode], shapes[mode] = got, dict(tally)
        if not times:
            log(f"  {label}: {dt * 1e3:.1f} ms, launches "
                f"{ {k_: v for k_, v in got.items() if v} }")
            return
        med = sorted(times)[len(times) // 2]
        wall_us, busy_us, events = profile_call(call)
        mine = collections.Counter()
        for e in events:
            hit = ours.search(e.key)
            if hit:
                mine[hit.group(1)] += e.self_device_time_total
        log(f"  {label}: {med * 1e3:.1f} ms (median of {len(times)}: "
            f"{', '.join(f'{t_ * 1e3:.1f}' for t_ in times)}), audio-seconds "
            f"per second {BATCH * SECONDS / med:.2f}, peak memory "
            f"{peak / 2 ** 30:.2f} GiB; profiled call: wall "
            f"{wall_us / 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
            f"({busy_us / wall_us:.3f} of wall), the port's kernels "
            f"{sum(mine.values()) / 1e3:.1f} ms of it: " +
            ", ".join(f"{n_} {us / 1e3:.2f}" for n_, us in mine.most_common())
            + f"; launches {({k_: v for k_, v in got.items() if v})} on "
            f"{card}")
        for name, names in (("attention forward (K1 / K14)",
                             ATTN_FWD_KERNELS),
                            ("attention backward (K7 / K15)",
                             ATTN_BWD_KERNELS)):
            log_kernel_sum(events, name, names, f"the profiled {label}")

    cfg, params, wav, lengths = flagship_inputs(seed)
    p32 = _cast_tree(params, torch.float32)
    del params
    log(f"f32 path: flagship, float32 (SpeechMixConfig.dtype's default), "
        f"B={BATCH} x {SECONDS} s")
    want = f32_generate_launches("greedy", MAX_LEN)
    out = []
    with torch.no_grad():
        timed(f"f32 greedy generate ({MAX_LEN} steps)", "f32-greedy",
              lambda: out.append(generation.generate(
                  p32, cfg, wav, lengths, max_length=MAX_LEN,
                  dtype=torch.float32)[0]), lambda: want)
    if out[-1].shape != (BATCH, MAX_LEN) or not all(
            torch.equal(o, out[0]) for o in out):
        raise AssertionError("f32 greedy generate: bad or unequal tokens")
    del p32, out
    torch.cuda.empty_cache()

    dec = cfg.decoder
    for mode, tc in (("f32-train", trainer.TrainConfig(seed=seed)),
                     ("f32-train-no-dropout", trainer.TrainConfig(
                         seed=seed, dropout=False))):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        state = trainer.create_train_state(gen, cfg, tc)
        batch = _train_batch(cfg, gen, torch.device("cuda"), BATCH, SECONDS,
                             TRAIN_LABELS)
        step_fn = trainer.make_train_step(cfg, tc, state.params)
        holder = [state]

        def step():
            holder[0], metrics = step_fn(holder[0], batch)
            loss = metrics["loss"].item()
            if not math.isfinite(loss):
                raise AssertionError(f"{mode}: loss {loss}")

        def want_step():
            if not tc.dropout:
                return expected_train_launches(
                    cfg.num_speech_encoder_layers, dec.encoder_layers,
                    dec.decoder_layers, dtype="f32")
            skipped = layerdrop_replay(trainer, speech_encoder, tc, cfg,
                                       holder[0].step)
            return expected_dropout_train_launches(
                cfg.num_speech_encoder_layers - len(skipped),
                dec.encoder_layers, dec.decoder_layers, dtype="f32")
        recipe = ("the default recipe: Adafactor, dropout on" if tc.dropout
                  else "dropout off")
        timed(f"f32 train step ({recipe})", mode, step, want_step,
              F32_CALLS if tc.dropout else 1)
        del state, holder, step_fn, batch
        torch.cuda.empty_cache()
    for mode, tally in shapes.items():
        log(f"  {mode} launches by (entry, T / rows / T_in): " + ", ".join(
            f"{k_[0]} {k_[1]}: {n_}" for k_, n_ in sorted(tally.items())))
    log(f"f32 path phase: {time.perf_counter() - t_phase:.1f} s")
    return counts, shapes


# ---------------------------------------------------------------------------
# wav2vec2-xls-r-1b + bart-large: 16 heads of 80, H = 1280, at full width
# ---------------------------------------------------------------------------

XL_LAYERS = (48, 12, 12)
XL_STEPS = 4


def xl_config(layers=None):
    """facebook/wav2vec2-xls-r-1b from the fields of its config.json
    (convert.XLS_R_1B_CONFIG through convert.config_from_hf: 48 pre-LN
    layers, H = 1280, 16 heads of 80, F = 5120, a LayerNorm in every
    extractor layer) with the fused extractor, + bart-large, down_scale 2.
    `layers`: (speech, text encoder, decoder) depths of a cut copy,
    LayerDrop off."""
    import dataclasses
    from speechmix_tpu_torch import config, convert
    enc = dataclasses.replace(convert.config_from_hf(convert.XLS_R_1B_CONFIG),
                              extractor_impl="fused")
    dec = config.SEQ2SEQ_PRESETS["bart-large"]
    if layers is not None:
        enc = dataclasses.replace(enc, num_layers=layers[0], layerdrop=0.0)
        dec = dataclasses.replace(dec, encoder_layers=layers[1],
                                  decoder_layers=layers[2])
    return config.SpeechMixConfig(encoder=enc, decoder=dec, down_scale=2)


def _expect_widths(label, tally, want):
    """Each {(symbol, width): launches} of `want` counted so in `tally`."""
    got = {k: tally.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"{label}: launches by width {got}, expected "
                             f"{want}")
    log(f"  {label}: launches by width " + ", ".join(
        f"{s} at {w}: {n}" for (s, w), n in sorted(want.items())))


def run_xl_pair(seed, card):
    """wav2vec2-xls-r-1b + bart-large at full width and depth (48 + 12 + 12
    layers), random bf16 weights from the seed, B = 16 x 16 s: greedy and
    beam-4 generate (64 steps, exact launch counts, K1 at D = 80 in every
    speech layer), TrainConfig(bf16=True) train steps (Adafactor, dropout
    on, SpecAugment, LayerDrop; every leaf training) with K14 / K15 at
    D = 80, a finite loss that falls, then the f32 gradient of a 2 + 2 + 2
    cut against the plain path (f32 K1 / K7 at D = 80, K9 / K8 at
    H = 1280).  Returns ({mode: launches}, {mode: launches by width})."""
    import torch
    from speechmix_tpu_torch import generation
    from speechmix_tpu_torch.models import speech_encoder, speechmix
    from speechmix_tpu_torch.ops import kernels
    from speechmix_tpu_torch.training import freezing, trainer

    t_phase = time.perf_counter()
    cfg = xl_config()
    enc, dec = cfg.encoder, cfg.decoder
    d = enc.hidden_size // enc.num_heads
    if (enc.num_layers, enc.hidden_size, d, enc.ffn_dim,
            enc.do_stable_layer_norm) != (48, 1280, 80, 5120, True):
        raise AssertionError(f"XLS-R 1B config: {enc}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    b = LARGE_BATCH
    batch = _train_batch(cfg, gen, dev, b, SECONDS, TRAIN_LABELS)
    wav, lengths = batch["input_values"], batch["lengths"]
    params = speechmix.init_speechmix(cfg, gen, dev, torch.bfloat16)
    n_params = sum(p.numel() for _, p in freezing.tree_paths(params))
    log(f"XL pair {enc.name} ({enc.num_layers} pre-LN layers, H="
        f"{enc.hidden_size}, {enc.num_heads} heads of {d}, F={enc.ffn_dim}) "
        f"+ {dec.name} ({dec.encoder_layers} + {dec.decoder_layers} layers), "
        f"{n_params / 1e6:.1f} M parameters, bf16, B={b} x {SECONDS} s, "
        f"max_length {MAX_LEN}")
    counts, widths = {}, {}
    modes = (("xl-greedy", {}, 3),
             ("xl-beam-4", dict(num_beams=BEAMS, num_return_sequences=BEAMS,
                                output_scores=True), 3))
    speech, text, dec_layers = XL_LAYERS
    for mode, kwargs, calls in modes:
        want = expected_large_generate_launches(MAX_LEN, XL_LAYERS)
        if kwargs:
            want["smx_beam_gather"] = MAX_LEN
        tally, times = collections.Counter(), []
        torch.cuda.reset_peak_memory_stats()
        with tallied(tally, width_tallies()):
            for i in range(calls):
                kernels.reset_launch_counts()
                tally.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = generation.generate(params, cfg, wav, lengths,
                                          max_length=MAX_LEN,
                                          dtype=torch.bfloat16, **kwargs)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                got = {k.symbol: k.launches for k in kernels.kernels()}
                log(f"  {mode} generate call {i}: {dt * 1e3:.1f} ms")
                if got != want:
                    raise AssertionError(f"{mode}: launches {got}, expected "
                                         f"{want}")
                if i:
                    times.append(dt)
        rows = b * kwargs.get("num_return_sequences", 1)
        tokens, lens = out[0], out[1]
        if (tokens.shape != (rows, MAX_LEN) or (lens < 0).any()
                or not ((tokens >= 0) & (tokens < dec.vocab_size)).all()):
            raise AssertionError(f"{mode}: bad tokens {tuple(tokens.shape)}")
        _expect_widths(mode, tally, {
            ("smx_attention_fwd", d): speech,
            ("smx_attention_fwd", 64): text,
            ("smx_decode_attention", 64): 2 * dec_layers * MAX_LEN})
        med = sorted(times)[len(times) // 2]
        log(f"  {mode}: {med * 1e3:.1f} ms per call (median of "
            f"{len(times)}), audio-seconds per second transcribed "
            f"{b * SECONDS / med:.2f}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB on "
            f"{card}; launches {got}")
        _profile_step(lambda: generation.generate(
            params, cfg, wav, lengths, max_length=MAX_LEN,
            dtype=torch.bfloat16, **kwargs), f"{mode} generate")
        counts[mode], widths[mode] = got, dict(tally)
    del params, out

    tc = trainer.TrainConfig(learning_rate=TRAIN_LR, warmup_steps=1,
                             bf16=True, freeze_epochs=LARGE_FREEZE_EPOCHS,
                             seed=seed)
    if not (tc.optimizer == "adafactor" and tc.dropout
            and not cfg.encoder.remat):
        raise AssertionError(f"TrainConfig defaults changed: {tc}")
    state = trainer.create_train_state(gen, cfg, tc)
    step_fn = trainer.make_train_step(cfg, tc, state.params)
    log(f"XL pair training: {n_params / 1e6:.1f} M float32 parameters, bf16 "
        f"compute, Adafactor lr {TRAIN_LR}, warmup 1, dropout on, "
        f"SpecAugment, LayerDrop {enc.layerdrop}, every leaf training "
        f"(progress 1.0 of freeze_epochs {LARGE_FREEZE_EPOCHS}), no remat, "
        f"B={b} x {SECONDS} s, {TRAIN_LABELS} label positions")
    torch.cuda.empty_cache()
    losses, times, peaks = [], [], []
    tally = collections.Counter()
    with tallied(tally, width_tallies()):
        for i in range(XL_STEPS):
            mask = freezing.reference_unfreeze_scale(
                state.params, freezing.unfreeze_epoch(1.0,
                                                      LARGE_FREEZE_EPOCHS),
                LARGE_FREEZE_EPOCHS)
            skipped = layerdrop_replay(trainer, speech_encoder, tc, cfg,
                                       state.step)
            kept = [l for l in range(enc.num_layers) if l not in skipped]
            attn_bwd, ffn_bwd = speech_backward_layers(
                mask["speech_encoder"], kept)
            want = expected_preln_train_launches(
                len(kept), len(attn_bwd), len(ffn_bwd), text, dec_layers,
                dropout=True)
            kernels.reset_launch_counts()
            tally.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch, 1.0)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            got = {k.symbol: k.launches for k in kernels.kernels()}
            loss, norm = metrics["loss"].item(), metrics["grad_norm"].item()
            log(f"  step {i + 1}: loss {loss:.4f}, grad_norm {norm:.4f}, "
                f"{dt * 1e3:.1f} ms, LayerDrop skipped {skipped}")
            if metrics["layers_skipped"] != [skipped]:
                raise AssertionError(f"XL step {i + 1}: LayerDrop skipped "
                                     f"{metrics['layers_skipped']}, the key "
                                     f"chain gives {skipped}")
            if got != want:
                raise AssertionError(f"XL step {i + 1}: launches {got}, "
                                     f"expected {want}")
            if len(attn_bwd) != len(kept) or len(ffn_bwd) != len(kept):
                raise AssertionError("XL step: a speech layer's backward "
                                     "did not run")
            _expect_widths(f"step {i + 1}", tally, {
                ("smx_attention_dropout_fwd", d): len(kept),
                ("smx_attention_dropout_bwd", d): len(attn_bwd),
                ("smx_attention_dropout_fwd", 64): text + dec_layers,
                ("smx_conv_ln_gelu", 512): FUSED_CONV_LAYERS})
            if not (math.isfinite(loss) and math.isfinite(norm)):
                raise AssertionError(f"XL step {i + 1}: loss {loss}")
            losses.append(loss)
            if i:
                times.append(dt)
                peaks.append(torch.cuda.max_memory_allocated())
    if not losses[-1] < losses[1]:
        raise AssertionError(f"XL pair: the loss did not fall: {losses}")
    med = sorted(times)[len(times) // 2]
    log(f"  XL train step: {med * 1e3:.1f} ms (median of {len(times)}: "
        f"{', '.join(f'{t * 1e3:.1f}' for t in times)}), audio-seconds per "
        f"second trained {b * SECONDS / med:.2f}, peak memory "
        f"{max(peaks) / 2 ** 30:.2f} GiB (no remat), loss {losses[1]:.4f} -> "
        f"{losses[-1]:.4f} on {card}")
    _profile_step(lambda: step_fn(state, batch, 1.0), "XL train step")
    counts["xl-train"], widths["xl-train"] = got, dict(tally)
    del state, step_fn, batch
    torch.cuda.empty_cache()

    tally = collections.Counter()
    with tallied(tally, width_tallies()):
        counts["xl-f32-grad"] = check_gradient_tree(seed, xl=True)
    _expect_widths("f32 gradient", tally, {
        ("smx_attention_fwd", d): 2, ("smx_attention_bwd", d): 2,
        ("smx_ffn_down_f32", enc.hidden_size): 2,
        ("smx_ffn_bwd_recompute_f32", enc.hidden_size): 2,
        ("smx_ffn_bwd_products_f32", enc.hidden_size): 2})
    widths["xl-f32-grad"] = dict(tally)
    log(f"XL pair phase: {time.perf_counter() - t_phase:.1f} s")
    return counts, widths


# ---------------------------------------------------------------------------
# the tiny presets through the commands on the card
# ---------------------------------------------------------------------------

TINY_PAIRS = (("tiny-speech", "tiny-bart-bytes"),
              ("tiny-speech", "tiny-t5-bytes"))
TINY_STEPS = 3


def run_tiny_commands(seed, card):
    """`python -m speechmix_tpu_torch.train` with --bf16 and then
    `speechmix_tpu_torch.eval` on the trained weights, on tiny-speech +
    tiny-bart-bytes and tiny-speech + tiny-t5-bytes (the README's CPU
    commands without --platform; tiny-speech with the fused extractor, as
    every command phase here): each returns normally, logs finite losses,
    and launches K1 (K14 / K15 with dropout) and K4 at head width 16 and K6
    at C = 32 (bf16 in training, f32 in the eval command, which has no
    --bf16).  Returns ({mode: launches}, {mode: launches by width})."""
    import tempfile
    import torch
    from speechmix_tpu_torch import eval as eval_cmd
    from speechmix_tpu_torch import train as train_cmd
    from speechmix_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    counts, widths = {}, {}
    for speech, nlp in TINY_PAIRS:
        label = "tiny-bart" if "bart" in nlp else "tiny-t5"
        out_dir = tempfile.mkdtemp(prefix="smx_tiny_cmd_")
        common = ["--speech_model_config", speech, "--nlp_model_config", nlp,
                  "--down_scale", "8"]
        runs = {
            "train": (train_cmd.main, [
                "--HFSpeechMixEED", *common, "--bf16", "--synthetic",
                "--batch", "2", "--grad_accum", "1", "--max_steps",
                str(TINY_STEPS), "--logging_steps", "1", "--eval_step",
                str(TINY_STEPS), "--predict_with_generate", "--seed",
                str(seed), "--output_dir", out_dir]),
            "eval": (eval_cmd.main, [
                *common, "--weights", os.path.join(out_dir,
                                                   "final_weights.npz"),
                "--synthetic_eval", "4", "--batch", "4", "--max_length",
                "16"])}
        try:
            with fused_extractor_preset(speech):
                for run, (main_fn, argv) in runs.items():
                    mode = f"{label}-{run}"
                    log(f"{mode}: python -m speechmix_tpu_torch.{run} "
                        f"{' '.join(argv)}")
                    tally = collections.Counter()
                    kernels.reset_launch_counts()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    with tallied(tally, width_tallies()):
                        rc, lines = _captured(main_fn, argv)
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                    if rc not in (None, 0):
                        raise AssertionError(f"{mode}: exit {rc}")
                    for line in lines[-6:]:
                        log(f"  | {line}")
                    got = {k.symbol: k.launches for k in kernels.kernels()}
                    logged = [json.loads(l) for l in lines
                              if l.startswith("{")]
                    losses = [r["loss"] for r in logged if "loss" in r]
                    if run == "train" and (len(losses) < TINY_STEPS or not all(
                            math.isfinite(x) for x in losses)):
                        raise AssertionError(f"{mode}: logged {logged}")
                    need = {("smx_decode_attention", 16),
                            ("smx_conv_ln_gelu", 32)}
                    need.add(("smx_attention_dropout_fwd", 16) if run ==
                             "train" else ("smx_attention_fwd", 16))
                    if run == "train":
                        need.add(("smx_attention_dropout_bwd", 16))
                    missing = [k for k in need if tally.get(k, 0) < 1]
                    if missing:
                        raise AssertionError(f"{mode}: not launched "
                                             f"{missing}")
                    log(f"  {mode}: exit 0, {dt:.1f} s, launches by width "
                        + ", ".join(f"{s} at {w}: {n}" for (s, w), n in
                                    sorted(tally.items())))
                    counts[mode], widths[mode] = got, dict(tally)
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
    log(f"tiny commands phase: {time.perf_counter() - t_phase:.1f} s on "
        f"{card}")
    return counts, widths


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "speechmix_tpu_torch", "csrc")):
        print("chip_smoke: speechmix_tpu_torch/csrc not found beside the "
              "script", file=sys.stderr)
        return 1
    sys.path.insert(0, here)
    from speechmix_tpu_torch.ops import kernels
    from speechmix_tpu_torch.ops.kernels import _cuda

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device {kind}; nvidia-smi: {card}; torch {torch.__version__} "
        f"CUDA {torch.version.cuda}; python {sys.version.split()[0]}")

    # build from the checkout's sources, never from an earlier build
    shutil.rmtree(_cuda.BUILD_DIR, ignore_errors=True)
    log(f"build: {kernels.build_all():.2f} s (nvcc {' '.join(_cuda.ARCH_FLAGS)})")
    for source, text in sorted(_cuda.BUILD_LOG.items()):
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {source}: {line.strip()}")
    # the f32 forward's tf32 products must not be serialized (C7513 /
    # C7515 / C7518 under -Xptxas -v)
    serialized = [line.strip() for line in
                  _cuda.BUILD_LOG["attention_fwd.cu"].splitlines()
                  if "serialized" in line and F32_FWD_KERNEL in line]
    if serialized:
        raise AssertionError("ptxas serialized the wgmma of "
                             f"{F32_FWD_KERNEL}: " + "; ".join(serialized))
    log(f"  ptxas: no serialized wgmma in {F32_FWD_KERNEL}")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    records = check_kernels(gen, torch.device("cuda"))
    counts, by_length = run_flagship(args.seed, card)
    counts.update(run_generate_modes(args.seed, card))
    f32_counts, f32_shapes = run_f32_flagship(args.seed, card)
    counts.update(f32_counts)
    by_length.update(f32_shapes)
    check_gradient_tree(args.seed)
    check_gradient_tree(args.seed, dropout=True)
    counts["train"], by_length["train"] = run_training(args.seed, card)
    counts["train-dropout"], by_length["train-dropout"] = run_training(
        args.seed, card, dropout=True)
    counts["large-greedy"], counts["large-train"] = run_large_pair(args.seed,
                                                                   card)
    check_gradient_tree(args.seed, large=True)
    counts.update(run_variants(args.seed, card))
    run_trainer(args.seed, card)
    t5_counts, t5_rows = run_t5(args.seed, card)
    counts.update(t5_counts)
    by_length.update(t5_rows)
    check_gradient_tree(args.seed, t5=True)
    serving_counts, serving_lengths = run_serving(args.seed, card)
    counts.update(serving_counts)
    by_length.update(serving_lengths)
    run_commands(args.seed, card)
    run_remat(args.seed, card)
    run_native(args.seed, card, run_profiler(args.seed, card))
    run_parallel(args.seed, card)
    for phase in (run_xl_pair, run_tiny_commands):
        phase_counts, phase_widths = phase(args.seed, card)
        counts.update(phase_counts)
        by_length.update(phase_widths)

    pallas = "speechmix_tpu/ops/pallas/"
    # name: (source, TPU kernel file:line, mode whose run gives `launches`)
    replaces = {
        "attention_fwd": ("attention_fwd.cu",
                          "flash_attention_kernel.py:985", "greedy"),
        # K1 at the text encoder's and the decoder's lengths: the same
        # launcher, its launches at that length in the train step under
        # launches_at_length
        "attention_fwd (text encoder)": ("attention_fwd.cu",
                                         "flash_attention_kernel.py:985",
                                         "train", "smx_attention_fwd"),
        "attention_fwd (decoder, causal)": ("attention_fwd.cu",
                                            "flash_attention_kernel.py:985",
                                            "train", "smx_attention_fwd"),
        "dense_res_ln": ("dense_res_ln.cu", "ffn_kernel.py:381", "greedy"),
        # K2 and K11 at the train step's row counts: the same launcher, its
        # launches at that row count under launches_at_rows
        "dense_res_ln (N=12800)": ("dense_res_ln.cu", "ffn_kernel.py:381",
                                   "train", "smx_dense_res_ln"),
        "dense_res_ln (N=6400)": ("dense_res_ln.cu", "ffn_kernel.py:381",
                                  "train", "smx_dense_res_ln"),
        "dense_res_ln (N=1024)": ("dense_res_ln.cu", "ffn_kernel.py:381",
                                  "train", "smx_dense_res_ln"),
        # K3, K9, K12 and K13 in bf16: passes of ffn_fwd.cu, each function
        # counted by the pass only it runs in that mode's run (K3: the down
        # pass to z; K9 and K13: the down pass to the output)
        "ffn_res_ln": ("ffn_fwd.cu", "ffn_kernel.py:203", "greedy",
                       "smx_ffn_down_res"),
        "decode_attention": ("decode_attention.cu", "decode_attention.py:31",
                             "greedy"),
        "decode_attention_q8": ("decode_attention.cu",
                                "decode_attention.py:67", "greedy-int8"),
        # K4 at its other shapes: the same launcher, its launches at that
        # key length in that mode's run under launches_at_length
        "decode_attention (self greedy)": (
            "decode_attention.cu", "decode_attention.py:31", "greedy",
            "smx_decode_attention"),
        "decode_attention (self beam-4)": (
            "decode_attention.cu", "decode_attention.py:31", "beam-4",
            "smx_decode_attention"),
        "decode_attention (cross beam-4)": (
            "decode_attention.cu", "decode_attention.py:31", "beam-4",
            "smx_decode_attention"),
        "beam_gather": ("beam_gather.cu", "beam_gather.py:39", "beam-4"),
        "conv_ln_gelu": ("conv_ln_gelu.cu", "conv_extractor.py:88", "greedy"),
        # K6 at extractor layers 2-6: the same launcher, its launches at
        # that T_in in the train step under launches_at_t_in
        **{f"conv_ln_gelu (layer {layer})": (
            "conv_ln_gelu.cu", "conv_extractor.py:88", "train",
            "smx_conv_ln_gelu") for layer in range(2, 7)},
        "attention_bwd": ("attention_bwd.cu", "flash_attention_kernel.py:378",
                          "train"),
        # K7 at the text encoder's and the decoder's lengths: the same
        # launcher, its launches at that length under launches_at_length
        "attention_bwd (text encoder)": ("attention_bwd.cu",
                                         "flash_attention_kernel.py:378",
                                         "train", "smx_attention_bwd"),
        "attention_bwd (decoder, causal)": ("attention_bwd.cu",
                                            "flash_attention_kernel.py:378",
                                            "train", "smx_attention_bwd"),
        # K8 in bf16: the recompute pass holds the recompute of both TPU
        # kernels (_kernel_bwd_dx :549 and _kernel_bwd_dw :574), the
        # products their products; "ffn_bwd" is the two together, counted
        # once per backward (one recompute launch each)
        "ffn_bwd_recompute": ("ffn_bwd.cu", "ffn_kernel.py:631", "train"),
        "ffn_bwd_products": ("ffn_bwd.cu", "ffn_kernel.py:647", "train"),
        "ffn_bwd": ("ffn_bwd.cu", "ffn_kernel.py:631", "train",
                    "smx_ffn_bwd_recompute"),
        "ffn_fused": ("ffn_fwd.cu", "ffn_kernel.py:128", "train",
                      "smx_ffn_down"),
        "ffn_up": ("ffn_fwd.cu", "ffn_kernel.py:128", "train"),
        "ffn_down": ("ffn_fwd.cu", "ffn_kernel.py:128", "train"),
        "ffn_down_res": ("ffn_fwd.cu", "ffn_kernel.py:203", "train"),
        "res_ln_rows": ("ffn_fwd.cu", "ffn_kernel.py:203", "train"),
        "dropout_mask": ("dropout_mask.cu", "ffn_kernel.py:795",
                         "train-dropout"),
        "dense_dropout_res_ln": ("dense_res_ln.cu", "ffn_kernel.py:1097",
                                 "train-dropout"),
        "dense_dropout_res_ln (N=6400)": (
            "dense_res_ln.cu", "ffn_kernel.py:1097", "train-dropout",
            "smx_dense_dropout_res_ln"),
        "dense_dropout_res_ln (N=1024)": (
            "dense_res_ln.cu", "ffn_kernel.py:1097", "train-dropout",
            "smx_dense_dropout_res_ln"),
        "ffn_dropout_res_ln": ("ffn_fwd.cu", "ffn_kernel.py:1016",
                               "train-dropout", "smx_ffn_dropout_down_res"),
        "ffn_dropout": ("ffn_fwd.cu", "ffn_kernel.py:945", "train-dropout",
                        "smx_ffn_down"),
        "ffn_dropout_up": ("ffn_fwd.cu", "ffn_kernel.py:945",
                           "train-dropout"),
        "ffn_dropout_down_res": ("ffn_fwd.cu", "ffn_kernel.py:1016",
                                 "train-dropout"),
        "attention_dropout_fwd": ("attention_fwd.cu",
                                  "flash_attention_kernel.py:727",
                                  "train-dropout"),
        # K14 at the text encoder's and the decoder's lengths
        "attention_dropout_fwd (text encoder)": (
            "attention_fwd.cu", "flash_attention_kernel.py:727",
            "train-dropout", "smx_attention_dropout_fwd"),
        "attention_dropout_fwd (decoder, causal)": (
            "attention_fwd.cu", "flash_attention_kernel.py:727",
            "train-dropout", "smx_attention_dropout_fwd"),
        "attention_dropout_bwd": ("attention_bwd.cu",
                                  "flash_attention_kernel.py:815",
                                  "train-dropout"),
        "attention_dropout_bwd (text encoder)": (
            "attention_bwd.cu", "flash_attention_kernel.py:815",
            "train-dropout", "smx_attention_dropout_bwd"),
        "attention_dropout_bwd (decoder, causal)": (
            "attention_bwd.cu", "flash_attention_kernel.py:815",
            "train-dropout", "smx_attention_dropout_bwd"),
        # no TPU kernel: the TPU package runs this backward in XLA
        # (_ffn_bwd_hand with the regenerated mask); its products are
        # ffn_bwd_products
        "ffn_dropout_bwd_recompute": ("ffn_bwd.cu", "ffn_kernel.py:700",
                                      "train-dropout"),
        "ffn_dropout_bwd": ("ffn_bwd.cu", "ffn_kernel.py:700",
                            "train-dropout", "smx_ffn_dropout_bwd_recompute"),
        # the large pair's widths (H = 1024, F = 4096, 16 heads)
        "attention_fwd (large, T=800)": ("attention_fwd.cu",
                                         "flash_attention_kernel.py:985",
                                         "large-greedy", "smx_attention_fwd"),
        "attention_dropout_fwd (large, T=800)": (
            "attention_fwd.cu", "flash_attention_kernel.py:727",
            "large-train", "smx_attention_dropout_fwd"),
        "attention_dropout_bwd (large, T=800)": (
            "attention_bwd.cu", "flash_attention_kernel.py:815",
            "large-train", "smx_attention_dropout_bwd"),
        "ffn_fused (large, N=12800)": ("ffn_fwd.cu", "ffn_kernel.py:128",
                                       "large-greedy", "smx_ffn_down"),
        "ffn_dropout (large, N=12800)": ("ffn_fwd.cu", "ffn_kernel.py:945",
                                         "large-train", "smx_ffn_down"),
        "ffn_dropout_bwd (large, N=12800)": (
            "ffn_bwd.cu", "ffn_kernel.py:700", "large-train",
            "smx_ffn_dropout_bwd_recompute"),
        "dense_res_ln (large, N=6400)": ("dense_res_ln.cu",
                                         "ffn_kernel.py:381", "large-greedy",
                                         "smx_dense_res_ln"),
        "ffn_res_ln (large, N=6400)": ("ffn_fwd.cu", "ffn_kernel.py:203",
                                       "large-greedy", "smx_ffn_down_res"),
        # t5-small's FFN (relu, H = 512, no biases) at its text encoder's
        # and its decoder's rows, the launches at that row count under
        # launches_at_rows
        **{f"ffn_fused (t5-small, N={n})": (
            "ffn_fwd.cu", "ffn_kernel.py:128", mode, "smx_ffn_down")
           for n, mode in ((6400, "t5-greedy"), (1024, "t5-train"))},
        **{f"ffn_bwd (t5-small, N={n})": (
            "ffn_bwd.cu", "ffn_kernel.py:631", "t5-train",
            "smx_ffn_bwd_recompute") for n in (6400, 1024)},
        **{f"ffn_dropout (t5-small, N={n})": (
            "ffn_fwd.cu", "ffn_kernel.py:945", "t5-train-dropout",
            "smx_ffn_dropout_up") for n in (6400, 1024)},
        # K4 at the T5 pairs' cross-attention steps (8 and 6 heads, scale
        # 1.0; their launches at T = 400 under launches_at_length) and K5
        # on their beam caches
        **{f"decode_attention ({model}, cross {mode})": (
            "decode_attention.cu", "decode_attention.py:31",
            f"{model.split('-')[0]}-{mode}", "smx_decode_attention")
           for model in T5_MODES for mode in ("greedy", "beam-4")},
        "decode_attention_q8 (t5-small, cross greedy)": (
            "decode_attention.cu", "decode_attention.py:67",
            "t5-greedy-int8", "smx_decode_attention_q8"),
        **{f"beam_gather ({model})": (
            "beam_gather.cu", "beam_gather.py:39",
            f"{model.split('-')[0]}-beam-4", "smx_beam_gather")
           for model in T5_MODES},
        # K4 at the pipeline's 20, 12 and 8 s buckets (T = 500, 300, 200),
        # its launches there
        **{f"decode_attention (cross greedy T={t})": (
            "decode_attention.cu", "decode_attention.py:31",
            "pipeline-float32", "smx_decode_attention")
           for t in (500, 300, 200)},
        # the head widths but 64 (launches_at_head_dim: at that width in
        # that mode's run; 0 where no path of this script reaches it)
        **{f"attention_fwd (D={d})": (
            "attention_fwd.cu", "flash_attention_kernel.py:985",
            "tiny-bart-eval" if d == 16 else "xl-greedy",
            "smx_attention_fwd") for d, _, _ in ATTN_WIDTHS},
        **{f"attention_bwd (D={d})": (
            "attention_bwd.cu", "flash_attention_kernel.py:378",
            "xl-f32-grad", "smx_attention_bwd") for d, _, _ in ATTN_WIDTHS},
        **{f"attention_dropout_fwd (D={d})": (
            "attention_fwd.cu", "flash_attention_kernel.py:727",
            "tiny-bart-train" if d == 16 else "xl-train",
            "smx_attention_dropout_fwd") for d, _, _ in ATTN_WIDTHS},
        **{f"attention_dropout_bwd (D={d})": (
            "attention_bwd.cu", "flash_attention_kernel.py:815",
            "tiny-bart-train" if d == 16 else "xl-train",
            "smx_attention_dropout_bwd") for d, _, _ in ATTN_WIDTHS},
        "decode_attention (D=16, T=64)": (
            "decode_attention.cu", "decode_attention.py:31",
            "tiny-bart-eval", "smx_decode_attention"),
        "decode_attention (D=80, T=400)": (
            "decode_attention.cu", "decode_attention.py:31", "xl-greedy",
            "smx_decode_attention"),
        "decode_attention (t5-3b cross, D=128)": (
            "decode_attention.cu", "decode_attention.py:31", "xl-greedy",
            "smx_decode_attention"),
        "decode_attention_q8 (t5-3b cross, D=128)": (
            "decode_attention.cu", "decode_attention.py:67", "greedy-int8",
            "smx_decode_attention_q8"),
        # the f32 widths above 1024 (launches_at_width: at that H in the XL
        # pair's f32 gradient)
        **{f"ffn_fused (f32, H={h})": ("ffn_fwd.cu", "ffn_kernel.py:128",
                                       "xl-f32-grad", "smx_ffn_down_f32")
           for h in F32_WIDTHS},
        **{f"ffn_bwd (f32, H={h})": ("ffn_bwd.cu", "ffn_kernel.py:631",
                                     "xl-f32-grad",
                                     "smx_ffn_bwd_recompute_f32")
           for h in F32_WIDTHS},
        **{f"ffn_res_ln (f32, H={h})": ("ffn_fwd.cu", "ffn_kernel.py:203",
                                        "xl-f32-grad", "smx_ffn_down_res_f32")
           for h in F32_WIDTHS},
        **{f"dense_res_ln (f32, H={h})": (
            "ffn_fwd.cu", "ffn_kernel.py:381", "xl-f32-grad",
            "smx_dense_res_ln_f32") for h in F32_WIDTHS},
        # the flagship's f32 path (check_f32_rows), the launches of its
        # greedy generate, its default-recipe train step or its step with
        # dropout off, at the row's length, rows or T_in
        **f32_path_rows(),
        # f32 K1 / K14 and K7 / K15 at the XL pair's head width
        # (launches_at_head_dim: K1 and K7 at that width in the XL f32
        # gradient; K14's and K15's f32 entries there, and 0 at that width,
        # in the flagship's f32 step)
        f"attention_fwd (f32, D={F32_ATTN_XL[3]})": (
            "attention_fwd.cu", "flash_attention_kernel.py:985",
            "xl-f32-grad", "smx_attention_fwd"),
        f"attention_dropout_fwd (f32, D={F32_ATTN_XL[3]})": (
            "attention_fwd.cu", "flash_attention_kernel.py:727", "f32-train",
            "smx_attention_dropout_fwd"),
        f"attention_bwd (f32, D={F32_ATTN_XL[3]})": (
            "attention_bwd.cu", "flash_attention_kernel.py:378",
            "xl-f32-grad", "smx_attention_bwd"),
        f"attention_dropout_bwd (f32, D={F32_ATTN_XL[3]})": (
            "attention_bwd.cu", "flash_attention_kernel.py:815", "f32-train",
            "smx_attention_dropout_bwd"),
        # K6 in bf16 off C = 512 (launches_at_width: at that C in the tiny
        # train command)
        **{f"conv_ln_gelu (bf16, C={c})": (
            "conv_ln_gelu.cu", "conv_extractor.py:88", "tiny-bart-train",
            "smx_conv_ln_gelu") for c, _, _ in BF16_CONV_CASES},
        # K6's backward (no TPU kernel: fused_conv_stack_trainable
        # recomputes through XLA) at the six layers: f32 the flagship's
        # step without dropout, by T_in; bf16 the XL pair's step, by C
        **{f"conv_bwd {name} (layer {layer}, {dname})": (
            "conv_bwd.cu", "conv_extractor.py:281", mode,
            f"smx_conv_bwd_{name}")
           for dname, mode in (("f32", "f32-train-no-dropout"),
                               ("bf16", "xl-train"))
           for layer in range(1, 7) for name in ("act", "data", "weight")},
    }
    line = {"kernels": []}
    for name, (source, tpu, mode, *symbol) in replaces.items():
        rec = records[name]
        symbol = symbol[0] if symbol else f"smx_{name}"
        launches = counts[mode][symbol]
        if launches < 1:
            raise AssertionError(f"{name} was not launched by the {mode} run")
        line["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"speechmix_tpu_torch/csrc/{source}",
            "replaces": pallas + tpu, "launches": launches,
            "launches_in": mode,
            "launches_by_mode": {m: c[symbol] for m, c in counts.items()},
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "shape": rec["shape"], "within_tolerance": True,
            **{k: v for k, v in rec.items()
               if k.startswith("library_ms_") or k == "serial_ms"},
        })
        if "on_path" in rec:
            line["kernels"][-1]["width_on_main_path"] = rec["on_path"]
        for at_key in ("length", "rows", "t_in", "head_dim", "width"):
            if at_key in rec:
                at = by_length[mode].get((symbol, rec[at_key]), 0)
                if at < 1 and rec.get("on_path", True):
                    raise AssertionError(f"{name} was not launched at "
                                         f"{at_key} {rec[at_key]} by the "
                                         f"{mode} run")
                line["kernels"][-1][f"launches_at_{at_key}"] = at
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
