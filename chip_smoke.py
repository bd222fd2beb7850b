#!/usr/bin/env python3
"""Smoke run of the PyTorch port (speechmix_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing as it goes; any failure exits non-zero:
  1. the card: name, power limit, torch / CUDA versions; TF32 off;
  2. build the CUDA kernels from speechmix_tpu_torch/csrc with nvcc;
  3. hold each kernel (K1 attention_fwd, K2 dense_res_ln, K3 ffn_res_ln)
     against its plain PyTorch version on the card, in bf16 and f32, at the
     shapes the flagship path gives it, and time kernel, plain version and
     one PyTorch library call beside it, with the least time the card could
     take (bound_ms);
  4. drive the flagship (wav2vec2-base + bart-base, down_scale 2, random
     weights from the seed, bf16 matrices) through generate() at
     B = 16 x 16 s, max_length 64: every kernel must launch 18 times per
     call; the text-encoder output is held against the plain path in f32;
  5. print the `kernels` JSON line, then the card line, then the result
     line {"ok": true, "device": {...}} last.
Without CUDA it exits 1 before printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core rate, HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

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


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name, out, ref, limit=None, rule=None):
    """max |out - ref| after asserting |out - ref| <= limit elementwise;
    the limit defaults to the dtype's TOL."""
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
    ratio = (err / limit).max().item()
    log(f"  {name}: max_abs_err {max_err:.3e}, max err/limit {ratio:.3f} "
        f"({rule}) {'FAIL' if bad.any() else 'ok'}")
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements outside "
                             "tolerance")
    return max_err


def attention_bf16_limit(q, k, v, mask, heads, scale, causal, ref):
    """K1's bf16 limit per output element, from its error model: the kernel
    rounds each probability to bf16 (relative error <= 2^-9) before P . v,
    so before its own rounding it is off by at most 2^-9 * sum_j p_j |v_j|;
    then kernel and plain version each round to bf16 (one ulp apart at most,
    <= 2^-7 |p|).  The limit doubles the first term:
    2^-8 * (P |v|) + 2^-7 * |p|."""
    from speechmix_tpu_torch.ops.kernels import attention as ka
    pv = ka.attention_fwd_plain(q.float(), k.float(), v.float().abs(), mask,
                                heads, scale, causal)
    return 2.0 ** -8 * pv + 2.0 ** -7 * ref.float().abs()


K1_BF16_RULE = "2^-8 * (P|v|) + 2^-7 * |p|"


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
                out = ka.attention_fwd(q, k, v, mask, heads, 0.125, causal)
                ref = ka.attention_fwd_plain(q, k, v, mask, heads, 0.125,
                                             causal)
                torch.cuda.synchronize()
                limit = rule = None
                if dtype == torch.bfloat16:
                    limit = attention_bf16_limit(q, k, v, mask, heads, 0.125,
                                                 causal, ref)
                    rule = K1_BF16_RULE
                compare(f"B={b} T={t} {dtype} causal={causal}", out, ref,
                        limit, rule)
    # bf16 inputs the tensor-core kernel cannot load are refused, not served
    # by another kernel
    slab = torch.empty(4 * 400 * heads * d + 1, dtype=torch.bfloat16,
                       device=dev)
    q_off = slab[1:].view(4, 400, heads * d)
    k = randn(4, 400, heads * d, dtype=torch.bfloat16)
    expect_refusal("K1 bf16 q at a 2-byte offset", lambda: ka.attention_fwd(
        q_off, k, k, None, heads, 0.125))
    # timing at the flagship speech-encoder shape: B=16, T=800, bf16
    b, t = 16, 800
    lens = torch.full((b,), t, device=dev)
    mask = torch.arange(t, device=dev)[None, :] < lens[:, None]
    q, k, v = (randn(b, t, heads * d, dtype=torch.bfloat16) for _ in range(3))
    ref = ka.attention_fwd_plain(q, k, v, mask, heads, 0.125)
    err = compare(f"B={b} T={t} bf16 (timed)",
                  ka.attention_fwd(q, k, v, mask, heads, 0.125), ref,
                  attention_bf16_limit(q, k, v, mask, heads, 0.125, False,
                                       ref), K1_BF16_RULE)
    qh, kh, vh = (x.view(b, t, heads, d).transpose(1, 2) for x in (q, k, v))
    sdpa_mask = mask[:, None, None, :]
    valid_keys = int(lens.sum())
    flops = 4.0 * heads * d * t * valid_keys
    nbytes = 4 * b * t * heads * d * 2 + b * t
    records["attention_fwd"] = dict(
        shape=f"B={b} T={t} H={heads} D={d} bf16", max_abs_err=err,
        ms=cuda_ms(lambda: ka.attention_fwd(q, k, v, mask, heads, 0.125)),
        plain_ms=cuda_ms(lambda: ka.attention_fwd_plain(q, k, v, mask,
                                                        heads, 0.125)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=sdpa_mask, scale=0.125)),
        flops=flops, bytes=nbytes)

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
    for dtype in (torch.bfloat16, torch.float32):
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
    # other widths: bart-large (h 1024, f 4096) in both dtypes; h 256 and
    # h 64 in float32, and refused in bfloat16 (no tensor-core kernel)
    for hh, ff in ((1024, 4096), (256, 1024), (64, 128)):
        for dtype in (torch.bfloat16, torch.float32):
            xo, ro = randn(1000, hh, dtype=dtype), randn(1000, hh, dtype=dtype)
            wo = randn(hh, hh, scale=0.03, dtype=dtype)
            w1o = randn(hh, ff, scale=0.03, dtype=dtype)
            w2o = randn(ff, hh, scale=0.03, dtype=dtype)
            bo, go, beo = (randn(hh, scale=0.1) for _ in range(3))
            b1o = randn(ff, scale=0.1)
            if dtype == torch.bfloat16 and hh not in kf.BF16_HIDDEN:
                expect_refusal(f"K2 N=1000 Din=H={hh} {dtype}",
                               lambda: kf.dense_res_ln(xo, wo, bo, ro, go + 1,
                                                       beo))
                expect_refusal(f"K3 N=1000 H={hh} F={ff} {dtype}",
                               lambda: kf.ffn_res_ln(xo, w1o, b1o, w2o, bo,
                                                     ro, go + 1, beo))
                continue
            compare(f"K2 N=1000 Din=H={hh} {dtype}",
                    kf.dense_res_ln(xo, wo, bo, ro, go + 1, beo),
                    kf.dense_res_ln_plain(xo, wo, bo, ro, go + 1, beo))
            compare(f"K3 N=1000 H={hh} F={ff} gelu {dtype}",
                    kf.ffn_res_ln(xo, w1o, b1o, w2o, bo, ro, go + 1, beo),
                    kf.ffn_res_ln_plain(xo, w1o, b1o, w2o, bo, ro, go + 1,
                                        beo))
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

    for rec in records.values():
        t_flops = rec["flops"] / PEAK_BF16_FLOPS * 1e3
        t_bytes = rec["bytes"] / PEAK_BYTES * 1e3
        rec["bound_ms"] = max(t_flops, t_bytes)
        rec["bound_by"] = "operations" if t_flops >= t_bytes else "bytes"
        log(f"  {rec['shape']}: kernel_ms {rec['ms']:.4f} plain_ms "
            f"{rec['plain_ms']:.4f} library_ms {rec['library_ms']:.4f} "
            f"bound_ms {rec['bound_ms']:.4f} ({rec['bound_by']})")
    return records


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
    """Context that routes the port's three kernel call sites to their plain
    versions, for the f32 reference run of this script only."""

    def __enter__(self):
        from speechmix_tpu_torch.ops import attention as attn_mod
        from speechmix_tpu_torch.ops.kernels import attention as ka
        from speechmix_tpu_torch.ops.kernels import ffn as kf
        self.saved = [(attn_mod, "attention_fwd", attn_mod.attention_fwd),
                      (kf, "ffn_res_ln", kf.ffn_res_ln),
                      (kf, "dense_res_ln", kf.dense_res_ln)]
        attn_mod.attention_fwd = ka.attention_fwd_plain
        kf.ffn_res_ln = kf.ffn_res_ln_plain
        kf.dense_res_ln = kf.dense_res_ln_plain
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def run_flagship(seed, card):
    """Phase 4.  Returns the launch count of each kernel per generate()."""
    import torch
    from speechmix_tpu_torch import config, generation
    from speechmix_tpu_torch.models import seq2seq, speechmix
    from speechmix_tpu_torch.ops import kernels

    cfg = config.SpeechMixConfig(
        encoder=config.SPEECH_ENCODER_PRESETS["wav2vec2-base"],
        decoder=config.SEQ2SEQ_PRESETS["bart-base"], down_scale=2)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = speechmix.init_speechmix(cfg, gen, dev, torch.bfloat16)
    batch, seconds, max_len = 16, 16.0, 64
    t_samples = int(seconds * 16000)
    t_padded = cfg.encoder.aligned_samples(t_samples)
    wav = torch.zeros(batch, t_padded, device=dev)
    wav[:, :t_samples] = torch.randn(batch, t_samples, generator=gen,
                                     device=dev) * 0.1
    lengths = torch.full((batch,), t_samples, device=dev)
    log(f"flagship wav2vec2-base + bart-base, down_scale 2, B={batch} x "
        f"{seconds} s, max_length {max_len}, bf16 matrices")

    counts, times = None, []
    for i in range(8):  # the first two calls are the warm-up
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens, tok_lens = generation.generate(
            params, cfg, wav, lengths, max_length=max_len,
            dtype=torch.bfloat16)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        run_counts = {k.symbol: k.launches for k in kernels.kernels()}
        log(f"  generate call {i}: {dt * 1e3:.1f} ms, launches {run_counts}")
        for sym, c in run_counts.items():
            if c != LAYERS_WITH_KERNELS:
                raise AssertionError(f"{sym} launched {c} times in one "
                                     f"generate(), expected "
                                     f"{LAYERS_WITH_KERNELS}")
        counts = run_counts
        if i >= 2:
            times.append(dt)
    if tokens.shape != (batch, max_len) or (tok_lens < 0).any():
        raise AssertionError(f"bad generate output {tuple(tokens.shape)}")
    med = sorted(times)[len(times) // 2]
    log(f"  audio-seconds per second {batch * seconds / med:.2f} (median of "
        f"{len(times)} calls, {med * 1e3:.1f} ms; all: "
        f"{', '.join(f'{t * 1e3:.1f}' for t in times)}) on {card}")
    stage_breakdown(params, cfg, wav, lengths, max_len)

    def text_encoder_out(p, dtype):
        emb, mask = speechmix.encode_speech(p, cfg, wav, lengths,
                                            dtype=dtype)
        enc = seq2seq.encode(p["nlp"], cfg.decoder, inputs_embeds=emb,
                             attention_mask=mask, dtype=dtype)
        return enc["last_hidden_state"].float(), mask

    p32 = _cast_tree(params, torch.float32)
    with torch.no_grad():
        out_bf16, mask = text_encoder_out(params, torch.bfloat16)
        out_k32, _ = text_encoder_out(p32, torch.float32)
        with plain_kernels():
            ref, _ = text_encoder_out(p32, torch.float32)
            ref_tokens, _ = generation.generate(
                p32, cfg, wav, lengths, max_length=max_len,
                dtype=torch.float32)
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
    agree = (tokens == ref_tokens).float().mean().item()
    log(f"  greedy token agreement, bf16 kernels vs f32 plain path: "
        f"{agree:.4f}")
    return counts


def stage_breakdown(params, cfg, wav, lengths, max_len):
    """Median ms of each stage of generate() (host clock around
    synchronised calls), and the device-busy share of one whole call from
    torch.profiler: summed device time of all kernels over wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
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

    def decode():
        generation.greedy_decode(params["nlp"], cfg.decoder, state["enc"],
                                 state["mask"], max_len, dt)

    with torch.no_grad():
        for name, fn in (("speech encoder + bridge", speech),
                         ("text encoder", text),
                         ("decode loop (cross-KV + 64 steps)", decode)):
            runs = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                runs.append(time.perf_counter() - t0)
            log(f"  stage {name}: {sorted(runs)[2] * 1e3:.1f} ms (median "
                "of 5)")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            generation.generate(params, cfg, wav, lengths,
                                max_length=max_len, dtype=dt)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    log(f"  profiled generate: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms ({busy_us / wall_us:.3f} of wall)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"    {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  "
            f"{e.key[:90]}")


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_tree(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


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

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    records = check_kernels(gen, torch.device("cuda"))
    counts = run_flagship(args.seed, card)

    replaces = {
        "attention_fwd": ("speechmix_tpu_torch/csrc/attention_fwd.cu",
                          "speechmix_tpu/ops/pallas/flash_attention_kernel.py"
                          ":968"),
        "dense_res_ln": ("speechmix_tpu_torch/csrc/dense_res_ln.cu",
                         "speechmix_tpu/ops/pallas/ffn_kernel.py:362"),
        "ffn_res_ln": ("speechmix_tpu_torch/csrc/ffn_res_ln.cu",
                       "speechmix_tpu/ops/pallas/ffn_kernel.py:180"),
    }
    line = {"kernels": []}
    for name, rec in records.items():
        source, tpu = replaces[name]
        line["kernels"].append({
            "name": name, "route": "cuda", "source": source,
            "replaces": tpu, "launches": counts[f"smx_{name}"],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "shape": rec["shape"], "within_tolerance": True,
        })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
