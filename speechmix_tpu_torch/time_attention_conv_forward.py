"""Times of the bf16 attention forward, K1 (attention_fwd) and K14
(attention_dropout_fwd), at the flagship path's three attention shapes, and
of the extractor layer K6 (conv_ln_gelu) at its six layers, on one card,
with the device time of each of their CUDA kernels; or with --f32 of K1 and
K14 in float32 at the f32 path's three shapes and the XL pair's (16 heads
of 80), beside one library call for the same function
(scaled_dot_product_attention in full f32, TF32 off).

    python speechmix_tpu_torch/time_attention_conv_forward.py [--repo DIR]
        [--seed N] [--f32]

DIR is the checkout whose speechmix_tpu_torch is timed (default: the one
that holds this file).  Only the public wrappers are called, and every
version of the port shares their signatures, so two checkouts are compared
by running the script on each within one call to the card.  Per function
and shape it prints the device ms of back-to-back calls (the card held busy
first, so that no gap between launches is counted) and the device ms of
each kernel of one call from the profiler, then one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

# (B, T, causal): the speech encoder's, the text encoder's and the decoder's
# self-attention (B = 16 x 16 s, 64 labels); H = 12, D = 64
ATTENTION_SHAPES = ((16, 800, False), (16, 400, False), (16, 64, True))
HEADS, HEAD_DIM, SCALE, RATE = 12, 64, 0.125, 0.1
# (T_in, k) of the flagship extractor's stride-2 layers 1-6 at 16 s (the
# samples padded as generate() pads them), B = 16, C = 512, no LayerNorm
# (wav2vec2-base)
CONV_LAYERS = ((51263, 3), (25631, 3), (12815, 3), (6407, 3), (3203, 2),
               (1601, 2))
BATCH, CHANNELS = 16, 512
# with --f32 also (B, T, H, D) of the XL pair's speech encoder
XL_SHAPE = (16, 800, 16, 80)


def device_ms(fn, iters=20, warmup=3):
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


def kernel_ms(fn, calls=5):
    """Device ms per call of each CUDA kernel fn launches, by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    name = re.compile(r"\w+_kernel(<[^>]*>)?")
    out = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            m = name.search(e.key)
            key = m.group(0) if m else e.key[:40]
            ms = e.self_device_time_total / 1e3 / calls
            out[key] = out.get(key, 0.0) + ms
    return out


def timed(rows, name, fn, library=None, **shape):
    row = dict(fn=name, **shape, ms=device_ms(fn), kernels=kernel_ms(fn))
    if library is not None:
        row["library_ms"] = device_ms(library)
    parts = ", ".join(f"{n} {ms:.4f}" for n, ms in row["kernels"].items())
    what = " ".join(f"{k}={v}" for k, v in shape.items())
    lib = (f"; library {row['library_ms']:.4f} ms" if library is not None
           else "")
    print(f"{name} {what}: {row['ms']:.4f} ms back to back{lib}; per "
          f"kernel: {parts}", flush=True)
    rows.append(row)


def run(seed, f32=False):
    import torch
    import torch.nn.functional as F
    from speechmix_tpu_torch.ops.kernels import attention as ka
    from speechmix_tpu_torch.ops.kernels import conv_extractor as kc
    from speechmix_tpu_torch.ops.kernels.dropout import DropoutKey

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    dtype = torch.float32 if f32 else bf16
    gen = torch.Generator(device=dev).manual_seed(seed)
    key = DropoutKey.from_seed(seed)
    rows = []
    shapes = [(b, t, HEADS, HEAD_DIM, causal)
              for b, t, causal in ATTENTION_SHAPES]
    if f32:
        shapes.append(XL_SHAPE + (False,))
    for b, t, heads, d, causal in shapes:
        scale = d ** -0.5
        q, k, v = (torch.randn(b, t, heads * d, generator=gen,
                               device=dev).to(dtype) for _ in range(3))
        mask = torch.ones(b, t, dtype=torch.bool, device=dev)
        qh, kh, vh = (x.view(b, t, heads, d).transpose(1, 2)
                      for x in (q, k, v))
        shape = dict(dtype=str(dtype)[6:], b=b, t=t, heads=heads,
                     head_dim=d, causal=causal)

        def library(rate):
            """the library's call in float32, None in bfloat16"""
            if not f32:
                return None
            return lambda: F.scaled_dot_product_attention(
                qh, kh, vh, dropout_p=rate, is_causal=causal, scale=scale)
        timed(rows, "K1 attention_fwd", lambda: ka.attention_fwd(
            q, k, v, mask, heads, scale, causal), library(0.0), **shape)
        timed(rows, "K14 attention_dropout_fwd",
              lambda: ka.attention_dropout_fwd(q, k, v, mask, heads, scale,
                                               causal, key, RATE),
              library(RATE), **shape)
    if f32:
        return rows
    for layer, (t_in, k) in enumerate(CONV_LAYERS, start=1):
        x = torch.randn(BATCH, t_in, CHANNELS, generator=gen,
                        device=dev).to(bf16)
        w = (torch.randn(CHANNELS, CHANNELS, k, generator=gen, device=dev)
             * (k * CHANNELS) ** -0.5).to(bf16)
        bias = torch.randn(CHANNELS, generator=gen, device=dev) * 0.1
        timed(rows, "K6 conv_ln_gelu", lambda: kc.fused_conv_layer(
            x, w, bias), layer=layer, b=BATCH, t_in=t_in, k=k)
        del x
    return rows


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--repo", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--f32", action="store_true",
                        help="K1 / K14 in float32 at the f32 path's and the "
                        "XL pair's shapes, beside the library call")
    args = parser.parse_args()
    repo = os.path.abspath(args.repo)
    sys.path[0] = repo      # in place of this file's folder, the package
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"timing {repo}; nvidia-smi: {card}", flush=True)
    print(json.dumps({"repo": repo, "card": card,
                      "rows": run(args.seed, args.f32)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
