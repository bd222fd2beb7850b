"""Times of the bf16 attention forward, K1 (attention_fwd) and K14
(attention_dropout_fwd), at the flagship path's three attention shapes, and
of the extractor layer K6 (conv_ln_gelu) at its six layers, on one card,
with the device time of each of their CUDA kernels.

    python speechmix_tpu_torch/time_attention_conv_forward.py [--repo DIR]
        [--seed N]

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


def timed(rows, name, fn, **shape):
    row = dict(fn=name, **shape, ms=device_ms(fn), kernels=kernel_ms(fn))
    parts = ", ".join(f"{n} {ms:.4f}" for n, ms in row["kernels"].items())
    what = " ".join(f"{k}={v}" for k, v in shape.items())
    print(f"{name} {what}: {row['ms']:.4f} ms back to back; per kernel: "
          f"{parts}", flush=True)
    rows.append(row)


def run(seed):
    import torch
    from speechmix_tpu_torch.ops.kernels import attention as ka
    from speechmix_tpu_torch.ops.kernels import conv_extractor as kc
    from speechmix_tpu_torch.ops.kernels.dropout import DropoutKey

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed)
    key = DropoutKey.from_seed(seed)
    rows = []
    for b, t, causal in ATTENTION_SHAPES:
        q, k, v = (torch.randn(b, t, HEADS * HEAD_DIM, generator=gen,
                               device=dev).to(bf16) for _ in range(3))
        mask = torch.ones(b, t, dtype=torch.bool, device=dev)
        timed(rows, "K1 attention_fwd", lambda: ka.attention_fwd(
            q, k, v, mask, HEADS, SCALE, causal), b=b, t=t, causal=causal)
        timed(rows, "K14 attention_dropout_fwd",
              lambda: ka.attention_dropout_fwd(q, k, v, mask, HEADS, SCALE,
                                               causal, key, RATE),
              b=b, t=t, causal=causal)
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
    print(json.dumps({"repo": repo, "card": card, "rows": run(args.seed)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
