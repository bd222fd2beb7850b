"""Times of the attention backward, K7 (attention_bwd) and K15
(attention_dropout_bwd), on one card at the train step's three attention
shapes, with the device time of each of their CUDA kernels: in bfloat16, or
with --f32 in float32 (the f32 path's shapes and the XL pair's, 16 heads of
80), beside one library call for the same gradients (the autograd of
scaled_dot_product_attention in full f32, TF32 off).

    python speechmix_tpu_torch/time_attention_backward.py [--repo DIR]
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
# self-attention in the train step (B = 16 x 16 s, 64 labels); H = 12, D = 64
SHAPES = ((16, 800, False), (16, 400, False), (16, 64, True))
HEADS, HEAD_DIM, SCALE, RATE = 12, 64, 0.125, 0.1
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


def run(seed, f32=False):
    import torch
    import torch.nn.functional as F
    from speechmix_tpu_torch.ops.kernels import attention as ka
    from speechmix_tpu_torch.ops.kernels.dropout import DropoutKey

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    dtype = torch.float32 if f32 else torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed)
    key = DropoutKey.from_seed(seed)
    shapes = [(b, t, HEADS, HEAD_DIM, causal) for b, t, causal in SHAPES]
    if f32:
        shapes.append(XL_SHAPE + (False,))
    rows = []
    for b, t, heads, d, causal in shapes:
        scale = d ** -0.5
        q, k, v, g = (torch.randn(b, t, heads * d, generator=gen,
                                  device=dev).to(dtype) for _ in range(4))
        mask = torch.ones(b, t, dtype=torch.bool, device=dev)
        out, lse = ka.attention_fwd(q, k, v, mask, heads, scale, causal,
                                    return_lse=True)
        dout, dlse = ka.attention_dropout_fwd(q, k, v, mask, heads, scale,
                                              causal, key, RATE,
                                              return_lse=True)
        fns = {
            "K7 attention_bwd": lambda: ka.attention_bwd(
                q, k, v, mask, out, lse, g, heads, scale, causal),
            "K15 attention_dropout_bwd": lambda: ka.attention_dropout_bwd(
                q, k, v, mask, dout, dlse, g, heads, scale, causal, key,
                RATE)}
        library = {}
        if f32:
            qh, kh, vh = (x.view(b, t, heads, d).transpose(1, 2).detach()
                          .requires_grad_() for x in (q, k, v))
            gh = g.view(b, t, heads, d).transpose(1, 2)
            for name, p in (("K7 attention_bwd", 0.0),
                            ("K15 attention_dropout_bwd", RATE)):
                lib_out = F.scaled_dot_product_attention(
                    qh, kh, vh, dropout_p=p, is_causal=causal, scale=scale)
                library[name] = device_ms(
                    lambda: torch.autograd.grad(lib_out, (qh, kh, vh), gh,
                                                retain_graph=True))
                del lib_out
        for name, fn in fns.items():
            row = dict(fn=name, dtype="float32" if f32 else "bfloat16", b=b,
                       t=t, heads=heads, head_dim=d, causal=causal,
                       ms=device_ms(fn), kernels=kernel_ms(fn))
            if f32:
                row["library_ms"] = library[name]
            parts = ", ".join(f"{n} {ms:.4f}"
                              for n, ms in row["kernels"].items())
            lib = (f"; library {row['library_ms']:.4f} ms" if f32 else "")
            print(f"{name} {row['dtype']} B={b} T={t} H={heads} D={d} "
                  f"causal={causal}: {row['ms']:.4f} ms back to back{lib}; "
                  f"per kernel: {parts}", flush=True)
            rows.append(row)
    return rows


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--repo", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--f32", action="store_true",
                        help="float32 at the f32 path's and the XL pair's "
                        "shapes, beside the library call")
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
