"""Times of K4 (decode_attention), its bf16 entry and its int8 entry, at
the decoder's shapes on one card, with the device time of each of its CUDA
kernels.

    python speechmix_tpu_torch/time_decode_attention.py [--repo DIR]
        [--seed N]

DIR is the checkout whose speechmix_tpu_torch is timed (default: the one
that holds this file).  Only the public wrapper ``decode_attention`` is
called, and every version of the port shares its signature, so two
checkouts are compared by running the script on each within one call to
the card; where the checkout has ``decode_attention_serial`` (its serial
body) that is timed too.  Each shape holds six layers' K/V (bf16 q, 12
heads of 64) and the timed calls cycle over them, as the decoder's six
layers do: the cross-attention K/V (62 to 118 MB) is then more than the
50 MB L2 holds.  Per entry and shape it prints the device ms of
back-to-back calls (the card held busy first, so that no gap between
launches is counted) and the device ms of each kernel of one call from the
profiler, then one JSON object.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import re
import subprocess
import sys

# (name, K/V rows, queries per row, keys): the decoder's self-attention over
# the 64-slot cache and cross-attention over 16 s of audio (400 encoder
# frames), greedy (B = 16) and beam-4 (the beams share the cross K/V); and
# cross-attention over 30 s (1500 frames)
SHAPES = (("self greedy", 16, 1, 64), ("self beam-4", 64, 1, 64),
          ("cross greedy", 16, 1, 400), ("cross beam-4", 16, 4, 400),
          ("cross greedy T=1500", 16, 1, 1500))
HEADS, HEAD_DIM, SCALE, LAYERS = 12, 64, 0.125, 6


def device_ms(fn, iters=60, warmup=6):
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


def kernel_ms(fn, calls=12):
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
            out[key] = out.get(key, 0.0) + e.self_device_time_total / 1e3 / calls
    return out


def mask_of(name, bkv, t, dev):
    """Self-attention: the slots up to the row's step are filled; cross-
    attention: 200 to 400 (750 to 1500) valid encoder frames per row."""
    import torch
    rows = torch.arange(bkv, device=dev)
    fill = (rows % t if name.startswith("self")
            else t - 1 - (rows * 23) % (t // 2))
    return torch.arange(t, device=dev)[None, :] <= fill[:, None]


def run(seed):
    import torch
    from speechmix_tpu_torch.models.seq2seq import _quantize_kv
    from speechmix_tpu_torch.ops.kernels import decode_attention as kd

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed)
    bodies = [("", kd.decode_attention)]
    if hasattr(kd, "decode_attention_serial"):
        bodies.append((" (serial body)", kd.decode_attention_serial))
    rows = []
    for name, bkv, kb, t in SHAPES:
        mask = mask_of(name, bkv, t, dev)
        q = torch.randn(bkv * kb, 1, HEADS, HEAD_DIM, generator=gen,
                        device=dev).to(bf16)
        layers = []
        for _ in range(LAYERS):
            k, v = (torch.randn(bkv, t, HEADS, HEAD_DIM, generator=gen,
                                device=dev).to(bf16) for _ in range(2))
            layers.append((k, v))
        entries = [("bf16", layers, [{}] * LAYERS)]
        if name.startswith("cross"):
            quant = [(_quantize_kv(k), _quantize_kv(v)) for k, v in layers]
            entries.append(("int8", [(kq, vq) for (kq, _), (vq, _) in quant],
                            [dict(k_scale=ks, v_scale=vs)
                             for (_, ks), (_, vs) in quant]))
        for entry, kv, scales in entries:
            for suffix, fn in bodies:
                turn = itertools.cycle(range(LAYERS))

                def call():
                    i = next(turn)
                    return fn(q, kv[i][0], kv[i][1], mask, scale=SCALE,
                              num_heads=HEADS, **scales[i])
                row = dict(fn=f"K4 {entry}{suffix}", shape=name, bkv=bkv,
                           kb=kb, t=t, attended=int(mask.sum()),
                           ms=device_ms(call), kernels=kernel_ms(call))
                parts = ", ".join(f"{n} {ms:.4f}"
                                  for n, ms in row["kernels"].items())
                print(f"{row['fn']} {name} (B={bkv} kb={kb} T={t}): "
                      f"{row['ms']:.4f} ms back to back; per kernel: {parts}",
                      flush=True)
                rows.append(row)
        del layers, entries
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
