"""Times of the bf16 FFN forward functions K9 (ffn_fused), K3 (ffn_res_ln),
K13 (ffn_dropout) and K12 (ffn_dropout_res_ln), and of the dense epilogue
K2 (dense_res_ln) and K11 (dense_dropout_res_ln) with Din = H, on one card,
at the row counts the flagship's layers give them and at rows that fill no
tile.  Beside K2 and K11, their two-launch form (the down pass to the f32
sum, ffn_down with res, then the LayerNorm rows, res_ln_rows).

    python speechmix_tpu_torch/time_ffn_forward.py [--repo DIR] [--seed N]

DIR is the checkout whose speechmix_tpu_torch is timed (default: the one
that holds this file).  Only public wrappers are called, and every version
of the port since the passes shares their signatures, so two checkouts are
compared by running the script on each within one call to the card.  Per
function and shape it prints the device ms of back-to-back calls (the
card held busy first, so that no gap between launches is counted) and the
host-clock ms of a call waited for alone (launch latency included), then
one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

# (N, H, F): the speech encoder's, text encoder's and decoder's rows of the
# train step (B = 16 x 16 s, 64 labels), and row counts off the 128 tile;
# K2 and K11 take (N, H) as (N, Din = H)
SHAPES = ((12800, 768, 3072), (6400, 768, 3072), (4001, 768, 3072),
          (1024, 768, 3072), (1000, 768, 3072), (1000, 1024, 4096))
RATE = 0.1


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


def alone_ms(fn, iters=50):
    """Median host-clock ms of one call and its wait."""
    import torch
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run(seed):
    import torch
    from speechmix_tpu_torch.ops.kernels import ffn as kf
    from speechmix_tpu_torch.ops.kernels.dropout import DropoutKey

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed)
    randn = lambda *s, scale=1.0: torch.randn(
        *s, generator=gen, device=dev) * scale
    key = DropoutKey.from_seed(seed)
    rows = []
    for n, h, f in SHAPES:
        x, res = randn(n, h).to(bf16), randn(n, h).to(bf16)
        w1 = randn(h, f, scale=0.03).to(bf16)
        w2 = randn(f, h, scale=0.03).to(bf16)
        w = randn(h, h, scale=0.03).to(bf16)
        b1, b2 = randn(f, scale=0.1), randn(h, scale=0.1)
        g, beta = randn(h, scale=0.1) + 1.0, randn(h, scale=0.1)
        fns = {
            "K9 ffn_fused": lambda: kf.ffn_fused(x, w1, b1, w2, b2),
            "K3 ffn_res_ln": lambda: kf.ffn_res_ln(x, w1, b1, w2, b2, res, g,
                                                   beta),
            "K13 ffn_dropout": lambda: kf.ffn_dropout(x, w1, b1, w2, b2, key,
                                                      RATE),
            "K12 ffn_dropout_res_ln": lambda: kf.ffn_dropout_res_ln(
                x, w1, b1, w2, b2, res, g, beta, key, RATE, RATE),
            "K2 dense_res_ln": lambda: kf.dense_res_ln(x, w, b2, res, g,
                                                       beta),
            "K11 dense_dropout_res_ln": lambda: kf.dense_dropout_res_ln(
                x, w, b2, res, g, beta, key, RATE),
            "K2 as two passes": lambda: kf.res_ln_rows(
                kf.ffn_down(x, w, b2, res), g, beta),
            "K11 as two passes": lambda: kf.res_ln_rows(
                kf.ffn_down(x, w, b2, res, key, RATE), g, beta)}
        for name, fn in fns.items():
            dense = name.startswith(("K2 ", "K11 "))
            row = dict(fn=name, n=n, h=h, ms=device_ms(fn),
                       alone_ms=alone_ms(fn), **({} if dense else {"f": f}))
            shape = f"N={n} Din=H={h}" if dense else f"N={n} H={h} F={f}"
            print(f"{name} {shape}: {row['ms']:.4f} ms back to back, "
                  f"{row['alone_ms']:.4f} ms alone", flush=True)
            rows.append(row)
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
