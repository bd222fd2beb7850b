"""Times of the bf16 FFN forward functions K9 (ffn_fused), K3 (ffn_res_ln),
K13 (ffn_dropout) and K12 (ffn_dropout_res_ln), and of the dense epilogue
K2 (dense_res_ln) and K11 (dense_dropout_res_ln) with Din = H, on one card,
at the row counts the flagship's layers give them and at rows that fill no
tile.  Beside K2 and K11, their two-launch form (the down pass to the f32
sum, ffn_down with res, then the LayerNorm rows, res_ln_rows).

    python speechmix_tpu_torch/time_ffn_forward.py [--repo DIR] [--seed N]
        [--f32-tiles]

DIR is the checkout whose speechmix_tpu_torch is timed (default: the one
that holds this file).  Only public wrappers are called, and every version
of the port since the passes shares their signatures, so two checkouts are
compared by running the script on each within one call to the card.  Per
function and shape it prints the device ms of back-to-back calls (the
card held busy first, so that no gap between launches is counted) and the
host-clock ms of a call waited for alone (launch latency included), then
one JSON object.

--f32-tiles times instead the f32 passes of DIR's csrc/ffn_fwd.cu (the up
pass, the down pass to z, and that pass on a square weight as K2 runs it)
in two builds of that source, its choice of tile width pinned to 64
columns in one and to 128 in the other, at the row counts of the f32 path
and the XL pair's, through the C entries (weights already transposed).
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


# the line of ffn_fwd.cu that picks 64-column tiles for the f32 passes
F32_TILE_RULE = "if (2 * wide <= sm_count(device)) {"
F32_TILE_SHAPES = ((1024, 768, 3072), (1024, 1280, 5120), (3200, 768, 3072),
                   (3200, 1280, 5120), (6400, 768, 3072), (12800, 768, 3072))


def f32_tiles(repo, seed):
    """The f32 passes of repo's ffn_fwd.cu built with 64- and with
    128-column tiles, timed at F32_TILE_SHAPES."""
    import ctypes
    import torch
    from speechmix_tpu_torch.ops.kernels import _cuda
    src = (_cuda.CSRC / "ffn_fwd.cu").read_text()
    if src.count(F32_TILE_RULE) != 1:
        raise RuntimeError("ffn_fwd.cu has no f32 tile rule to pin")
    out_dir = os.path.join(repo, "speechmix_tpu_torch", "_build", "tiles")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, pinned in (("64", "if (true) {"), ("128", "if (false) {")):
        path = os.path.join(out_dir, f"ffn_fwd_{name}.cu")
        with open(path, "w") as fh:
            fh.write(src.replace(F32_TILE_RULE, pinned))
        procs[name] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.ARCH_FLAGS, "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-I", str(_cuda.CSRC), "-o",
             path[:-3] + ".so", path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(log)
        libs[name] = ctypes.CDLL(os.path.join(out_dir, f"ffn_fwd_{name}.so"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    randn = lambda *s, scale=1.0: torch.randn(  # noqa: E731
        *s, generator=gen, device=dev) * scale
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    rows = []
    for n, h, f in F32_TILE_SHAPES:
        x, res = randn(n, h), randn(n, h)
        w1t, w2t = randn(f, h, scale=0.03), randn(h, f, scale=0.03)
        wt = randn(h, h, scale=0.03)
        b1, b2 = randn(f, scale=0.1), randn(h, scale=0.1)
        hid, z = torch.empty(n, f, device=dev), torch.empty(n, h, device=dev)
        for name, lib in libs.items():
            stream = lambda: ctypes.c_void_p(  # noqa: E731
                torch.cuda.current_stream().cuda_stream)

            def call(rc):
                if rc:
                    raise RuntimeError(f"cudaError_t {rc}")
            fns = {
                "up": lambda: call(lib.smx_ffn_up_f32(
                    ptr(x), ptr(w1t), ptr(b1), ptr(hid), n, h, f, 0, 0,
                    stream())),
                "down_res": lambda: call(lib.smx_ffn_down_res_f32(
                    ptr(hid), ptr(w2t), ptr(b2), ptr(res), ptr(z), n, h, f,
                    0, stream())),
                "down_res Din=H": lambda: call(lib.smx_ffn_down_res_f32(
                    ptr(x), ptr(wt), ptr(b2), ptr(res), ptr(z), n, h, h, 0,
                    stream()))}
            for what, fn in fns.items():
                row = dict(fn=f"f32 {what}", tile=int(name), n=n, h=h, f=f,
                           ms=device_ms(fn))
                print(f"f32 {what} {name}-column tiles N={n} H={h} F={f}: "
                      f"{row['ms']:.4f} ms back to back", flush=True)
                rows.append(row)
    return rows


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--repo", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--f32-tiles", action="store_true")
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
    rows = f32_tiles(repo, args.seed) if args.f32_tiles else run(args.seed)
    print(json.dumps({"repo": repo, "card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
