"""Cycles per tf32 warpgroup product on one H100 SM, the products of K7 /
K15's f32 body (csrc/attention_bwd.cu): m64n32k8 and m64n64k8 with both
operands in shared memory (on 1 or 2 independent accumulators) and
m64n64k8 with A in registers (on 2: on one, ptxas serializes them for want
of registers), each issued back to back by one or by two warpgroups of a
block (one block on each of 132 SMs).

    python speechmix_tpu_torch/time_wgmma_tf32.py

It compiles the kernel below with the CUDA toolkit's nvcc for sm_90a (into
speechmix_tpu_torch/_build/, with csrc/hopper.cuh), runs it, and prints per
case the cycles between two wgmma of one warpgroup (clock64 over 2048
products) and the SM's tf32 FLOPs per cycle, then one JSON object.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent
SOURCE = r"""
#include <cstdio>
#include "hopper.cuh"
namespace hw = smx::hopper;

// m64n64k8 with both operands in shared memory, d an output only
__device__ __forceinline__ void ss64_zero(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
        "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db));
}

// KIND 0: SS m64n32k8, 1: SS m64n64k8, 2: RS m64n64k8 (A in registers);
// CH independent accumulators, each started by a write-only product (an
// accumulator defined by other instructions before the loop would make
// ptxas serialize the products)
template <int KIND, int CH>
__global__ void __launch_bounds__(256, 1) bench(float* out, long long* cyc,
                                                int iters) {
  extern __shared__ uint8_t raw[];
  uint8_t* sm = hw::align1024(raw);
  for (int i = threadIdx.x; i < 65536 / 4; i += blockDim.x)
    reinterpret_cast<float*>(sm)[i] = 0.001f * (i % 7);
  __syncthreads();
  hw::fence_async_smem();
  __syncthreads();
  const int wg = threadIdx.x / 128;
  const uint64_t da = hw::desc_sw128(sm + wg * 8192, 16, 1024);
  const uint64_t db = hw::desc_sw128(sm + 16384 + wg * 16384, 16, 1024);
  constexpr int N = KIND == 0 ? 32 : 64;
  float acc[CH][N / 2];
  const uint32_t a[4] = {0x3c000000u, 0x3c000000u, 0x3c000000u,
                         0x3c000000u};
  hw::wgmma_fence();
  const long long t0 = clock64();
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    if constexpr (KIND == 0) hw::wgmma_m64n32k8_tf32_zero(acc[c], da, db);
    else if constexpr (KIND == 1) ss64_zero(acc[c], da, db);
    else hw::wgmma_m64n64k8_tf32_rs_zero(acc[c], a, db);
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if constexpr (KIND == 0)
          hw::wgmma_m64n32k8_tf32(acc[c], da + 2 * k, db + 2 * k, 1);
        else if constexpr (KIND == 1)
          hw::wgmma_m64n64k8_tf32(acc[c], da + 2 * k, db + 2 * k, 1);
        else hw::wgmma_m64n64k8_tf32_rs(acc[c], a, db + 2 * k, 1);
      }
  }
  hw::wgmma_commit();
  hw::wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < CH; ++c) hw::fence_regs(acc[c]);
  const long long t1 = clock64();
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) s += acc[c][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x % 128 == 0 && blockIdx.x == 0) cyc[wg] = t1 - t0;
}

template <int KIND, int CH>
void run(const char* name, int wgs) {
  float* out;
  long long* cyc;
  cudaMalloc(&out, 132 * 256 * 4);
  cudaMalloc(&cyc, 16);
  const int iters = 512;
  cudaFuncSetAttribute(bench<KIND, CH>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       65536 + 1024);
  bench<KIND, CH><<<132, 128 * wgs, 65536 + 1024>>>(out, cyc, iters);
  bench<KIND, CH><<<132, 128 * wgs, 65536 + 1024>>>(out, cyc, iters);
  cudaError_t e = cudaDeviceSynchronize();
  long long c[2] = {0, 0};
  cudaMemcpy(c, cyc, 16, cudaMemcpyDeviceToHost);
  const double n = (double)iters * 4 * CH + CH;
  const int N = KIND == 0 ? 32 : 64;
  const double flops = 64.0 * N * 8 * 2;
  printf("%-12s chains %d wgs %d: %.1f cycles per wgmma per WG, %.0f tf32 "
         "FLOP/cycle/SM (%s)\n",
         name, CH, wgs, c[0] / n, flops * n * wgs / c[0],
         cudaGetErrorString(e));
  cudaFree(out);
  cudaFree(cyc);
}

int main() {
  for (int wgs = 1; wgs <= 2; ++wgs) {
    run<0, 1>("SS m64n32", wgs);
    run<0, 2>("SS m64n32", wgs);
    run<1, 1>("SS m64n64", wgs);
    run<1, 2>("SS m64n64", wgs);
    run<2, 2>("RS m64n64", wgs);
  }
  return 0;
}
"""


def main():
    from speechmix_tpu_torch.ops.kernels import _cuda
    build = _cuda.BUILD_DIR
    build.mkdir(parents=True, exist_ok=True)
    cu, exe = build / "time_wgmma_tf32.cu", build / "time_wgmma_tf32"
    cu.write_text(SOURCE)
    build_log = subprocess.run(
        [_cuda._nvcc(), *_cuda.ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas",
         "-v", "-I", str(PKG / "csrc"), "-o", str(exe), str(cu)],
        check=True, capture_output=True, text=True).stderr
    # a serialized product would time its latency, not its rate
    serialized = [line for line in build_log.splitlines()
                  if "serialized" in line]
    if serialized:
        print("\n".join(serialized))
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    out = subprocess.run([str(exe)], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    print(f"nvidia-smi: {card}")
    print(out, end="")
    rows = [dict(zip(("product", "chains", "warpgroups", "cycles",
                      "flops_per_cycle"), (m[0], int(m[1]), int(m[2]),
                                           float(m[3]), float(m[4]))))
            for m in re.findall(r"(\S+ \S+)\s+chains (\d) wgs (\d): "
                                r"([\d.]+) cycles per wgmma per WG, "
                                r"(\d+) tf32", out)]
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(PKG.parent))
    sys.exit(main())
