// Shared device helpers of the port's kernels: f32 <-> storage-type
// conversion, the FFN activations, and the residual + LayerNorm epilogue
// that dense_res_ln.cu and ffn_res_ln.cu share (with the output dropout of
// their dropout entries, from dropout.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dropout.cuh"

namespace smx {

enum DType { kF32 = 0, kBF16 = 1 };
enum Act { kGelu = 0, kGeluTanh = 1, kRelu = 2, kSilu = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float activate(int act, float x) {
  switch (act) {
    case kGelu:
      return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
    case kGeluTanh: {
      const float c = 0.79788456080286536f;  // sqrt(2 / pi)
      return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
    }
    case kRelu:
      return fmaxf(x, 0.0f);
    default:  // kSilu
      return x / (1.0f + expf(-x));
  }
}

// d activate(act, x) / dx, in the same closed forms as the TPU backward
// kernels' _dact_f32.
__device__ __forceinline__ float dactivate(int act, float x) {
  switch (act) {
    case kGelu: {
      const float pdf = expf(-0.5f * x * x) * 0.39894228040143268f;  // 1/sqrt(2 pi)
      return 0.5f * (1.0f + erff(x * 0.70710678118654752f)) + x * pdf;
    }
    case kGeluTanh: {
      const float c = 0.79788456080286536f;
      const float t = tanhf(c * (x + 0.044715f * x * x * x));
      return 0.5f * (1.0f + t) +
             0.5f * x * (1.0f - t * t) * c * (1.0f + 3.0f * 0.044715f * x * x);
    }
    case kRelu:
      return x > 0.0f ? 1.0f : 0.0f;
    default: {  // kSilu
      const float s = 1.0f / (1.0f + expf(-x));
      return s * (1.0f + x * (1.0f - s));
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Row sums of a (BM, NT * MAXC) tile spread over the block: thread `tid`
// holds columns tid + j * NT of every row in part[r][j].  Returns the sum
// of row r (of its squares with SQ) in out[r] on every thread.  `red` is (NT / 32) * BM floats of
// shared memory, `tot` BM floats.
template <int BM, int MAXC, int NT, bool SQ>
__device__ __forceinline__ void block_row_sums(const float (&part)[BM][MAXC],
                                               float (&out)[BM], float* red,
                                               float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < MAXC; ++j) s += SQ ? part[r][j] * part[r][j] : part[r][j];
    s = warp_sum(s);
    if (lane == 0) red[warp * BM + r] = s;
  }
  __syncthreads();
  if (threadIdx.x < BM) {
    float s = 0.0f;
    for (int w = 0; w < NT / 32; ++w) s += red[w * BM + threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < BM; ++r) out[r] = tot[r];
  __syncthreads();  // red / tot are reused by the next call
}

// out[row, c] = LayerNorm(acc + bias + res)[row, c] * g[c] + beta[c] for the
// rows r0 .. r0 + BM - 1 (< n) of an (n, h) output.  acc holds columns
// tid + j * NT of every row, accumulated in f32.  Mean and variance are taken
// over the f32 sum, as the TPU kernels' epilogue does.  With DROP the sum is
// (acc + bias) * mask(row, c) + res, the mask from `drop` (one Philox call
// per element: these float32 kernels are f32-FMA bodies, not yet tuned).
template <typename T, int BM, int MAXC, int NT, bool DROP = false>
__device__ __forceinline__ void res_ln_epilogue(
    float (&acc)[BM][MAXC], const float* __restrict__ bias,
    const T* __restrict__ res, const float* __restrict__ g,
    const float* __restrict__ beta, T* __restrict__ out, int n, int h, int r0,
    float eps, float* red, float* tot, const Dropout& drop = Dropout{}) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    const int row = r0 + r;
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {
      const int c = tid + j * NT;
      if (c < h && row < n) {
        if constexpr (DROP) {
          acc[r][j] = (acc[r][j] + bias[c]) * drop.at(row, c) +
                      to_f32(res[(long long)row * h + c]);
        } else {
          acc[r][j] += bias[c] + to_f32(res[(long long)row * h + c]);
        }
      } else {
        acc[r][j] = 0.0f;
      }
    }
  }
  float mean[BM];
  block_row_sums<BM, MAXC, NT, false>(acc, mean, red, tot);
  const float inv_h = 1.0f / (float)h;
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    mean[r] *= inv_h;
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {
      const int c = tid + j * NT;
      acc[r][j] = c < h ? acc[r][j] - mean[r] : 0.0f;
    }
  }
  float var[BM];
  block_row_sums<BM, MAXC, NT, true>(acc, var, red, tot);
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    const int row = r0 + r;
    if (row >= n) continue;
    const float inv = rsqrtf(var[r] * inv_h + eps);
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {
      const int c = tid + j * NT;
      if (c < h) {
        out[(long long)row * h + c] = from_f32<T>(acc[r][j] * inv * g[c] + beta[c]);
      }
    }
  }
}

}  // namespace smx
