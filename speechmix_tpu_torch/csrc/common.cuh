// Shared device helpers of the port's kernels: f32 <-> storage-type
// conversion, the FFN activations and their derivatives, pairs of row
// elements to and from float32, and a warp's sum
// (with dropout.cuh, the mask generator every kernel that draws a mask
// shares).
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

// two adjacent elements of a row, to or from float32
__device__ __forceinline__ void store_pair(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* o, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace smx
