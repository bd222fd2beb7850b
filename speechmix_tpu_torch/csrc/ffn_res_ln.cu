// K3: ffn_res_ln — out = LayerNorm(res + act(x @ w1 + b1) @ w2 + b2) * g + beta
// (entry smx_ffn_res_ln), and K9: ffn_fused — out = act(x @ w1 + b1) @ w2 + b2,
// the same body without the residual + LayerNorm epilogue (entry
// smx_ffn_fused; res, g and beta are not read).  Their dropout twins, the
// same bodies instantiated with DROP: K12 ffn_dropout_res_ln —
// LayerNorm(res + drop_o(drop_a(act(x @ w1 + b1)) @ w2 + b2)) (entry
// smx_ffn_dropout_res_ln), and K13 ffn_dropout — drop_a(act(x @ w1 + b1)) @
// w2 + b2 (entry smx_ffn_dropout).  These entries take float32, the
// default dtype; bfloat16 runs the TMA + wgmma passes of ffn_fwd.cu.
//
// K3 replaces the TPU kernel speechmix_tpu/ops/pallas/ffn_kernel.py:
// ffn_fused_res_ln (_kernel_res_ln), the post-LN FFN block of the
// wav2vec2-base encoder layer and the BART blocks.  K9 replaces ffn_fused
// (_kernel) of the same file: the FFN of pre-LN blocks, and the recompute of
// the pre-LayerNorm sum inside K3's backward.  K12 replaces
// ffn_dropout_res_ln_trainable (_kernel_dropout_res_ln) and K13
// ffn_dropout_trainable (_kernel_dropout), the recompute inside K12's
// backward.
//
// Dropout (dropout.cuh): the activation mask (stream 0) multiplies act(a) in
// f32, at (row, f column); the output mask (stream 1) multiplies the f32 sum
// y + b2 before the residual, at (row, h column).  A mask whose threshold is
// 0 (rate 0) draws no bits.
//
// x, res, out: (n, h); w1: (h, f); w2: (f, h), row-major float32; b1: (f,),
// b2, g, beta: (h,) float32; h <= 2048 (the launcher refuses anything else).
// act: 0 gelu (erf), 1 gelu_new (tanh), 2 relu, 3 silu.
//
// What bounds it on the H100: the f32-FMA rate of the CUDA cores (4 n h f
// FLOPs at 67 TFLOP/s).  One block of 256 threads owns BM = 16 rows and all
// h output columns (16 x 4 f32 accumulators per thread, as in K2).  The
// block's x rows sit in shared memory, transposed (h, BM) for float4
// broadcast reads.  The loop over f takes FC = 256 columns at a time: thread
// t computes act(x_rows . w1[:, c0 + t] + b1) for its column and all 16 rows
// and writes it to shared memory; then every thread accumulates that
// (FC, BM) slice times w2[c0 : c0 + FC, its columns].  The (n, f)
// intermediate never reaches device memory.  The epilogue is K2's.  Rows
// past n are masked.  Above h = 1024 the same body holds 8 columns a
// thread (h <= 2048) and BM = 8 rows a block, so that its accumulators stay
// at 64 registers; h <= 1024 runs the body it always ran.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int FC = NT;   // f columns per chunk: one per thread
constexpr int MAX_H = 8 * NT;  // the widest h: 8 columns a thread

// BM rows a block; h <= MAXC * NT
template <int BM, int MAXC, bool LN, bool DROP>
__global__ void __launch_bounds__(NT)
    ffn_res_ln_kernel(const float* __restrict__ x,
                      const float* __restrict__ w1,
                      const float* __restrict__ b1,
                      const float* __restrict__ w2,
                      const float* __restrict__ b2,
                      const float* __restrict__ res,
                      const float* __restrict__ g,
                      const float* __restrict__ beta, float* __restrict__ out,
                      int n, int h, int f, int act, float eps,
                      smx::Dropout act_drop, smx::Dropout out_drop) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;             // (h, BM): xs[k * BM + r]
  float* hs = xs + h * BM;      // (FC, BM): hs[c * BM + r]
  __shared__ float red[(NT / 32) * BM];
  __shared__ float tot[BM];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * BM;

  for (int i = tid; i < h * BM; i += NT) {
    const int r = i / h, k = i % h;  // neighbouring threads: along h
    const int row = r0 + r;
    xs[k * BM + r] = row < n ? x[(long long)row * h + k] : 0.0f;
  }

  float acc[BM][MAXC];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int j = 0; j < MAXC; ++j) acc[r][j] = 0.0f;
  __syncthreads();

  for (int c0 = 0; c0 < f; c0 += FC) {
    // first product: this thread's column of the intermediate, all rows
    const int col = c0 + tid;
    float hv[BM];
#pragma unroll
    for (int r = 0; r < BM; ++r) hv[r] = 0.0f;
    if (col < f) {
      for (int k = 0; k < h; ++k) {
        const float wv = w1[(long long)k * f + col];
        const float4* xr = reinterpret_cast<const float4*>(xs + k * BM);
#pragma unroll
        for (int q = 0; q < BM / 4; ++q) {
          const float4 xv = xr[q];
          hv[4 * q + 0] += xv.x * wv;
          hv[4 * q + 1] += xv.y * wv;
          hv[4 * q + 2] += xv.z * wv;
          hv[4 * q + 3] += xv.w * wv;
        }
      }
      const float bias = b1[col];
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        hv[r] = smx::activate(act, hv[r] + bias);
        if constexpr (DROP) {
          if (act_drop.threshold) hv[r] *= act_drop.at(r0 + r, col);
        }
      }
    }
    float4* hw = reinterpret_cast<float4*>(hs + tid * BM);
#pragma unroll
    for (int q = 0; q < BM / 4; ++q) {
      hw[q] = make_float4(hv[4 * q], hv[4 * q + 1], hv[4 * q + 2], hv[4 * q + 3]);
    }
    __syncthreads();

    // second product: accumulate the chunk into the block's output rows
    const int cend = min(FC, f - c0);
    for (int cc = 0; cc < cend; ++cc) {
      float wv[MAXC];
#pragma unroll
      for (int j = 0; j < MAXC; ++j) {
        const int c = tid + j * NT;
        wv[j] = c < h ? w2[(long long)(c0 + cc) * h + c] : 0.0f;
      }
      const float4* hr = reinterpret_cast<const float4*>(hs + cc * BM);
#pragma unroll
      for (int q = 0; q < BM / 4; ++q) {
        const float4 hv4 = hr[q];
#pragma unroll
        for (int j = 0; j < MAXC; ++j) {
          acc[4 * q + 0][j] += hv4.x * wv[j];
          acc[4 * q + 1][j] += hv4.y * wv[j];
          acc[4 * q + 2][j] += hv4.z * wv[j];
          acc[4 * q + 3][j] += hv4.w * wv[j];
        }
      }
    }
    __syncthreads();
  }
  if constexpr (LN) {
    smx::res_ln_epilogue<float, BM, MAXC, NT, DROP>(
        acc, b2, res, g, beta, out, n, h, r0, eps, red, tot, out_drop);
  } else {
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      const int row = r0 + r;
      if (row >= n) continue;
#pragma unroll
      for (int j = 0; j < MAXC; ++j) {
        const int c = tid + j * NT;
        if (c < h) out[(long long)row * h + c] = acc[r][j] + b2[c];
      }
    }
  }
}

template <int BM, int MAXC, bool LN, bool DROP>
int launch_f32(const void* x, const void* w1, const float* b1, const void* w2,
               const float* b2, const void* res, const float* g,
               const float* beta, void* out, int n, int h, int f, int act,
               float eps, smx::Dropout act_drop, smx::Dropout out_drop,
               cudaStream_t stream) {
  const size_t smem = (size_t)(h + FC) * BM * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_res_ln_kernel<BM, MAXC, LN, DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n + BM - 1) / BM);
  ffn_res_ln_kernel<BM, MAXC, LN, DROP><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1), b1,
      static_cast<const float*>(w2), b2, static_cast<const float*>(res), g,
      beta, static_cast<float*>(out), n, h, f, act, eps, act_drop, out_drop);
  return static_cast<int>(cudaGetLastError());
}

template <bool LN, bool DROP>
int launch(const void* x, const void* w1, const float* b1, const void* w2,
           const float* b2, const void* res, const float* g, const float* beta,
           void* out, int n, int h, int f, int act, float eps,
           smx::Dropout act_drop, smx::Dropout out_drop, int dtype, int device,
           void* stream) {
  if (dtype != smx::kF32 || h > MAX_H || h <= 0 || f <= 0 || n <= 0 ||
      act < 0 || act > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h <= 4 * NT) {
    return launch_f32<16, 4, LN, DROP>(x, w1, b1, w2, b2, res, g, beta, out,
                                       n, h, f, act, eps, act_drop, out_drop,
                                       s);
  }
  return launch_f32<8, 8, LN, DROP>(x, w1, b1, w2, b2, res, g, beta, out, n,
                                    h, f, act, eps, act_drop, out_drop, s);
}

}  // namespace

extern "C" int smx_ffn_res_ln(const void* x, const void* w1, const float* b1,
                              const void* w2, const float* b2, const void* res,
                              const float* g, const float* beta, void* out,
                              int n, int h, int f, int act, float eps,
                              int dtype, int device, void* stream) {
  return launch<true, false>(x, w1, b1, w2, b2, res, g, beta, out, n, h, f,
                             act, eps, smx::Dropout{}, smx::Dropout{}, dtype,
                             device, stream);
}

extern "C" int smx_ffn_fused(const void* x, const void* w1, const float* b1,
                             const void* w2, const float* b2, void* out, int n,
                             int h, int f, int act, int dtype, int device,
                             void* stream) {
  return launch<false, false>(x, w1, b1, w2, b2, nullptr, nullptr, nullptr,
                              out, n, h, f, act, 0.0f, smx::Dropout{},
                              smx::Dropout{}, dtype, device, stream);
}

// K12: k0, k1 the site's key; (threshold, scale) of the activation mask
// (stream 0) and of the output mask (stream 1), from the host.
extern "C" int smx_ffn_dropout_res_ln(
    const void* x, const void* w1, const float* b1, const void* w2,
    const float* b2, const void* res, const float* g, const float* beta,
    void* out, int n, int h, int f, int act, float eps, uint32_t k0,
    uint32_t k1, uint32_t act_threshold, float act_scale,
    uint32_t out_threshold, float out_scale, int dtype, int device,
    void* stream) {
  return launch<true, true>(
      x, w1, b1, w2, b2, res, g, beta, out, n, h, f, act, eps,
      smx::make_dropout(k0, k1, smx::kStreamAct, act_threshold, act_scale),
      smx::make_dropout(k0, k1, smx::kStreamOut, out_threshold, out_scale),
      dtype, device, stream);
}

// K13: the activation mask only.
extern "C" int smx_ffn_dropout(const void* x, const void* w1, const float* b1,
                               const void* w2, const float* b2, void* out,
                               int n, int h, int f, int act, uint32_t k0,
                               uint32_t k1, uint32_t act_threshold,
                               float act_scale, int dtype, int device,
                               void* stream) {
  return launch<false, true>(
      x, w1, b1, w2, b2, nullptr, nullptr, nullptr, out, n, h, f, act, 0.0f,
      smx::make_dropout(k0, k1, smx::kStreamAct, act_threshold, act_scale),
      smx::Dropout{}, dtype, device, stream);
}
