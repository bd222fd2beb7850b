// K3: ffn_res_ln — out = LayerNorm(res + act(x @ w1 + b1) @ w2 + b2) * g + beta
// (entry smx_ffn_res_ln), and K9: ffn_fused — out = act(x @ w1 + b1) @ w2 + b2,
// the same body without the residual + LayerNorm epilogue (entry
// smx_ffn_fused; res, g and beta are not read).  Their dropout twins, the
// same bodies instantiated with DROP: K12 ffn_dropout_res_ln —
// LayerNorm(res + drop_o(drop_a(act(x @ w1 + b1)) @ w2 + b2)) (entry
// smx_ffn_dropout_res_ln), and K13 ffn_dropout — drop_a(act(x @ w1 + b1)) @
// w2 + b2 (entry smx_ffn_dropout).
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
// f32 before its rounding to the storage type, at (row, f column); the
// output mask (stream 1) multiplies the f32 sum y + b2 before the residual,
// at (row, h column).  A mask whose threshold is 0 (rate 0) draws no bits.
//
// x, res, out: (n, h); w1: (h, f); w2: (f, h), row-major, in float32 or
// bfloat16; b1: (f,), b2, g, beta: (h,) float32.  float32: h <= 1024;
// bfloat16: h in {768, 1024}, f % 64 == 0, x, w1 and w2 32-byte aligned (the
// launcher refuses anything else).
// act: 0 gelu (erf), 1 gelu_new (tanh), 2 relu, 3 silu.
//
// What bounds it on the H100: at the flagship shape (n ~ 12800, h = 768,
// f = 3072) the two products are 4*n*h*f ~ 121 GFLOP against ~50 MB of
// traffic, so the tensor cores are the limit (~0.12 ms).  The bf16
// tensor-core kernel below (WMMA) reads its w1 / w2 tiles from L2 without
// staging or pipelining, which keeps it well above that bound (PERF.md).
// Each dtype has one kernel: float32 takes an f32-FMA kernel, bound by the
// CUDA cores.
//
// float32 kernel: one block of 256 threads owns BM = 16 rows and all h
// output columns (16 x 4 f32 accumulators per thread, as in K2).  The
// block's x rows sit in shared memory, transposed (h, BM) for float4
// broadcast reads.  The loop over f takes FC = 256 columns at a time: thread t computes
// act(x_rows . w1[:, c0 + t] + b1) for its column and all 16 rows and
// writes it to shared memory; then every thread accumulates that (FC, BM)
// slice times w2[c0 : c0 + FC, its columns].  The (n, f) intermediate never
// reaches device memory.  The epilogue is K2's.  Rows past n are masked.
//
// bfloat16 kernel, on the tensor cores (instantiated for h = 768, the
// flagship's width, and h = 1024, bart-large's): one block of 8 warps owns
// 32 rows.  Its x rows sit in shared memory as bf16.
// Per 64-column chunk of f, each warp computes one 16x16 tile of
// x . w1[:, chunk] with WMMA (bf16 in, f32 accumulate), the block applies
// b1 and the activation and rounds to bf16 in shared memory (as the TPU
// kernel rounds the intermediate before its second product), and each warp
// accumulates its h / 128 x 2 output tiles of chunk . w2[chunk, :] in f32
// fragments.  w1 and w2 tiles are read straight from global memory (L2).
// The accumulators are staged in shared memory for the residual +
// LayerNorm epilogue (one warp per row).

#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BM = 16;
constexpr int NT = 256;
constexpr int FC = NT;   // f columns per chunk: one per thread
constexpr int MAXC = 4;  // h <= MAXC * NT

template <bool LN, bool DROP>
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

template <bool LN, bool DROP>
int launch_f32(const void* x, const void* w1, const float* b1, const void* w2,
               const float* b2, const void* res, const float* g,
               const float* beta, void* out, int n, int h, int f, int act,
               float eps, smx::Dropout act_drop, smx::Dropout out_drop,
               cudaStream_t stream) {
  const size_t smem = (size_t)(h + FC) * BM * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_res_ln_kernel<LN, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n + BM - 1) / BM);
  ffn_res_ln_kernel<LN, DROP><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1), b1,
      static_cast<const float*>(w2), b2, static_cast<const float*>(res), g,
      beta, static_cast<float*>(out), n, h, f, act, eps, act_drop, out_drop);
  return static_cast<int>(cudaGetLastError());
}


namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int TC_BM = 32;             // rows per block: two 16-row tiles
constexpr int TC_FC = 64;             // f columns per chunk: four tiles
constexpr int TC_NT = 256;            // 8 warps
constexpr int TC_LDHF = TC_FC + 4;    // f32 chunk row (padded)
constexpr int TC_LDHB = TC_FC + 8;    // bf16 chunk row (padded)

template <int NJ>
constexpr size_t tc_smem_bytes() {
  return (size_t)TC_BM * (128 * NJ + 8) * sizeof(bf16) +
         (size_t)TC_BM * TC_LDHF * sizeof(float) +
         (size_t)TC_BM * TC_LDHB * sizeof(bf16) +
         (size_t)TC_BM * (128 * NJ + 4) * sizeof(float);
}

// h = 128 * NJ; warp w owns output column tiles w + 8 * j, j < NJ
template <int NJ, bool LN, bool DROP>
__global__ void __launch_bounds__(TC_NT)
    ffn_res_ln_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                         const float* __restrict__ b1, const bf16* __restrict__ w2,
                         const float* __restrict__ b2, const bf16* __restrict__ res,
                         const float* __restrict__ g,
                         const float* __restrict__ beta, bf16* __restrict__ out,
                         int n, int f, int act, float eps,
                         smx::Dropout act_drop, smx::Dropout out_drop) {
  constexpr int H = 128 * NJ;
  constexpr int LDX = H + 8;   // bf16 x row (padded)
  constexpr int LDY = H + 4;   // f32 staged output row (padded)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);          // (TC_BM, LDX)
  float* hf = reinterpret_cast<float*>(xs + TC_BM * LDX);  // (TC_BM, LDHF)
  bf16* hb = reinterpret_cast<bf16*>(hf + TC_BM * TC_LDHF);  // (TC_BM, LDHB)
  float* ys = reinterpret_cast<float*>(hb + TC_BM * TC_LDHB);  // (TC_BM, LDY)
  const int tid = threadIdx.x, warp = tid >> 5;
  const int r0 = blockIdx.x * TC_BM;

  for (int i = tid; i < TC_BM * (H / 8); i += TC_NT) {
    const int r = i / (H / 8), c = (i % (H / 8)) * 8;
    const int row = r0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < n) v = *reinterpret_cast<const uint4*>(x + (long long)row * H + c);
    *reinterpret_cast<uint4*>(xs + r * LDX + c) = v;
  }
  wm::fragment<wm::accumulator, 16, 16, 16, float> acc[2][NJ];
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int j = 0; j < NJ; ++j) wm::fill_fragment(acc[rt][j], 0.0f);
  __syncthreads();

  const int rt1 = warp >> 2, ct1 = warp & 3;  // this warp's tile of a chunk
  for (int c0 = 0; c0 < f; c0 += TC_FC) {
    wm::fragment<wm::accumulator, 16, 16, 16, float> hacc;
    wm::fill_fragment(hacc, 0.0f);
    for (int k = 0; k < H; k += 16) {
      wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a;
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> b;
      wm::load_matrix_sync(a, xs + rt1 * 16 * LDX + k, LDX);
      wm::load_matrix_sync(b, w1 + (long long)k * f + c0 + ct1 * 16, f);
      wm::mma_sync(hacc, a, b, hacc);
    }
    wm::store_matrix_sync(hf + rt1 * 16 * TC_LDHF + ct1 * 16, hacc, TC_LDHF,
                          wm::mem_row_major);
    __syncthreads();  // also: every warp is done reading hb of the last chunk
    if constexpr (DROP) {
      // one Philox call per four f columns of a row
      for (int i = tid; i < TC_BM * (TC_FC / 4); i += TC_NT) {
        const int r = i / (TC_FC / 4), c = (i % (TC_FC / 4)) * 4;
        const uint4 bits = act_drop.threshold
                               ? act_drop.bits4(r0 + r, (c0 + c) / 4)
                               : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          hb[r * TC_LDHB + c + j] = __float2bfloat16(
              smx::activate(act, hf[r * TC_LDHF + c + j] + b1[c0 + c + j]) *
              act_drop.keep(smx::word(bits, j)));
        }
      }
    } else {
      for (int i = tid; i < TC_BM * TC_FC; i += TC_NT) {
        const int r = i / TC_FC, c = i % TC_FC;
        hb[r * TC_LDHB + c] = __float2bfloat16(
            smx::activate(act, hf[r * TC_LDHF + c] + b1[c0 + c]));
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < TC_FC; ks += 16) {
      wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a0, a1;
      wm::load_matrix_sync(a0, hb + ks, TC_LDHB);
      wm::load_matrix_sync(a1, hb + 16 * TC_LDHB + ks, TC_LDHB);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> b;
        wm::load_matrix_sync(b, w2 + (long long)(c0 + ks) * H + (warp + 8 * j) * 16, H);
        wm::mma_sync(acc[0][j], a0, b, acc[0][j]);
        wm::mma_sync(acc[1][j], a1, b, acc[1][j]);
      }
    }
  }
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      wm::store_matrix_sync(ys + rt * 16 * LDY + (warp + 8 * j) * 16, acc[rt][j],
                            LDY, wm::mem_row_major);
  __syncthreads();
  if constexpr (LN && DROP) {
    if (out_drop.threshold) {
      smx::staged_bias_dropout(ys, LDY, TC_BM, b2, out_drop, n, H, r0);
      __syncthreads();
      smx::staged_res_ln<bf16, false>(ys, LDY, TC_BM, b2, res, g, beta, out, n,
                                      H, r0, eps);
    } else {
      smx::staged_res_ln<bf16>(ys, LDY, TC_BM, b2, res, g, beta, out, n, H, r0,
                               eps);
    }
  } else if constexpr (LN) {
    smx::staged_res_ln<bf16>(ys, LDY, TC_BM, b2, res, g, beta, out, n, H, r0, eps);
  } else {
    for (int i = tid; i < TC_BM * H; i += TC_NT) {
      const int r = i / H, c = i % H;
      if (r0 + r < n) {
        out[(long long)(r0 + r) * H + c] =
            __float2bfloat16(ys[r * LDY + c] + b2[c]);
      }
    }
  }
}

template <int NJ, bool LN, bool DROP>
int launch_tc(const void* x, const void* w1, const float* b1, const void* w2,
              const float* b2, const void* res, const float* g,
              const float* beta, void* out, int n, int f, int act, float eps,
              smx::Dropout act_drop, smx::Dropout out_drop,
              cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<NJ>();
  cudaError_t err = cudaFuncSetAttribute(
      ffn_res_ln_tc_kernel<NJ, LN, DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n + TC_BM - 1) / TC_BM);
  ffn_res_ln_tc_kernel<NJ, LN, DROP><<<grid, TC_NT, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), b1,
      static_cast<const bf16*>(w2), b2, static_cast<const bf16*>(res), g, beta,
      static_cast<bf16*>(out), n, f, act, eps, act_drop, out_drop);
  return static_cast<int>(cudaGetLastError());
}

bool aligned32(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 31u) == 0;
}

template <bool LN, bool DROP>
int launch(const void* x, const void* w1, const float* b1, const void* w2,
           const float* b2, const void* res, const float* g, const float* beta,
           void* out, int n, int h, int f, int act, float eps,
           smx::Dropout act_drop, smx::Dropout out_drop, int dtype, int device,
           void* stream) {
  if (h > MAXC * NT || h <= 0 || f <= 0 || n <= 0 || act < 0 || act > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == smx::kBF16) {
    // WMMA loads x, w1 and w2 tiles as 32-byte words
    if (f % TC_FC != 0 || !aligned32(x) || !aligned32(w1) || !aligned32(w2)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (h == 768) {
      return launch_tc<6, LN, DROP>(x, w1, b1, w2, b2, res, g, beta, out, n, f,
                                    act, eps, act_drop, out_drop, s);
    }
    if (h == 1024) {
      return launch_tc<8, LN, DROP>(x, w1, b1, w2, b2, res, g, beta, out, n, f,
                                    act, eps, act_drop, out_drop, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_f32<LN, DROP>(x, w1, b1, w2, b2, res, g, beta, out, n, h, f,
                              act, eps, act_drop, out_drop, s);
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
