// K2: dense_res_ln — out = LayerNorm(res + x @ w + b) * g + beta (entry
// smx_dense_res_ln), and K11: dense_dropout_res_ln — out = LayerNorm(res +
// drop(x @ w + b)) * g + beta, the same body with the output mask (entry
// smx_dense_dropout_res_ln; the mask of dropout.cuh, stream 1, at (row, h
// column), multiplies the f32 sum x @ w + b before the residual).
//
// K2 replaces the TPU kernel speechmix_tpu/ops/pallas/ffn_kernel.py:
// dense_res_ln (_kernel_dense_res_ln), the post-LN attention epilogue of the
// wav2vec2-base encoder layer and the BART blocks; K11 replaces
// dense_dropout_res_ln_trainable (_kernel_dense_dropout_res_ln) of the same
// file, that epilogue with the out-projection's dropout.
//
// x: (n, din), w: (din, h) row-major, res/out: (n, h) in float32 or
// bfloat16; b, g, beta: (h,) float32.  float32: h <= 1024; bfloat16:
// h in {768, 1024}, din % 16 == 0, din <= 1024, x and w 32-byte aligned
// (the launcher refuses anything else).
//
// What bounds it on the H100: at the flagship shape (n = B*T ~ 12800,
// din = h = 768) the product is 2*n*din*h ~ 15 GFLOP against ~60 MB of
// traffic, so the tensor cores (bound ~0.015 ms) and not memory are the
// limit.  The bf16 tensor-core kernel below (WMMA) reads its w tiles from
// L2 without staging, which keeps it well above that bound (PERF.md).  Each
// dtype has one kernel: float32 takes an f32-FMA kernel, bound by the CUDA
// cores.
//
// float32 kernel: one block of 256 threads owns BM = 16 rows and all h
// columns (thread t holds columns t, t+256, ... of every row: 16 x 4 f32
// accumulators in registers).  The loop over din stages a (KC, BM) slice of
// x in shared memory, transposed so each thread reads four rows in one
// float4 broadcast, and streams w straight from global memory with
// neighbouring threads on neighbouring columns.  The epilogue adds b and res,
// takes mean and variance per row with warp shuffles and a shared-memory
// reduction, and stores each output element once.  The pre-LN sum never
// reaches device memory.  Rows past n are masked; no padding is needed.
//
// bfloat16 kernel, on the tensor cores (instantiated for h = 768, the
// flagship's width, and h = 1024, bart-large's): one block of 8 warps owns
// 32 rows, whose x rows sit in shared memory as bf16; warp w accumulates
// output tiles w + 8j of both 16-row tiles with WMMA (bf16 in, f32
// accumulate), reading w tiles straight from global memory (L2).  The
// accumulators are staged in shared memory for the residual +
// LayerNorm epilogue (one warp per row).

#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BM = 16;
constexpr int NT = 256;
constexpr int KC = 32;
constexpr int MAXC = 4;  // h <= MAXC * NT

template <bool DROP>
__global__ void __launch_bounds__(NT)
    dense_res_ln_kernel(const float* __restrict__ x,
                        const float* __restrict__ w,
                        const float* __restrict__ b,
                        const float* __restrict__ res,
                        const float* __restrict__ g,
                        const float* __restrict__ beta, float* __restrict__ out,
                        int n, int din, int h, float eps, smx::Dropout drop) {
  __shared__ __align__(16) float xs[KC * BM];  // xs[k * BM + r]
  __shared__ float red[(NT / 32) * BM];
  __shared__ float tot[BM];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * BM;

  float acc[BM][MAXC];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int j = 0; j < MAXC; ++j) acc[r][j] = 0.0f;

  for (int k0 = 0; k0 < din; k0 += KC) {
    for (int i = tid; i < KC * BM; i += NT) {
      const int r = i / KC, kk = i % KC;  // neighbouring threads: along din
      const int row = r0 + r, k = k0 + kk;
      xs[kk * BM + r] =
          (row < n && k < din) ? x[(long long)row * din + k] : 0.0f;
    }
    __syncthreads();
    const int kend = min(KC, din - k0);
    for (int kk = 0; kk < kend; ++kk) {
      float wv[MAXC];
#pragma unroll
      for (int j = 0; j < MAXC; ++j) {
        const int c = tid + j * NT;
        wv[j] = c < h ? w[(long long)(k0 + kk) * h + c] : 0.0f;
      }
      const float4* xr = reinterpret_cast<const float4*>(xs + kk * BM);
#pragma unroll
      for (int q = 0; q < BM / 4; ++q) {
        const float4 xv = xr[q];
#pragma unroll
        for (int j = 0; j < MAXC; ++j) {
          acc[4 * q + 0][j] += xv.x * wv[j];
          acc[4 * q + 1][j] += xv.y * wv[j];
          acc[4 * q + 2][j] += xv.z * wv[j];
          acc[4 * q + 3][j] += xv.w * wv[j];
        }
      }
    }
    __syncthreads();
  }
  smx::res_ln_epilogue<float, BM, MAXC, NT, DROP>(acc, b, res, g, beta, out, n,
                                                  h, r0, eps, red, tot, drop);
}

template <bool DROP>
int launch_f32(const void* x, const void* w, const float* b, const void* res,
               const float* g, const float* beta, void* out, int n, int din,
               int h, float eps, smx::Dropout drop, cudaStream_t stream) {
  dim3 grid((n + BM - 1) / BM);
  dense_res_ln_kernel<DROP><<<grid, NT, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), b,
      static_cast<const float*>(res), g, beta, static_cast<float*>(out), n,
      din, h, eps, drop);
  return static_cast<int>(cudaGetLastError());
}


namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int TC_BM = 32;   // rows per block: two 16-row tiles
constexpr int TC_NT = 256;  // 8 warps

template <int NJ>
size_t tc_smem_bytes(int din) {
  return (size_t)TC_BM * (din + 8) * sizeof(bf16) +
         (size_t)TC_BM * (128 * NJ + 4) * sizeof(float);
}

// h = 128 * NJ; warp w owns output column tiles w + 8 * j, j < NJ
template <int NJ, bool DROP>
__global__ void __launch_bounds__(TC_NT)
    dense_res_ln_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                           const float* __restrict__ b, const bf16* __restrict__ res,
                           const float* __restrict__ g,
                           const float* __restrict__ beta, bf16* __restrict__ out,
                           int n, int din, float eps, smx::Dropout drop) {
  constexpr int H = 128 * NJ;
  constexpr int LDY = H + 4;
  const int ldx = din + 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);           // (TC_BM, ldx)
  float* ys = reinterpret_cast<float*>(xs + TC_BM * ldx);  // (TC_BM, LDY)
  const int tid = threadIdx.x, warp = tid >> 5;
  const int r0 = blockIdx.x * TC_BM;

  const int c8 = din / 8;
  for (int i = tid; i < TC_BM * c8; i += TC_NT) {
    const int r = i / c8, c = (i % c8) * 8;
    const int row = r0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < n) v = *reinterpret_cast<const uint4*>(x + (long long)row * din + c);
    *reinterpret_cast<uint4*>(xs + r * ldx + c) = v;
  }
  wm::fragment<wm::accumulator, 16, 16, 16, float> acc[2][NJ];
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int j = 0; j < NJ; ++j) wm::fill_fragment(acc[rt][j], 0.0f);
  __syncthreads();

  for (int k = 0; k < din; k += 16) {
    wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a0, a1;
    wm::load_matrix_sync(a0, xs + k, ldx);
    wm::load_matrix_sync(a1, xs + 16 * ldx + k, ldx);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> bf;
      wm::load_matrix_sync(bf, w + (long long)k * H + (warp + 8 * j) * 16, H);
      wm::mma_sync(acc[0][j], a0, bf, acc[0][j]);
      wm::mma_sync(acc[1][j], a1, bf, acc[1][j]);
    }
  }
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      wm::store_matrix_sync(ys + rt * 16 * LDY + (warp + 8 * j) * 16, acc[rt][j],
                            LDY, wm::mem_row_major);
  __syncthreads();
  if constexpr (DROP) {
    smx::staged_bias_dropout(ys, LDY, TC_BM, b, drop, n, H, r0);
    __syncthreads();
    smx::staged_res_ln<bf16, false>(ys, LDY, TC_BM, b, res, g, beta, out, n, H,
                                    r0, eps);
  } else {
    smx::staged_res_ln<bf16>(ys, LDY, TC_BM, b, res, g, beta, out, n, H, r0, eps);
  }
}

template <int NJ, bool DROP>
int launch_tc(const void* x, const void* w, const float* b, const void* res,
              const float* g, const float* beta, void* out, int n, int din,
              float eps, smx::Dropout drop, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<NJ>(din);
  cudaError_t err = cudaFuncSetAttribute(
      dense_res_ln_tc_kernel<NJ, DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n + TC_BM - 1) / TC_BM);
  dense_res_ln_tc_kernel<NJ, DROP><<<grid, TC_NT, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), b,
      static_cast<const bf16*>(res), g, beta, static_cast<bf16*>(out), n, din,
      eps, drop);
  return static_cast<int>(cudaGetLastError());
}

bool aligned32(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 31u) == 0;
}

template <bool DROP>
int launch(const void* x, const void* w, const float* b, const void* res,
           const float* g, const float* beta, void* out, int n, int din, int h,
           float eps, smx::Dropout drop, int dtype, int device, void* stream) {
  if (h > MAXC * NT || h <= 0 || din <= 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == smx::kBF16) {
    // x rows staged as bf16 must fit shared memory beside the output rows;
    // WMMA loads x and w tiles as 32-byte words
    if (din % 16 != 0 || din > 1024 || !aligned32(x) || !aligned32(w)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (h == 768) {
      return launch_tc<6, DROP>(x, w, b, res, g, beta, out, n, din, eps, drop, s);
    }
    if (h == 1024) {
      return launch_tc<8, DROP>(x, w, b, res, g, beta, out, n, din, eps, drop, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_f32<DROP>(x, w, b, res, g, beta, out, n, din, h, eps, drop, s);
}

}  // namespace

extern "C" int smx_dense_res_ln(const void* x, const void* w, const float* b,
                                const void* res, const float* g,
                                const float* beta, void* out, int n, int din,
                                int h, float eps, int dtype, int device,
                                void* stream) {
  return launch<false>(x, w, b, res, g, beta, out, n, din, h, eps,
                       smx::Dropout{}, dtype, device, stream);
}

// K11: k0, k1 the site's key; threshold and scale of the output mask
// (stream 1), from the host.
extern "C" int smx_dense_dropout_res_ln(const void* x, const void* w,
                                        const float* b, const void* res,
                                        const float* g, const float* beta,
                                        void* out, int n, int din, int h,
                                        float eps, uint32_t k0, uint32_t k1,
                                        uint32_t threshold, float scale,
                                        int dtype, int device, void* stream) {
  return launch<true>(x, w, b, res, g, beta, out, n, din, h, eps,
                      smx::make_dropout(k0, k1, smx::kStreamOut, threshold,
                                        scale),
                      dtype, device, stream);
}
