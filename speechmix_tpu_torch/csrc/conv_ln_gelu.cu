// K6: conv_ln_gelu — one wav2vec2 feature-extractor layer in one pass:
// out = GELU([LayerNorm](conv1d(x, stride 2, VALID) + bias)), exact-erf GELU.
//
// Replaces the TPU kernel speechmix_tpu/ops/pallas/conv_extractor.py:
// fused_conv_layer (_kernel), chained by fused_conv_stack over the stride-2
// layers 1.. of every wav2vec2 preset.
//
// x: (b, t_in, c) contiguous, float32 or bfloat16; w: (k * c, c) row-major,
// row j * c + ci = tap j, input channel ci; k in {2, 3}; bias, g, beta: (c,)
// float32 (g, beta only with ln); out: (b, t_out, c), t_out = (t_in - k) / 2
// + 1.  float32: c <= 1024; bfloat16: c = 512, x 16-byte and w 32-byte
// aligned (the launcher refuses anything else).
//
// The conv is one GEMM whose A operand needs no unfold: output row t of a
// batch row reads the k * c contiguous elements that start at input row 2t,
// so A is the input itself with a row stride of 2c and depth k * c.  It
// writes exactly t_out rows per batch row; the TPU kernel's padded physical
// shapes, halo operand and clamped trailing blocks answer that chip's block
// rules and are not carried over.
//
// What bounds it on the H100: operations.  The flagship's first fused layer
// (16 x 25599 rows, depth 1536, 512 columns) is 644 GFLOP against 1.3 GB of
// traffic: 0.65 ms of tensor-core time, 0.38 ms of memory time.  The bf16
// kernel (WMMA, bf16 in, f32 accumulate) gives one block of 16 warps 64
// output rows, whose input rows sit in shared memory; warp w accumulates
// column tiles w and w + 16 of all four 16-row tiles, reading the weight
// tiles straight from global memory (L2): each weight tile loaded feeds four
// products.  That is far from a pipelined wgmma kernel (PERF.md has the
// times).  The accumulators are then staged in shared memory, over the input
// rows, and one warp per row adds the bias, takes the LayerNorm statistics in
// f32 from registers, applies the GELU and writes the row once.  float32 takes
// an f32-FMA kernel of the same shape as dense_res_ln's.

#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BM = 16;
constexpr int NT = 256;
constexpr int KC = 32;
constexpr int MAXC = 4;  // c <= MAXC * NT

// element offset of the first input element of output row `row`, or -1
__device__ __forceinline__ long long a_offset(int row, int n, int t_in,
                                              int t_out, int c) {
  if (row >= n) return -1;
  const int bi = row / t_out, t = row % t_out;
  return ((long long)bi * t_in + 2 * t) * c;
}

__global__ void __launch_bounds__(NT)
    conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, const float* __restrict__ g,
                    const float* __restrict__ beta, float* __restrict__ out,
                    int n, int t_in, int t_out, int c, int kc, int ln,
                    float eps) {
  __shared__ __align__(16) float xs[KC * BM];  // xs[k * BM + r]
  __shared__ float red[(NT / 32) * BM];
  __shared__ float tot[BM];
  __shared__ long long off[BM];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * BM;
  if (tid < BM) off[tid] = a_offset(r0 + tid, n, t_in, t_out, c);
  __syncthreads();

  float acc[BM][MAXC];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int j = 0; j < MAXC; ++j) acc[r][j] = 0.0f;

  for (int k0 = 0; k0 < kc; k0 += KC) {
    for (int i = tid; i < KC * BM; i += NT) {
      const int r = i / KC, kk = i % KC;
      const int k = k0 + kk;
      xs[kk * BM + r] = (off[r] >= 0 && k < kc) ? x[off[r] + k] : 0.0f;
    }
    __syncthreads();
    const int kend = min(KC, kc - k0);
    for (int kk = 0; kk < kend; ++kk) {
      float wv[MAXC];
#pragma unroll
      for (int j = 0; j < MAXC; ++j) {
        const int col = tid + j * NT;
        wv[j] = col < c ? w[(long long)(k0 + kk) * c + col] : 0.0f;
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

#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {
      const int col = tid + j * NT;
      acc[r][j] = (col < c && r0 + r < n) ? acc[r][j] + bias[col] : 0.0f;
    }
  if (ln) {
    const float inv_c = 1.0f / (float)c;
    float mean[BM];
    smx::block_row_sums<BM, MAXC, NT, false>(acc, mean, red, tot);
#pragma unroll
    for (int r = 0; r < BM; ++r)
#pragma unroll
      for (int j = 0; j < MAXC; ++j)
        acc[r][j] = tid + j * NT < c ? acc[r][j] - mean[r] * inv_c : 0.0f;
    float var[BM];
    smx::block_row_sums<BM, MAXC, NT, true>(acc, var, red, tot);
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      const float inv = rsqrtf(var[r] * inv_c + eps);
#pragma unroll
      for (int j = 0; j < MAXC; ++j) {
        const int col = tid + j * NT;
        if (col < c) acc[r][j] = acc[r][j] * inv * g[col] + beta[col];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    const int row = r0 + r;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {
      const int col = tid + j * NT;
      if (col < c)
        out[(long long)row * c + col] = smx::activate(smx::kGelu, acc[r][j]);
    }
  }
}


namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int TC_BM = 64;   // rows per block: four 16-row tiles
constexpr int TC_RT = TC_BM / 16;
constexpr int TC_NW = 16;   // warps
constexpr int TC_NT = TC_NW * 32;
constexpr size_t kMaxSmem = 232448;  // shared memory a block can use

template <int C>
size_t tc_smem_bytes(int kc) {
  const size_t xs = (size_t)TC_BM * (kc + 8) * sizeof(bf16);
  const size_t ys = (size_t)TC_BM * (C + 4) * sizeof(float);
  return xs > ys ? xs : ys;
}

template <int C>
__global__ void __launch_bounds__(TC_NT, 1)
    conv_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const float* __restrict__ bias, const float* __restrict__ g,
                   const float* __restrict__ beta, bf16* __restrict__ out,
                   int n, int t_in, int t_out, int kc, int ln, float eps) {
  constexpr int NJ = C / 16 / TC_NW;  // column tiles per warp
  constexpr int LDY = C + 4;
  static_assert(C % (16 * TC_NW) == 0 && C % 64 == 0, "unsupported width");
  const int ldx = kc + 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);    // (TC_BM, ldx)
  float* ys = reinterpret_cast<float*>(smem_raw);  // (TC_BM, LDY), afterwards
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * TC_BM;

  const int c8 = kc / 8;
  for (int i = tid; i < TC_BM * c8; i += TC_NT) {
    const int r = i / c8, col = (i % c8) * 8;
    const long long off = a_offset(r0 + r, n, t_in, t_out, C);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (off >= 0) val = *reinterpret_cast<const uint4*>(x + off + col);
    *reinterpret_cast<uint4*>(xs + r * ldx + col) = val;
  }
  wm::fragment<wm::accumulator, 16, 16, 16, float> acc[TC_RT][NJ];
#pragma unroll
  for (int rt = 0; rt < TC_RT; ++rt)
#pragma unroll
    for (int j = 0; j < NJ; ++j) wm::fill_fragment(acc[rt][j], 0.0f);
  __syncthreads();

  for (int k = 0; k < kc; k += 16) {
    wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a[TC_RT];
#pragma unroll
    for (int rt = 0; rt < TC_RT; ++rt)
      wm::load_matrix_sync(a[rt], xs + rt * 16 * ldx + k, ldx);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> bfrag;
      wm::load_matrix_sync(bfrag, w + (long long)k * C + (warp + TC_NW * j) * 16,
                           C);
#pragma unroll
      for (int rt = 0; rt < TC_RT; ++rt)
        wm::mma_sync(acc[rt][j], a[rt], bfrag, acc[rt][j]);
    }
  }
  __syncthreads();  // every warp is done with xs: ys takes its place
#pragma unroll
  for (int rt = 0; rt < TC_RT; ++rt)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      wm::store_matrix_sync(ys + rt * 16 * LDY + (warp + TC_NW * j) * 16,
                            acc[rt][j], LDY, wm::mem_row_major);
  __syncthreads();

  // one warp per row; lane owns columns 2 * lane + 64 * i and the next one
  constexpr int NP = C / 64;
  const float inv_c = 1.0f / (float)C;
  for (int r = warp; r < TC_BM; r += TC_NW) {
    const int row = r0 + r;
    if (row >= n) continue;
    float2 val[NP];
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int col = 2 * lane + 64 * i;
      val[i] = *reinterpret_cast<const float2*>(ys + r * LDY + col);
      val[i].x += bias[col];
      val[i].y += bias[col + 1];
      s += val[i].x + val[i].y;
    }
    if (ln) {
      const float mean = smx::warp_sum(s) * inv_c;
      float sq = 0.0f;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        val[i].x -= mean;
        val[i].y -= mean;
        sq += val[i].x * val[i].x + val[i].y * val[i].y;
      }
      const float inv = rsqrtf(smx::warp_sum(sq) * inv_c + eps);
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int col = 2 * lane + 64 * i;
        val[i].x = val[i].x * inv * g[col] + beta[col];
        val[i].y = val[i].y * inv * g[col + 1] + beta[col + 1];
      }
    }
    bf16* o = out + (long long)row * C;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int col = 2 * lane + 64 * i;
      *reinterpret_cast<__nv_bfloat162*>(o + col) = __floats2bfloat162_rn(
          smx::activate(smx::kGelu, val[i].x),
          smx::activate(smx::kGelu, val[i].y));
    }
  }
}

template <int C>
int launch_tc(const void* x, const void* w, const float* bias, const float* g,
              const float* beta, void* out, int n, int t_in, int t_out, int kc,
              int ln, float eps, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<C>(kc);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      conv_tc_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n + TC_BM - 1) / TC_BM);
  conv_tc_kernel<C><<<grid, TC_NT, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), bias, g, beta,
      static_cast<bf16*>(out), n, t_in, t_out, kc, ln, eps);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, unsigned nbytes) {
  return (reinterpret_cast<uintptr_t>(p) & (nbytes - 1u)) == 0;
}

}  // namespace

extern "C" int smx_conv_ln_gelu(const void* x, const void* w, const float* bias,
                                const float* g, const float* beta, void* out,
                                int b, int t_in, int c, int k, int ln,
                                float eps, int dtype, int device,
                                void* stream) {
  if (b <= 0 || c <= 0 || c > MAXC * NT || (k != 2 && k != 3) || t_in < k ||
      (ln && (g == nullptr || beta == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int t_out = (t_in - k) / 2 + 1;
  const long long rows = (long long)b * t_out;
  if (rows > 2147483647LL - 64) return static_cast<int>(cudaErrorInvalidValue);
  const int n = static_cast<int>(rows);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == smx::kBF16) {
    if (c != 512) return static_cast<int>(cudaErrorInvalidValue);
    if (!aligned(x, 16) || !aligned(w, 32) || !aligned(out, 4)) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    return launch_tc<512>(x, w, bias, g, beta, out, n, t_in, t_out, k * c, ln,
                          eps, s);
  }
  dim3 grid((n + BM - 1) / BM);
  conv_f32_kernel<<<grid, NT, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), bias, g, beta,
      static_cast<float*>(out), n, t_in, t_out, c, k * c, ln, eps);
  return static_cast<int>(cudaGetLastError());
}
