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
// + 1.  c <= 1024 (the launcher refuses anything else).  bfloat16 at
// c = 512 (every wav2vec2 extractor) takes the tensor-core kernel below, x
// and w 16-byte aligned (TMA); bfloat16 at any other c takes the float32
// kernel's body with bf16 loads and stores (f32 products and statistics,
// one rounding of the output), as does `tiny-speech`'s c = 32.
//
// The conv is a sum of GEMMs over the taps: output row t of batch row bi
// is sum_j x[bi, 2 t + j, :] . w_j, w_j rows j c .. j c + c - 1 of w, the
// TPU kernel's "slice" decomposition.  Tap j's A operand is a strided view
// of x, not a copy.  The kernels write exactly t_out rows per batch row;
// the TPU kernel's padded physical shapes, halo operand and clamped
// trailing blocks answer that chip's block rules and are not carried over.
//
// What bounds it on the H100: operations.  The flagship's first fused layer
// (16 x 25599 rows, depth 1536, 512 columns) is 644 GFLOP against 1.3 GB of
// traffic: 0.65 ms of tensor-core time, 0.38 ms of memory time.  Beside the
// products, each 128 x 128 tile of the output reads 128 x 64 of x and
// 64 x 128 of w per 64-deep step from L2 (64 operations per byte), and
// takes one erf per element in its epilogue.
//
// bfloat16 kernel, TMA + wgmma on Hopper, the structure of ffn_fwd.cu's up
// pass: a block owns 128 rows of one batch row (rows past t_out load as
// zeros and are not stored) and 128 of the 512 columns; a producer warp
// streams, per 64-deep step, x's (128, 64) box of tap j (a 3-D tensor map
// per tap over (b, t_out, c) at x + j c, rows 2 c apart, batches t_in c
// apart: t_in is odd at every layer, so no 2-D map over all rows could
// work) and w's (64, 128) slice, read MN-major through the descriptor,
// through a ring of 3 stages; two consumer warpgroups run wgmma m64n128k16
// over k * 8 steps into 64 f32 registers each.  Two blocks share an SM, so
// one block's epilogue overlaps the other's products.  The epilogue works
// in the accumulator layout: bias, then without LayerNorm the GELU, rounded
// to bf16 and stored by row.  With LayerNorm the 4 blocks of a row tile form
// a thread-block cluster: each pushes its rows' 128-column sums into every
// block's shared memory (st.shared::cluster); after a cluster barrier each
// block adds the 4 slice sums in slice order for the mean, and a second
// exchange of the centred squares gives the variance (dense_res_ln.cu's
// reduction).  Nothing is atomic: two calls give the same bits.  float32
// takes an f32-FMA kernel of the same shape as dense_res_ln's.

#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

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

// T: the type of x, w and out (float32, or bfloat16 at c != 512)
template <typename T>
__global__ void __launch_bounds__(NT)
    conv_f32_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ bias, const float* __restrict__ g,
                    const float* __restrict__ beta, T* __restrict__ out,
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
      xs[kk * BM + r] =
          (off[r] >= 0 && k < kc) ? smx::to_f32(x[off[r] + k]) : 0.0f;
    }
    __syncthreads();
    const int kend = min(KC, kc - k0);
    for (int kk = 0; kk < kend; ++kk) {
      float wv[MAXC];
#pragma unroll
      for (int j = 0; j < MAXC; ++j) {
        const int col = tid + j * NT;
        wv[j] = col < c ? smx::to_f32(w[(long long)(k0 + kk) * c + col]) : 0.0f;
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
        out[(long long)row * c + col] =
            smx::from_f32<T>(smx::activate(smx::kGelu, acc[r][j]));
    }
  }
}

// ------------------------------------------------------------------ bfloat16
namespace hw = smx::hopper;
using bf16 = __nv_bfloat16;
using hw::BK;
using hw::BOX;
using hw::CONSUMERS;
using hw::HALF;
using hw::MN_LBO;
using hw::SBO;
using hw::TILE;
using hw::WG_THREADS;

constexpr int C = 512;                    // the bf16 kernel's width
constexpr int COL_BLOCKS = C / TILE;      // a row tile's blocks (a cluster)
constexpr int CSTEPS = C / BK;            // 64-deep steps of one tap
constexpr int MAX_TAPS = 3;
constexpr int STAGES = 3;                 // of 2 boxes (32 KB)
constexpr int TC_THREADS = CONSUMERS + 32;  // + a producer warp
// the ring, its barriers, and the rows' slice sums that the cluster's
// blocks push: [2 (sum, centred squares)][COL_BLOCKS][TILE] floats
constexpr size_t TC_SMEM = 1024 + (size_t)STAGES * 2 * BOX +
                           2 * STAGES * sizeof(uint64_t) +
                           2 * COL_BLOCKS * TILE * sizeof(float);

struct ConvArgs {
  // tap j: x's (b, t_out, c) view at x + j c, rows 2 c apart, in (128, 64)
  // boxes (K-major A)
  CUtensorMap a[MAX_TAPS];
  CUtensorMap w;          // (k c, c) in (64, 64) boxes: MN-major B
  const float* bias;      // (c,)
  const float* g;         // (c,), with LayerNorm
  const float* beta;      // (c,), with LayerNorm
  bf16* out;              // (b, t_out, c)
  int t_out, row_tiles;   // row tiles per batch row
  int taps;
  float eps;
};

// the sum over the four lanes of a quad (one row of the accumulator layout),
// the same bits on all four
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One row statistic over the cluster: this block's row sums v[i] (rows
// lrow + 8 i, its 128-column slice) to slice `rank` of `part` in every
// block; after the barrier, the 4 slices' sums in slice order.
__device__ __forceinline__ void cluster_row_sums(float* part, int rank,
                                                 int lrow, int lane,
                                                 float (&v)[2]) {
  v[0] = quad_sum(v[0]);
  v[1] = quad_sum(v[1]);
  if (lane % 4 == 0) {
    for (int r = 0; r < COL_BLOCKS; ++r) {
      hw::st_cluster(part + rank * TILE + lrow, r, v[0]);
      hw::st_cluster(part + rank * TILE + lrow + 8, r, v[1]);
    }
  }
  hw::cluster_sync();
  v[0] = 0.0f;
  v[1] = 0.0f;
  for (int r = 0; r < COL_BLOCKS; ++r) {
    v[0] += part[r * TILE + lrow];
    v[1] += part[r * TILE + lrow + 8];
  }
}

// block x: row tile x / 4 (batch row, then 128-row tile within it) and
// columns 128 (x % 4) ..; with LN the 4 blocks of a row tile are a cluster
template <bool LN>
__global__ void __launch_bounds__(TC_THREADS, 2)
    conv_tc_kernel(const __grid_constant__ ConvArgs p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* as = hw::align1024(smem_raw);  // STAGES x BOX
  uint8_t* bs = as + STAGES * BOX;        // STAGES x BOX
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + STAGES * BOX);
  uint64_t* empty = full + STAGES;
  float* psum = reinterpret_cast<float*>(empty + STAGES);
  float* psq = psum + COL_BLOCKS * TILE;

  const int rank = blockIdx.x % COL_BLOCKS, tile = blockIdx.x / COL_BLOCKS;
  const int bi = tile / p.row_tiles, t0 = tile % p.row_tiles * TILE;
  const int n0 = rank * TILE;
  const int ksteps = p.taps * CSTEPS;
  const int wg = threadIdx.x / WG_THREADS;
  hw::init_ring<STAGES>(full, empty);
  // every block of the cluster has started before any writes to another's
  // shared memory (the wait comes before the first such write)
  if constexpr (LN) hw::cluster_arrive();

  if (wg == 2) {  // producer warp; its first thread issues the loads
    if (threadIdx.x == CONSUMERS) {
      hw::Ring<STAGES> ring;
      for (int kb = 0; kb < ksteps; ++kb) {
        const int s = ring.s;
        ring.acquire(full, empty, 2 * BOX);
        hw::tma_load3(as + s * BOX, &p.a[kb / CSTEPS], &full[s],
                      kb % CSTEPS * BK, t0, bi);
        hw::tma_load(bs + s * BOX, &p.w, &full[s], n0, kb * BK);
        hw::tma_load(bs + s * BOX + HALF, &p.w, &full[s], n0 + 64, kb * BK);
        ring.advance();
      }
    }
    if constexpr (LN) {  // the consumers' cluster barriers
      __syncwarp();
      hw::cluster_wait();
      hw::cluster_sync();
      hw::cluster_sync();
    }
    return;
  }
  // consumers: rows t0 + 64 wg .. + 63
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  hw::fence_regs(acc);
  hw::consume<STAGES>(full, empty, ksteps, [&](int s) {
    const uint8_t* a = as + s * BOX + wg * HALF;
    const uint8_t* b = bs + s * BOX;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      hw::wgmma_m64n128k16<0, 1>(acc, hw::desc_sw128(a + kk * 32, 16, SBO),
                                 hw::desc_sw128(b + kk * 2048, MN_LBO, SBO));
    }
  });
  hw::fence_regs(acc);

  // this thread: rows lrow, lrow + 8 of the tile, columns n0 + 8 j +
  // 2 (lane % 4) + {0, 1}
  const int lane = threadIdx.x % 32;
  const int lrow = wg * 64 + (threadIdx.x % WG_THREADS) / 32 * 16 + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 bias = *reinterpret_cast<const float2*>(p.bias + col0 + 8 * j);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      acc[4 * j + 2 * i] += bias.x;
      acc[4 * j + 2 * i + 1] += bias.y;
      sum[i] += acc[4 * j + 2 * i] + acc[4 * j + 2 * i + 1];
    }
  }
  if constexpr (LN) {
    const float inv_c = 1.0f / (float)C;
    hw::cluster_wait();  // every block of the cluster has started
    cluster_row_sums(psum, rank, lrow, lane, sum);
    const float mean[2] = {sum[0] * inv_c, sum[1] * inv_c};
    float sq[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& v = acc[4 * j + 2 * i + c];
          v -= mean[i];
          sq[i] += v * v;
        }
    // after its barrier no block touches another's shared memory
    cluster_row_sums(psq, rank, lrow, lane, sq);
    const float inv[2] = {rsqrtf(sq[0] * inv_c + p.eps),
                          rsqrtf(sq[1] * inv_c + p.eps)};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 g = *reinterpret_cast<const float2*>(p.g + col0 + 8 * j);
      const float2 bb =
          *reinterpret_cast<const float2*>(p.beta + col0 + 8 * j);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[4 * j + 2 * i] = acc[4 * j + 2 * i] * inv[i] * g.x + bb.x;
        acc[4 * j + 2 * i + 1] = acc[4 * j + 2 * i + 1] * inv[i] * g.y + bb.y;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + lrow + 8 * i;
    if (t >= p.t_out) continue;
    bf16* o = p.out + ((long long)bi * p.t_out + t) * C + col0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) = __floats2bfloat162_rn(
          smx::activate(smx::kGelu, acc[4 * j + 2 * i]),
          smx::activate(smx::kGelu, acc[4 * j + 2 * i + 1]));
    }
  }
}

int launch_tc(const void* x, const void* w, const float* bias, const float* g,
              const float* beta, void* out, int b, int t_in, int t_out, int k,
              int ln, float eps, cudaStream_t stream) {
  ConvArgs p;
  const bf16* xb = static_cast<const bf16*>(x);
  for (int j = 0; j < k; ++j) {
    if (!hw::make_map3_strided(&p.a[j], xb + j * C, b, t_out, C, 2 * C,
                               (uint64_t)t_in * C, TILE, BK)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (!hw::make_map(&p.w, w, (uint64_t)k * C, C, BK, BK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.bias = bias;
  p.g = g;
  p.beta = beta;
  p.out = static_cast<bf16*>(out);
  p.t_out = t_out;
  p.row_tiles = (t_out + TILE - 1) / TILE;
  p.taps = k;
  p.eps = eps;
  const long long blocks = (long long)b * p.row_tiles * COL_BLOCKS;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel =
      ln ? reinterpret_cast<const void*>(conv_tc_kernel<true>)
         : reinterpret_cast<const void*>(conv_tc_kernel<false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(TC_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = COL_BLOCKS;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks), 1, 1);
  cfg.blockDim = dim3(TC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = TC_SMEM;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = ln ? 1 : 0;  // the cluster only where rows are reduced
  void* args[] = {&p};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return static_cast<int>(err);
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
  dim3 grid((n + BM - 1) / BM);
  if (dtype == smx::kBF16 && c != C) {
    conv_f32_kernel<bf16><<<grid, NT, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), bias, g,
        beta, static_cast<bf16*>(out), n, t_in, t_out, c, k * c, ln, eps);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == smx::kBF16) {
    if (!aligned(x, 16) || !aligned(w, 16) || !aligned(bias, 8) ||
        !aligned(out, 4) || (ln && (!aligned(g, 8) || !aligned(beta, 8)))) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    return launch_tc(x, w, bias, g, beta, out, b, t_in, t_out, k, ln, eps, s);
  }
  conv_f32_kernel<float><<<grid, NT, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), bias, g, beta,
      static_cast<float*>(out), n, t_in, t_out, c, k * c, ln, eps);
  return static_cast<int>(cudaGetLastError());
}
