// K6: conv_ln_gelu — one wav2vec2 feature-extractor layer in one pass:
// out = GELU([LayerNorm](conv1d(x, stride 2, VALID) + bias)), exact-erf GELU.
//
// Replaces the TPU kernel speechmix_tpu/ops/pallas/conv_extractor.py:
// fused_conv_layer (_kernel), chained by fused_conv_stack over the stride-2
// layers 1.. of every wav2vec2 preset.
//
// x: (b, t_in, c_in) contiguous, float32 or bfloat16, its channels c (the
// layer's) then zeros up to c_in (c_in % 8 == 0: the wrapper pads x where c
// is not); wt: (k, cpo, kp) row-major, wt[j, o, i] = kernel[o, i, j], zero
// past c in o and i (K-major B: tf32 wgmma takes no other); bias, g, beta:
// (cpo,) float32, zero past c (g, beta only with ln); out: (b, t_out, c_in),
// t_out = (t_in - k) / 2 + 1, columns past c written with what the padded
// weights give (the wrapper drops them).  k in {2, 3}, c <= 1024; cpo = 64
// for c <= 64 (a block holds the row), else c rounded up to 128; kp = c_in
// rounded up to the stage depth (64 bf16, 32 f32).
//
// The conv is a sum of GEMMs over the taps: output row t of batch row bi
// is sum_j x[bi, 2 t + j, :] . w_j, the TPU kernel's "slice" decomposition.
// Tap j's A operand is a strided view of x (a 3-D tensor map per tap over
// (b, t_out, c_in) at x + j c_in, rows 2 c_in apart, batches t_in c_in
// apart: t_in is odd at every layer, so no 2-D map over all rows could
// work), not a copy.  The kernels write exactly t_out rows per batch row;
// the TPU kernel's padded physical shapes, halo operand and clamped
// trailing blocks answer that chip's block rules and are not carried over.
//
// What bounds it on the H100: operations at C = 512 (the flagship's first
// fused layer, 16 x 25599 rows, depth 1536, 512 columns, is 644 GFLOP
// against 1.3 GB of bf16 traffic: 0.65 ms of bf16 tensor-core time, 0.38 ms
// of memory time; in f32 3.9 ms at 165 TFLOP/s of f32-accurate products,
// 0.8 ms of memory); bytes at C = 32 (tiny-speech: 96-deep rows of 32
// columns).  Beside the products, each 128-row tile reads its x box and
// w's slice per stage from L2, and takes one erf per element in its
// epilogue.
//
// One structure for every dtype and C, TMA + wgmma on Hopper, that of
// ffn_fwd.cu's up pass: a block owns 128 rows of one batch row (rows past
// t_out load as zeros and are not stored) and NCOL = min(cpo, 128) columns;
// a producer warp streams, per stage, x's (128 rows, 128 bytes) box of tap
// j and wt's (NCOL, 128 bytes) slice through a ring; two consumer
// warpgroups of 64 rows run wgmma m64nNCOL into NCOL / 2 f32 registers
// each.  bfloat16 takes bf16 products (k16 slices, 3 stages of 32 KB, two
// blocks an SM, one block's epilogue overlapping the other's products).
// float32 takes f32-accurate products on the tensor cores: each stage's
// tiles are split in shared memory into tf32 halves (hopper.cuh:
// split_tf32) and each k8 slice is hi hi + hi lo + lo hi, three tf32 wgmma
// (3 stages of 2 x 32 KB, one block an SM).  The epilogue works in the
// accumulator layout: bias, then without LayerNorm the GELU, rounded to
// x's dtype and stored by row.  With LayerNorm the cpo / 128 blocks of a row
// tile (up to 8 at C = 1024) form a thread-block cluster: each pushes its
// rows' sums over its columns below c into every block's shared memory
// (st.shared::cluster); after a cluster barrier each block adds the slice
// sums in slice order for the mean, and a second exchange of the centred
// squares gives the variance (dense_res_ln.cu's reduction); below 128
// columns one block holds the row (a cluster of one).  Nothing is atomic:
// two calls give the same bits.

#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hw = smx::hopper;
using bf16 = __nv_bfloat16;
using hw::BOX;
using hw::CONSUMERS;
using hw::HALF;
using hw::TILE;
using hw::WG_THREADS;

constexpr int MAX_TAPS = 3;
constexpr int MAX_CLUSTER = 8;              // 1024 columns of 128
constexpr int STAGES = 3;
constexpr int TC_THREADS = CONSUMERS + 32;  // + a producer warp

// elements of x's type in a 128-byte row: the depth of a stage
template <typename T>
__host__ __device__ constexpr int stage_depth() {
  return 128 / static_cast<int>(sizeof(T));
}

// one stage's tiles as TMA writes them (A, then B), and the stage with the
// lo halves of the f32 split after them
template <int NCOL>
__host__ __device__ constexpr int stage_hi() {
  return BOX + NCOL * 128;
}
template <typename T, int NCOL>
__host__ __device__ constexpr int stage_bytes() {
  return stage_hi<NCOL>() * (sizeof(T) == 4 ? 2 : 1);
}
// the ring, its barriers, and the rows' slice sums that the cluster's
// blocks push: [2 (sum, centred squares)][MAX_CLUSTER][TILE] floats
template <typename T, int NCOL>
constexpr size_t smem_bytes() {
  return 1024 + (size_t)STAGES * stage_bytes<T, NCOL>() +
         2 * STAGES * sizeof(uint64_t) +
         2 * MAX_CLUSTER * TILE * sizeof(float);
}

struct ConvArgs {
  // tap j: x's (b, t_out, c_in) view at x + j c_in, rows 2 c_in apart, in
  // (128, 128-byte) boxes (K-major A)
  CUtensorMap a[MAX_TAPS];
  CUtensorMap w;          // wt (k cpo, kp) in (NCOL, 128-byte) boxes
  const float* bias;      // (cpo,)
  const float* g;         // (cpo,), with LayerNorm
  const float* beta;      // (cpo,), with LayerNorm
  void* out;              // (b, t_out, c_in)
  int t_out, row_tiles;   // row tiles per batch row
  int taps, tap_steps;    // stages per tap: kp / stage depth
  int c, c_in, cpo, cluster;
  float eps;
};

// block x: row tile x / cluster (batch row, then 128-row tile within it)
// and columns NCOL (x % cluster) ..; with LN the blocks of a row tile are a
// cluster
template <typename T, int NCOL, bool LN>
__global__ void __launch_bounds__(TC_THREADS, sizeof(T) == 4 ? 1 : 2)
    conv_kernel(const __grid_constant__ ConvArgs p) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int HI = stage_hi<NCOL>();
  constexpr int STAGE = stage_bytes<T, NCOL>();
  constexpr int DEPTH = stage_depth<T>();
  constexpr int NACC = NCOL / 2;
  extern __shared__ uint8_t smem_raw[];
  // stage s: A (128 rows) | B (NCOL rows) as TMA writes them; f32: then
  // their lo halves
  uint8_t* stages = hw::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  float* psum = reinterpret_cast<float*>(empty + STAGES);
  float* psq = psum + MAX_CLUSTER * TILE;

  const int rank = blockIdx.x % p.cluster, tile = blockIdx.x / p.cluster;
  const int bi = tile / p.row_tiles, t0 = tile % p.row_tiles * TILE;
  const int n0 = rank * NCOL;
  const int ksteps = p.taps * p.tap_steps;
  const int wg = threadIdx.x / WG_THREADS;
  hw::init_ring<STAGES>(full, empty);
  // every block of the cluster has started before any writes to another's
  // shared memory (the wait comes before the first such write)
  if constexpr (LN) hw::cluster_arrive();

  if (wg == 2) {  // producer warp; its first thread issues the loads
    if (threadIdx.x == CONSUMERS) {
      hw::Ring<STAGES> ring;
      for (int kb = 0; kb < ksteps; ++kb) {
        const int s = ring.s, tap = kb / p.tap_steps;
        const int k = kb % p.tap_steps * DEPTH;
        uint8_t* st = stages + s * STAGE;
        ring.acquire(full, empty, HI);
        hw::tma_load3(st, &p.a[tap], &full[s], k, t0, bi);
        hw::tma_load(st + BOX, &p.w, &full[s], k, tap * p.cpo + n0);
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
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;
  hw::fence_regs(acc);
  if constexpr (F32) {
    float part[NACC];  // each stage's products
#pragma unroll
    for (int i = 0; i < NACC; ++i) part[i] = 0.0f;
    hw::consume_split<STAGES>(
        full, empty, ksteps,
        [&](int s) {
          uint8_t* st = stages + s * STAGE;
          hw::split_tf32(st, st + HI, HI, threadIdx.x, CONSUMERS);
        },
        [&](int s) {
          const uint8_t* hi = stages + s * STAGE;
          const uint8_t* lo = hi + HI;
          const int a = wg * HALF;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int o = kk * 32;
            hw::wgmma_tf32x3<NCOL>(part, hi + a + o, lo + a + o,
                                   hi + BOX + o, lo + BOX + o, kk == 0);
          }
        },
        [&]() { hw::promote_acc(acc, part); });
  } else {
    hw::consume<STAGES>(full, empty, ksteps, [&](int s) {
      const uint8_t* a = stages + s * STAGE + wg * HALF;
      const uint8_t* b = stages + s * STAGE + BOX;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = hw::desc_sw128(a + kk * 32, 16, hw::SBO);
        const uint64_t db = hw::desc_sw128(b + kk * 32, 16, hw::SBO);
        if constexpr (NCOL == 128) {
          hw::wgmma_m64n128k16<0, 0>(acc, da, db);
        } else {
          hw::wgmma_m64n64k16<0, 0>(acc, da, db, 1);
        }
      }
    });
  }
  hw::fence_regs(acc);

  // this thread: rows lrow, lrow + 8 of the tile, columns n0 + 8 j +
  // 2 (lane % 4) + {0, 1}, j < NCOL / 8
  const int lane = threadIdx.x % 32;
  const int lrow = wg * 64 + (threadIdx.x % WG_THREADS) / 32 * 16 + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < NCOL / 8; ++j) {
    const float2 bias = *reinterpret_cast<const float2*>(p.bias + col0 + 8 * j);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      acc[4 * j + 2 * i] += bias.x;
      acc[4 * j + 2 * i + 1] += bias.y;
      // columns past c hold zeros (zero weights and bias)
      sum[i] += acc[4 * j + 2 * i] + acc[4 * j + 2 * i + 1];
    }
  }
  if constexpr (LN) {
    const float inv_c = 1.0f / (float)p.c;
    hw::cluster_wait();  // every block of the cluster has started
    hw::cluster_row_sums(psum, rank, p.cluster, lrow, lane, sum);
    const float mean[2] = {sum[0] * inv_c, sum[1] * inv_c};
    float sq[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NCOL / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const bool valid = col0 + 8 * j + c < p.c;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float& v = acc[4 * j + 2 * i + c];
          v -= mean[i];
          if (valid) sq[i] += v * v;
        }
      }
    // after its barrier no block touches another's shared memory
    hw::cluster_row_sums(psq, rank, p.cluster, lrow, lane, sq);
    const float inv[2] = {rsqrtf(sq[0] * inv_c + p.eps),
                          rsqrtf(sq[1] * inv_c + p.eps)};
#pragma unroll
    for (int j = 0; j < NCOL / 8; ++j) {
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
    T* o = static_cast<T*>(p.out) + ((long long)bi * p.t_out + t) * p.c_in;
#pragma unroll
    for (int j = 0; j < NCOL / 8; ++j) {
      const int col = col0 + 8 * j;
      if (col >= p.c_in) continue;  // then col + 1 < c_in: c_in is even
      smx::store_pair(o + col, smx::activate(smx::kGelu, acc[4 * j + 2 * i]),
                 smx::activate(smx::kGelu, acc[4 * j + 2 * i + 1]));
    }
  }
}

template <typename T, int NCOL>
int launch(const ConvArgs& p, long long blocks, int ln, cudaStream_t stream) {
  const void* kernel =
      ln ? reinterpret_cast<const void*>(conv_kernel<T, NCOL, true>)
         : reinterpret_cast<const void*>(conv_kernel<T, NCOL, false>);
  const size_t smem = smem_bytes<T, NCOL>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks), 1, 1);
  cfg.blockDim = dim3(TC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = ln ? 1 : 0;  // the cluster only where rows are reduced
  void* args[] = {const_cast<ConvArgs*>(&p)};
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
                                int b, int t_in, int c, int c_in, int cpo,
                                int kp, int k, int ln, float eps, int dtype,
                                int device, void* stream) {
  const bool f32 = dtype == smx::kF32;
  const int ncol = cpo <= 64 ? 64 : 128;
  const int depth = f32 ? 32 : 64;
  if ((dtype != smx::kF32 && dtype != smx::kBF16) || b <= 0 || c <= 0 ||
      c > MAX_CLUSTER * 128 || c_in < c || c_in % 8 != 0 || cpo < c ||
      cpo % ncol != 0 || cpo / ncol > MAX_CLUSTER || kp < c_in ||
      kp % depth != 0 || (k != 2 && k != 3) || t_in < k ||
      (ln && (g == nullptr || beta == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!aligned(x, 16) || !aligned(w, 16) || !aligned(bias, 8) ||
      !aligned(out, 8) || (ln && (!aligned(g, 8) || !aligned(beta, 8)))) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const int t_out = (t_in - k) / 2 + 1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  ConvArgs p;
  const uint32_t elem = f32 ? 4 : 2;
  const uint8_t* xb = static_cast<const uint8_t*>(x);
  for (int j = 0; j < k; ++j) {
    if (!hw::make_map3_strided(&p.a[j], xb + (size_t)j * c_in * elem, b,
                               t_out, c_in, 2 * (uint64_t)c_in,
                               (uint64_t)t_in * c_in, TILE, depth, elem)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const bool mapped =
      f32 ? hw::make_map_f32(&p.w, w, (uint64_t)k * cpo, kp, kp, ncol)
          : hw::make_map(&p.w, w, (uint64_t)k * cpo, kp, ncol, depth);
  if (!mapped) return static_cast<int>(cudaErrorInvalidValue);
  p.bias = bias;
  p.g = g;
  p.beta = beta;
  p.out = out;
  p.t_out = t_out;
  p.row_tiles = (t_out + TILE - 1) / TILE;
  p.taps = k;
  p.tap_steps = kp / depth;
  p.c = c;
  p.c_in = c_in;
  p.cpo = cpo;
  p.cluster = cpo / ncol;
  p.eps = eps;
  const long long blocks = (long long)b * p.row_tiles * p.cluster;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32) {
    return ncol == 64 ? launch<float, 64>(p, blocks, ln, s)
                      : launch<float, 128>(p, blocks, ln, s);
  }
  return ncol == 64 ? launch<bf16, 64>(p, blocks, ln, s)
                    : launch<bf16, 128>(p, blocks, ln, s);
}
