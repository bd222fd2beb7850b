// K2: dense_res_ln — out = LayerNorm(res + x @ w + b) * g + beta (entry
// smx_dense_res_ln), and K11: dense_dropout_res_ln — out = LayerNorm(res +
// drop(x @ w + b)) * g + beta, the same body with the output mask (entry
// smx_dense_dropout_res_ln; the mask of dropout.cuh, stream 1, at (row, h
// column), multiplies the f32 sum x @ w + b before the residual), in
// bfloat16.  float32 K2 / K11 are the f32 down pass to z and the row pass
// of ffn_fwd.cu (smx_dense_res_ln_f32, smx_dense_dropout_res_ln_f32).
//
// K2 replaces the TPU kernel speechmix_tpu/ops/pallas/ffn_kernel.py:
// dense_res_ln (_kernel_dense_res_ln), the post-LN attention epilogue of the
// wav2vec2-base encoder layer and the BART blocks; K11 replaces
// dense_dropout_res_ln_trainable (_kernel_dense_dropout_res_ln) of the same
// file, that epilogue with the out-projection's dropout.
//
// x: (n, din), w: (din, h) row-major, res/out: (n, h) bfloat16; b, g, beta:
// (h,) float32.  din and h multiples of 128 (what the TPU package's gate
// admits), h <= 1024, or h <= 2048 where 256 divides it (a cluster of at
// most 8 blocks); x, w, res, g, beta and out 16-byte aligned (TMA).  Wider
// rows are the wrapper's two passes of ffn_fwd.cu.  The launcher refuses
// anything else.
//
// What bounds it on the H100: at the flagship shape (n = B*T ~ 12800,
// din = h = 768) the product is 2*n*din*h ~ 15 GFLOP (0.0153 ms at the bf16
// peak) against x, res and out, ~60 MB (0.0180 ms at 3.35 TB/s), so
// memory, with the tensor cores close behind.  The pre-LayerNorm sum never
// reaches device memory.  What holds the kernel above that bound (PERF.md):
// a tile's LayerNorm needs its whole row, so the blocks of a row tile wait
// for one another twice, and clusters of h / BN blocks leave SMs of a GPC
// unused.
//
// The kernel, TMA + wgmma on Hopper: a 128-row tile of the output is
// owned by a thread-block cluster of h / BN blocks, block r of the cluster
// owning columns BN r .. BN r + BN - 1; BN is 256 (or 128 where 256 does
// not divide h, and while the 128-column kernel's clusters take every row
// tile at once, as at the decoder's 1024 rows: its blocks end sooner).
// Inside a block the structure is that of ffn_fwd.cu's passes: a producer
// streams x's (128, 64) tile and w's (64, BN) slice (read MN-major through
// the descriptor) through a ring of stages, then the tile of res; two
// consumer warpgroups run wgmma m64nBNk16 into BN / 2 f32 registers each,
// din / 64 stages.  The epilogue works in the accumulator layout: z = (acc
// + b) * m_o + res, res read from its swizzled tile; each row's sum over
// every 128-column slice is pushed into the shared memory of every block
// of the cluster (st.shared::cluster); after a cluster barrier each block
// adds the h / 128 slice sums of its rows in slice order, for the mean; a
// second exchange of the sums of squared centred values gives the
// variance (as the TPU kernel's epilogue and smx_res_ln_rows take them).
// Both widths add the same slice sums in the same order, so they give the
// same statistics.  The block then normalises, applies g and beta, rounds
// into the res tile's place and stores it by TMA, which writes no row past
// n (rows past n load as zeros).  Nothing is atomic: two calls give the
// same bits.

#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hw = smx::hopper;
using hw::BK;
using hw::BOX;
using hw::CONSUMERS;
using hw::HALF;
using hw::MN_LBO;
using hw::SBO;
using hw::TILE;
using hw::WG_THREADS;

// the portable cluster size, and the 128-column slices of a row it covers
constexpr int MAX_CLUSTER = 8;
constexpr int MAX_SLICES = 16;

// A block owns 128 rows and BN = 256 columns of the output (128 where 256
// does not divide h): STAGES stages of x's (128, 64) box and BN / 64 boxes
// (64, 64) of w in flight; two consumer warpgroups and one producer warp
// (BN = 256: a producer warpgroup, whose registers go to the consumers'
// 128 accumulators)
template <int BN>
struct Shape {
  static constexpr int STAGES = BN == 256 ? 3 : 4;
  static constexpr int THREADS = CONSUMERS + (BN == 256 ? WG_THREADS : 32);
  static constexpr int B_BYTES = BN * BK * 2;   // w's boxes of a stage
  static constexpr int IO_BYTES = BN / 64 * BOX;  // the (128, BN) res / out
  // the ring, the res / out tile, STAGES full and empty barriers and the
  // tile's, then the row sums of each 128-column slice that the cluster's
  // blocks push: [2 (sum, centred squares)][MAX_SLICES][TILE] floats
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * (BOX + B_BYTES) +
                                 IO_BYTES +
                                 (2 * STAGES + 1) * sizeof(uint64_t) +
                                 2 * MAX_SLICES * TILE * sizeof(float);
};

struct LnArgs {
  CUtensorMap a;       // x (n, din) in (128, 64) boxes: K-major A
  CUtensorMap b;       // w (din, h) in (64, 64) boxes: MN-major B
  CUtensorMap r;       // res (n, h) in (128, 64) boxes
  CUtensorMap o;       // out (n, h) in (128, 64) boxes
  const float* bias;   // (h,)
  const float* g;      // (h,)
  const float* beta;   // (h,)
  int din, h;
  float eps;
  smx::Dropout drop;
};

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&acc)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 256) {
    hw::wgmma_m64n256k16<0, 1>(acc, da, db);
  } else {
    hw::wgmma_m64n128k16<0, 1>(acc, da, db);
  }
}

// the sum over the four lanes of a quad (one row of the accumulator layout),
// the same bits on all four
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// rows `lrow` and `lrow + 8` of one 128-column slice's partial sums v[] to
// row `slice` of `part` (MAX_SLICES x TILE floats) in every block of the
// cluster
__device__ __forceinline__ void push_rows(float* part, int slice, int blocks,
                                          int lrow, const float (&v)[2]) {
  for (int r = 0; r < blocks; ++r) {
    hw::st_cluster(part + slice * TILE + lrow, r, v[0]);
    hw::st_cluster(part + slice * TILE + lrow + 8, r, v[1]);
  }
}

// the sums over the row's `slices` slices, in slice order, of rows lrow,
// lrow + 8
__device__ __forceinline__ void slice_sums(const float* part, int slices,
                                           int lrow, float (&out)[2]) {
  out[0] = 0.0f;
  out[1] = 0.0f;
  for (int r = 0; r < slices; ++r) {
    out[0] += part[r * TILE + lrow];
    out[1] += part[r * TILE + lrow + 8];
  }
}

// grid (h / BN, row tiles), clusters of (h / BN, 1, 1): block (c, t), of
// rank c in its cluster, owns rows 128 t .. 128 t + 127 and columns
// BN c .. BN c + BN - 1
template <int BN, bool DROP>
__global__ void __launch_bounds__(Shape<BN>::THREADS, 1)
    dense_ln_kernel(const __grid_constant__ LnArgs p) {
  using S = Shape<BN>;
  // NJ 8-column groups of a thread, SL 128-column slices of a block
  constexpr int STAGES = S::STAGES, NJ = BN / 8, SL = BN / TILE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* as = hw::align1024(smem_raw);  // STAGES x BOX
  uint8_t* bs = as + STAGES * BOX;        // STAGES x B_BYTES
  uint8_t* io = bs + STAGES * S::B_BYTES;  // res, then out: IO_BYTES
  uint64_t* full = reinterpret_cast<uint64_t*>(io + S::IO_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* io_bar = empty + STAGES;
  float* psum = reinterpret_cast<float*>(io_bar + 1);  // MAX_SLICES x TILE
  float* psq = psum + MAX_SLICES * TILE;               // MAX_SLICES x TILE

  // block `rank` of the cluster holds slices SL rank .. SL rank + SL - 1
  const int blocks = gridDim.x, rank = blockIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * TILE;
  const int ksteps = p.din / BK;
  const int wg = threadIdx.x / WG_THREADS;
  if (threadIdx.x == 0) hw::mbar_init(io_bar, 1);
  hw::init_ring<STAGES>(full, empty);
  // every block of the cluster has started before any writes to another's
  // shared memory (the wait comes before the first such write)
  hw::cluster_arrive();

  if (wg == 2) {  // producer; its first thread issues the loads
    if constexpr (BN == 256) hw::setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS) {
      hw::Ring<STAGES> ring;
      for (int kb = 0; kb < ksteps; ++kb) {
        const int k = kb * BK, s = ring.s;
        ring.acquire(full, empty, BOX + S::B_BYTES);
        hw::tma_load(as + s * BOX, &p.a, &full[s], k, m0);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c) {
          hw::tma_load(bs + s * S::B_BYTES + c * HALF, &p.b, &full[s],
                       n0 + 64 * c, k);
        }
        ring.advance();
        if (kb == (STAGES < ksteps ? STAGES : ksteps) - 1) {
          // the residual tile, behind the ring's first loads
          hw::mbar_expect_tx(io_bar, S::IO_BYTES);
#pragma unroll
          for (int c = 0; c < BN / 64; ++c) {
            hw::tma_load(io + c * BOX, &p.r, io_bar, n0 + 64 * c, m0);
          }
        }
      }
    }
    __syncwarp();
    // the consumers' cluster barriers
    hw::cluster_wait();
    hw::cluster_sync();
    hw::cluster_sync();
    return;
  }
  if constexpr (BN == 256) hw::setmaxnreg_inc<232>();
  // consumers: rows m0 + 64 wg .. + 63
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  hw::fence_regs(acc);
  hw::consume<STAGES>(full, empty, ksteps, [&](int s) {
    const uint8_t* a = as + s * BOX + wg * HALF;
    const uint8_t* b = bs + s * S::B_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_tile<BN>(acc, hw::desc_sw128(a + kk * 32, 16, SBO),
                     hw::desc_sw128(b + kk * 2048, MN_LBO, SBO));
    }
  });
  hw::fence_regs(acc);

  // this thread holds rows lrow, lrow + 8 of the tile (row0, row0 + 8 of
  // the output) and columns n0 + 8 j + 2 (lane % 4) + {0, 1}, j < BN / 8.
  // In the swizzled res / out tile, column group j of row r lies in box
  // j / 8 at 16-byte chunk (j % 8) ^ (r % 8), and r % 8 = lane / 4
  const int t = threadIdx.x % WG_THREADS, warp = t / 32, lane = t % 32;
  const int lrow = wg * 64 + warp * 16 + lane / 4;
  const long long row0 = (long long)m0 + lrow;
  auto io_at = [&](int j, int i) {
    return reinterpret_cast<__nv_bfloat162*>(
        io + (j / 8) * BOX + (lrow + 8 * i) * 128 +
        ((j % 8) ^ (lane / 4)) * 16 + (lane % 4) * 4);
  };
  const float inv_h = 1.0f / (float)p.h;
  hw::mbar_wait(io_bar, 0);
  // z = (acc + b) * m + res in place (res zeros past n: TMA), and its row
  // sums over each 128-column slice
  float sum[SL][2] = {};
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    const float2 bias = *reinterpret_cast<const float2*>(p.bias + col);
    float m[2][2] = {{1.0f, 1.0f}, {1.0f, 1.0f}};
    if constexpr (DROP) smx::accum_mask(p.drop, row0, col, lane, m);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 r = __bfloat1622float2(*io_at(j, i));
      float& v0 = acc[4 * j + 2 * i];
      float& v1 = acc[4 * j + 2 * i + 1];
      if constexpr (DROP) {
        v0 = (v0 + bias.x) * m[i][0] + r.x;
        v1 = (v1 + bias.y) * m[i][1] + r.y;
      } else {
        v0 = v0 + bias.x + r.x;
        v1 = v1 + bias.y + r.y;
      }
      sum[j / 16][i] += v0 + v1;
    }
  }
  hw::cluster_wait();  // every block of the cluster has started
#pragma unroll
  for (int sl = 0; sl < SL; ++sl) {
    sum[sl][0] = quad_sum(sum[sl][0]);
    sum[sl][1] = quad_sum(sum[sl][1]);
    if (lane % 4 == 0) push_rows(psum, SL * rank + sl, blocks, lrow, sum[sl]);
  }
  hw::cluster_sync();
  float mean[2];
  slice_sums(psum, SL * blocks, lrow, mean);
  mean[0] *= inv_h;
  mean[1] *= inv_h;
  // the variance of the centred values
  float sq[SL][2] = {};
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float d0 = acc[4 * j + 2 * i] - mean[i];
      const float d1 = acc[4 * j + 2 * i + 1] - mean[i];
      sq[j / 16][i] += d0 * d0 + d1 * d1;
    }
  }
#pragma unroll
  for (int sl = 0; sl < SL; ++sl) {
    sq[sl][0] = quad_sum(sq[sl][0]);
    sq[sl][1] = quad_sum(sq[sl][1]);
    if (lane % 4 == 0) push_rows(psq, SL * rank + sl, blocks, lrow, sq[sl]);
  }
  // after this barrier no block touches another's shared memory
  hw::cluster_sync();
  float inv[2];
  slice_sums(psq, SL * blocks, lrow, inv);
  inv[0] = rsqrtf(inv[0] * inv_h + p.eps);
  inv[1] = rsqrtf(inv[1] * inv_h + p.eps);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    const float2 g = *reinterpret_cast<const float2*>(p.g + col);
    const float2 bb = *reinterpret_cast<const float2*>(p.beta + col);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // where this thread read its residual
      *io_at(j, i) = __floats2bfloat162_rn(
          (acc[4 * j + 2 * i] - mean[i]) * inv[i] * g.x + bb.x,
          (acc[4 * j + 2 * i + 1] - mean[i]) * inv[i] * g.y + bb.y);
    }
  }
  // the tile to global memory by TMA, which writes no row past n
  hw::fence_async_smem();
  hw::bar_sync(1, CONSUMERS);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < BN / 64; ++c) {
      hw::tma_store(&p.o, io + c * BOX, n0 + 64 * c, m0);
    }
    hw::tma_store_wait();
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return p != nullptr && (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// The launch configuration of the BN-column kernel over `row_tiles` row
// tiles (0 when it only asks how many clusters fit), its shared-memory
// attribute set.
template <int BN, bool DROP>
cudaError_t configure(const void** kernel, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr, int h, int row_tiles,
                      cudaStream_t stream) {
  *kernel = reinterpret_cast<const void*>(dense_ln_kernel<BN, DROP>);
  cudaError_t err = cudaFuncSetAttribute(
      *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Shape<BN>::SMEM));
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = h / BN;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(h / BN, row_tiles > 0 ? row_tiles : 1, 1);
  cfg->blockDim = dim3(Shape<BN>::THREADS, 1, 1);
  cfg->dynamicSmemBytes = Shape<BN>::SMEM;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// How many clusters of the BN-column kernel at width h the card holds at
// once, asked once per device and cluster size; 0 if none fits (one GPC).
template <int BN, bool DROP>
int clusters_at_once(int h, int device) {
  static int known[16][MAX_CLUSTER + 1];
  const int blocks = h / BN;
  if (device >= 0 && device < 16 && known[device][blocks] > 0) {
    return known[device][blocks];
  }
  const void* kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int clusters = 0;
  if (configure<BN, DROP>(&kernel, &cfg, &attr, h, 0, nullptr) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) !=
          cudaSuccess) {
    return 0;
  }
  if (device >= 0 && device < 16) known[device][blocks] = clusters;
  return clusters;
}

template <int BN, bool DROP>
int launch_cluster(const LnArgs& p, int row_tiles, cudaStream_t stream) {
  const void* kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      configure<BN, DROP>(&kernel, &cfg, &attr, p.h, row_tiles, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {const_cast<LnArgs*>(&p)};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool DROP>
int launch_bf16(const void* x, const void* w, const float* b, const void* res,
                const float* g, const float* beta, void* out, int n, int din,
                int h, float eps, smx::Dropout drop, int device,
                cudaStream_t stream) {
  const int row_tiles = (n + TILE - 1) / TILE;
  const bool narrow_fits = h / TILE <= MAX_CLUSTER;
  const bool wide_fits = h % 256 == 0 && h / 256 <= MAX_CLUSTER;
  if (din % TILE != 0 || h % TILE != 0 || !(narrow_fits || wide_fits) ||
      row_tiles > 65535 || !aligned(x, 16) || !aligned(w, 16) ||
      !aligned(b, 8) || !aligned(res, 16) || !aligned(g, 16) ||
      !aligned(beta, 16) || !aligned(out, 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the 128-column kernel while its clusters take all row tiles at once
  // (its blocks end sooner), else the 256-column one (fewer blocks, more
  // of them at once, each x tile read by half as many blocks)
  bool wide = wide_fits;
  if (narrow_fits) {
    const int at_once = clusters_at_once<TILE, DROP>(h, device);
    if (at_once < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    wide = wide_fits && row_tiles > at_once;
  }
  if (wide && clusters_at_once<256, DROP>(h, device) < 1) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  LnArgs p;
  if (!hw::make_map(&p.a, x, n, din, TILE, BK) ||
      !hw::make_map(&p.b, w, din, h, BK, BK) ||
      !hw::make_map(&p.r, res, n, h, TILE, BK) ||
      !hw::make_map(&p.o, out, n, h, TILE, BK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.bias = b;
  p.g = g;
  p.beta = beta;
  p.din = din;
  p.h = h;
  p.eps = eps;
  p.drop = drop;
  return wide ? launch_cluster<256, DROP>(p, row_tiles, stream)
              : launch_cluster<TILE, DROP>(p, row_tiles, stream);
}

template <bool DROP>
int launch(const void* x, const void* w, const float* b, const void* res,
           const float* g, const float* beta, void* out, int n, int din, int h,
           float eps, smx::Dropout drop, int device, void* stream) {
  if (h <= 0 || din <= 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_bf16<DROP>(x, w, b, res, g, beta, out, n, din, h, eps, drop,
                           device, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int smx_dense_res_ln(const void* x, const void* w, const float* b,
                                const void* res, const float* g,
                                const float* beta, void* out, int n, int din,
                                int h, float eps, int device, void* stream) {
  return launch<false>(x, w, b, res, g, beta, out, n, din, h, eps,
                       smx::Dropout{}, device, stream);
}

// K11: k0, k1 the site's key; threshold and scale of the output mask
// (stream 1), from the host.
extern "C" int smx_dense_dropout_res_ln(const void* x, const void* w,
                                        const float* b, const void* res,
                                        const float* g, const float* beta,
                                        void* out, int n, int din, int h,
                                        float eps, uint32_t k0, uint32_t k1,
                                        uint32_t threshold, float scale,
                                        int device, void* stream) {
  return launch<true>(x, w, b, res, g, beta, out, n, din, h, eps,
                      smx::make_dropout(k0, k1, smx::kStreamOut, threshold,
                                        scale),
                      device, stream);
}
