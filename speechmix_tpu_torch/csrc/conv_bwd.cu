// K6's backward: the gradient of one wav2vec2 feature-extractor layer,
// out = GELU([LayerNorm](conv1d(x, stride 2, VALID) + bias)), in three
// passes, for fused_conv_stack's backward (ops/kernels/conv_extractor.py).
//
// No TPU kernel is replaced: the JAX package's fused_conv_stack_trainable
// (speechmix_tpu/ops/pallas/conv_extractor.py) recomputes the chain through
// XLA for its backward.  Here the forward keeps every layer's input, and
// the backward walks the layers from the last to the first, three launches
// a layer, given dout (the gradient of the layer's output, x's dtype):
//
//   smx_conv_bwd_act     the activation pass: K6's products again on
//     128-row tiles of the layer's output, z = sum_j x[2 t + j] w_j + bias,
//     then in the epilogue (with LayerNorm the statistics and the row sums
//     of its backward across the cluster's column slices, as K6 reduces
//     its rows) dy = dout GELU'(y) (y = LayerNorm(z) or z, exact erf) and
//     gz = dL/dz = dy, or rstd (dy g - mean(dy g) - x^ mean(dy g x^)) with
//     LayerNorm; writes gz in x's dtype (float32 with the weight pass also
//     gz^T per batch row, (b, c, ldt), its K-major operand), and the
//     column sums of gz, dy x^ and dy over each tile (dbias, dgamma,
//     dbeta), added afterwards over the tiles in a fixed order.
//   smx_conv_bwd_data    the data gradient dx, the stride-2 transposed
//     conv split by the parity of the input row, so that every row of dx is
//     written once by one block and nothing is atomic: k = 3 gives
//     dx[2 t] = gz[t] w_0^T + gz[t - 1] w_2^T and dx[2 t + 1] = gz[t] w_1^T;
//     k = 2 gives dx[2 t + j] = gz[t] w_j^T; rows that no output reads get
//     zeros (their gz rows lie outside gz and load as zeros).  Each parity
//     is a dense GEMM on K6's structure: A is gz through a 3-D tensor map
//     (the shifted tap at row t - 1, which the map fills with zeros at
//     t = 0), B is wd (k, cpo, kp), wd[j, i, o] = kernel[o, i, j].
//   smx_conv_bwd_weight  the weight gradient dw[j, o, i] = sum over rows
//     of gz[t, o] x[2 t + j, i], C x C a tap, split over fixed ranges of
//     (batch row, row chunk) steps, one range a block; the ranges' float32
//     partials are added in range order by a second kernel.  bfloat16
//     reads gz and x's tap views MN-major through the descriptors;
//     float32 (tf32 wgmma takes K-major operands only) reads gz^T and each
//     tap's rows of x transposed, (k, b, c, ldt), which its first kernel
//     lays out: a box's first column must lie on a 16-byte boundary, so tap
//     2 cannot read tap 0's rows one column on.
//
// Nothing is atomic: two runs give the same bits.
//
// What bounds it on the H100: operations.  Each pass is 2 B k T_out C^2
// FLOPs, three times K6's forward in all: at the flagship's B = 32, C = 512
// the six layers' 148,784 k T_out rows are 2.5 TFLOP a pass, 15.1 ms of
// f32-accurate products (three tf32 products at 495 TFLOP/s) against
// ~7 GB of f32 traffic (2.1 ms), 2.5 ms in bf16.  The row passes take K6's
// TMA + wgmma ring (bf16 products; float32 three tf32 products on operands
// split in shared memory); the weight pass ffn_bwd.cu's product kernels.
// Measured at B = 16 (PERF.md): f32 2.1-4.0x the bound a pass; bf16 the
// data and weight passes 1.9-6x, the act pass 6-12x (with LayerNorm one
// block an SM: x^ and dy both live, four cluster exchanges).

#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hw = smx::hopper;
using bf16 = __nv_bfloat16;
using hw::BOX;
using hw::CONSUMERS;
using hw::HALF;
using hw::MN_LBO;
using hw::SBO;
using hw::THREADS;
using hw::TILE;
using hw::WG_THREADS;

constexpr int MAX_TAPS = 3;
constexpr int MAX_CLUSTER = 8;              // 1024 columns of 128
constexpr int STAGES = 3;                   // the row passes' ring
constexpr int W16_STAGES = 6;               // the bf16 weight pass: 32 KB each
constexpr int W32_STAGES = 3;               // the f32 weight pass: 64 KB each
constexpr int TC_THREADS = CONSUMERS + 32;  // + a producer warp
constexpr int NT = 256;                     // the reductions' threads

template <typename T>
__host__ __device__ constexpr int stage_depth() {
  return 128 / static_cast<int>(sizeof(T));
}
// a row pass's stage: A (128 rows) then B (NCOL rows) of 128 bytes; f32:
// then their lo halves
template <int NCOL>
__host__ __device__ constexpr int stage_hi() {
  return BOX + NCOL * 128;
}
template <typename T, int NCOL>
__host__ __device__ constexpr int stage_bytes() {
  return stage_hi<NCOL>() * (sizeof(T) == 4 ? 2 : 1);
}
// the ring, its barriers and three slots of the LayerNorm rows' slice sums
// ([MAX_CLUSTER][TILE] floats each) that the cluster's blocks push
template <typename T, int NCOL>
constexpr size_t row_smem_bytes() {
  return 1024 + (size_t)STAGES * stage_bytes<T, NCOL>() +
         2 * STAGES * sizeof(uint64_t) +
         3 * MAX_CLUSTER * TILE * sizeof(float);
}

// ------------------------------------------------------------ row passes
// The operands of a row pass: output rows t0 .. t0 + 127 of batch row bi,
// columns n0 .. n0 + NCOL - 1, the sum over the block's taps of A (a tap's
// rows) times B (the tap's weights), K = kp a tap in stages of 128 bytes.
struct RowOperands {
  CUtensorMap a[MAX_TAPS];  // (b, rows, c) views in (128, 128-byte) boxes
  CUtensorMap w;            // (k cpo, kp) in (NCOL, 128-byte) boxes
  int tap_steps, cpo;
};

// a block's taps: A map, row shift and weight tap of each
struct Taps {
  int n;
  int map[MAX_TAPS], shift[MAX_TAPS], w[MAX_TAPS];
};

template <typename T, int NCOL>
__device__ __forceinline__ void produce_rows(const RowOperands& op,
                                             const Taps& tp, uint8_t* stages,
                                             uint64_t* full, uint64_t* empty,
                                             int t0, int bi, int n0) {
  constexpr int HI = stage_hi<NCOL>();
  constexpr int STAGE = stage_bytes<T, NCOL>();
  constexpr int DEPTH = stage_depth<T>();
  hw::Ring<STAGES> ring;
  const int ksteps = tp.n * op.tap_steps;
  for (int kb = 0; kb < ksteps; ++kb) {
    const int s = ring.s, i = kb / op.tap_steps;
    const int k = kb % op.tap_steps * DEPTH;
    uint8_t* st = stages + s * STAGE;
    ring.acquire(full, empty, HI);
    hw::tma_load3(st, &op.a[tp.map[i]], &full[s], k, t0 + tp.shift[i], bi);
    hw::tma_load(st + BOX, &op.w, &full[s], k, tp.w[i] * op.cpo + n0);
    ring.advance();
  }
}

// K6's consumers: rows 64 wg .. + 63 of the tile into acc (wgmma m64nNCOL)
template <typename T, int NCOL>
__device__ __forceinline__ void consume_rows(float (&acc)[NCOL / 2],
                                             uint8_t* stages, uint64_t* full,
                                             uint64_t* empty, int ksteps,
                                             int wg) {
  constexpr int HI = stage_hi<NCOL>();
  constexpr int STAGE = stage_bytes<T, NCOL>();
  constexpr int NACC = NCOL / 2;
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;
  hw::fence_regs(acc);
  if constexpr (sizeof(T) == 4) {
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
    // a wait every consumer thread passes (consume_split's last one is
    // under a branch), so that ptxas injects none in the epilogue's
    // divergent code
    hw::wgmma_wait<0>();
    hw::fence_regs(part);
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
}

// The column sums over a warp's 16 rows of v(e) for this thread's elements
// e (4 j + 2 i + c: rows lrow + 8 i, columns 8 j + 2 (lane % 4) + c of the
// block), to red[warp][column]
template <int NCOL, typename V>
__device__ __forceinline__ void warp_column_sums(float* red, int warp,
                                                 int lane, V v) {
#pragma unroll
  for (int j = 0; j < NCOL / 8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float s = v(4 * j + c) + v(4 * j + 2 + c);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
      }
      if (lane < 4) red[warp * NCOL + 8 * j + 2 * lane + c] = s;
    }
  }
}

struct ActArgs {
  RowOperands op;     // a[j]: tap j of x, rows 2 c apart; w: wt (K6's)
  const float* bias;  // (cpo,), zero past c
  const float* g;     // (cpo,), with LayerNorm, zero past c
  const float* beta;  // (cpo,), with LayerNorm
  const void* dout;   // (b, t_out, c): the gradient of the layer's output
  void* gz;           // (b, t_out, c): dL/dz
  float* gzt;         // float32 for the weight pass: (b, c, ldt), else null
  float* part;        // (nq, tiles, c): column sums per row tile, else null
  int t_out, row_tiles, tiles, taps, c;
  int c_ln;  // the layer's width, over which LayerNorm normalises: c, or
             // less where the caller padded the channels to c with zeros
  int cluster;  // the blocks of a row tile, a cluster with LayerNorm
  int nq, ldt, b;
  float eps;
};

// block x: row tile x / cluster (batch row, then 128-row tile within it)
// and columns NCOL (x % cluster) ..; with LayerNorm the blocks of a row tile
// are a cluster.  float32, and bfloat16 with LayerNorm (which keeps x^ and
// dy both), take one block an SM.
template <typename T, int NCOL, bool LN>
__global__ void __launch_bounds__(TC_THREADS, (sizeof(T) == 4 || LN) ? 1 : 2)
    extractor_bwd_act_kernel(const __grid_constant__ ActArgs p) {
  constexpr int NACC = NCOL / 2;
  constexpr int STAGE = stage_bytes<T, NCOL>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* stages = hw::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  float* slot = reinterpret_cast<float*>(empty + STAGES);
  constexpr int SLOT = MAX_CLUSTER * TILE;

  const int rank = blockIdx.x % p.cluster, tile = blockIdx.x / p.cluster;
  const int bi = tile / p.row_tiles, t0 = tile % p.row_tiles * TILE;
  const int n0 = rank * NCOL;
  const int wg = threadIdx.x / WG_THREADS;
  hw::init_ring<STAGES>(full, empty);
  if constexpr (LN) hw::cluster_arrive();

  if (wg == 2) {  // producer warp; its first thread issues the loads
    if (threadIdx.x == CONSUMERS) {
      Taps tp;
      tp.n = p.taps;
      for (int j = 0; j < MAX_TAPS; ++j) {
        tp.map[j] = j;
        tp.shift[j] = 0;
        tp.w[j] = j;
      }
      produce_rows<T, NCOL>(p.op, tp, stages, full, empty, t0, bi, n0);
    }
    if constexpr (LN) {  // the consumers' four exchanges
      __syncwarp();
      hw::cluster_wait();
      for (int i = 0; i < 4; ++i) hw::cluster_sync();
    }
    return;
  }
  float acc[NACC];
  consume_rows<T, NCOL>(acc, stages, full, empty, p.taps * p.op.tap_steps,
                        wg);

  // this thread: rows lrow, lrow + 8 of the tile, columns n0 + 8 j +
  // 2 (lane % 4) + {0, 1}, j < NCOL / 8
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int lrow = wg * 64 + (threadIdx.x % WG_THREADS) / 32 * 16 + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);
  const float inv_c = 1.0f / (float)p.c_ln;
#pragma unroll
  for (int j = 0; j < NCOL / 8; ++j) {
    const float2 bias = *reinterpret_cast<const float2*>(p.bias + col0 + 8 * j);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      acc[4 * j + 2 * i] += bias.x;
      acc[4 * j + 2 * i + 1] += bias.y;
    }
  }
  float rstd[2] = {1.0f, 1.0f};
  if constexpr (LN) {  // K6's statistics; acc becomes x^
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int e = 0; e < NACC; ++e) sum[e / 2 % 2] += acc[e];
    hw::cluster_wait();  // every block of the cluster has started
    hw::cluster_row_sums(slot, rank, p.cluster, lrow, lane, sum);
    const float mean[2] = {sum[0] * inv_c, sum[1] * inv_c};
    float sq[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NCOL / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const bool valid = col0 + 8 * j + c < p.c_ln;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float& v = acc[4 * j + 2 * i + c];
          v -= mean[i];
          if (valid) sq[i] += v * v;
        }
      }
    hw::cluster_row_sums(slot + SLOT, rank, p.cluster, lrow, lane, sq);
    rstd[0] = rsqrtf(sq[0] * inv_c + p.eps);
    rstd[1] = rsqrtf(sq[1] * inv_c + p.eps);
#pragma unroll
    for (int e = 0; e < NACC; ++e) acc[e] *= rstd[e / 2 % 2];
  }

  // dy = dout GELU'(y): in dy with LayerNorm (x^ stays in acc), else in acc
  const T* dout = static_cast<const T*>(p.dout);
  float dy[LN ? NACC : 1];
#pragma unroll
  for (int j = 0; j < NCOL / 8; ++j) {
    const int col = col0 + 8 * j;
    float2 g = make_float2(1.0f, 1.0f), bb = make_float2(0.0f, 0.0f);
    if constexpr (LN) {
      g = *reinterpret_cast<const float2*>(p.g + col);
      bb = *reinterpret_cast<const float2*>(p.beta + col);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = t0 + lrow + 8 * i;
      float2 d = make_float2(0.0f, 0.0f);
      if (t < p.t_out && col < p.c) {
        d = smx::load_pair(dout + ((long long)bi * p.t_out + t) * p.c + col);
      }
      const int e = 4 * j + 2 * i;
      float y0 = acc[e], y1 = acc[e + 1];
      if constexpr (LN) {
        y0 = y0 * g.x + bb.x;
        y1 = y1 * g.y + bb.y;
      }
      const float d0 = d.x * smx::dactivate(smx::kGelu, y0);
      const float d1 = d.y * smx::dactivate(smx::kGelu, y1);
      if constexpr (LN) {
        dy[e] = d0;
        dy[e + 1] = d1;
      } else {
        acc[e] = d0;
        acc[e + 1] = d1;
      }
    }
  }
  // the column sums reuse the ring: both warpgroups' products are done
  float* red = reinterpret_cast<float*>(stages);
  if (p.nq > 0) hw::bar_sync(1, CONSUMERS);
  if constexpr (LN) {
    // the LayerNorm backward's row sums of dx^ = dy g and of dx^ x^ (g is
    // zero past c, so the padded columns add nothing)
    float s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NCOL / 8; ++j) {
      const float2 g = *reinterpret_cast<const float2*>(p.g + col0 + 8 * j);
#pragma unroll
      for (int e = 4 * j; e < 4 * j + 4; ++e) {
        const float dxh = dy[e] * (e % 2 ? g.y : g.x);
        s1[e / 2 % 2] += dxh;
        s2[e / 2 % 2] += dxh * acc[e];
      }
    }
    hw::cluster_row_sums(slot + 2 * SLOT, rank, p.cluster, lrow, lane, s1);
    // the first exchange's slot: every block read it before the second
    // exchange's barrier, which every block passed before this one's writes
    hw::cluster_row_sums(slot, rank, p.cluster, lrow, lane, s2);
    if (p.nq > 0) {
      warp_column_sums<NCOL>(red + 1 * 8 * NCOL, warp, lane,
                             [&](int e) { return dy[e] * acc[e]; });
      warp_column_sums<NCOL>(red + 2 * 8 * NCOL, warp, lane,
                             [&](int e) { return dy[e]; });
    }
#pragma unroll
    for (int j = 0; j < NCOL / 8; ++j) {
      const float2 g = *reinterpret_cast<const float2*>(p.g + col0 + 8 * j);
#pragma unroll
      for (int e = 4 * j; e < 4 * j + 4; ++e) {
        const int i = e / 2 % 2;
        // zero past c_ln: a padded column's x^ is not 0
        acc[e] = col0 + 8 * j + e % 2 < p.c_ln
                     ? rstd[i] * (dy[e] * (e % 2 ? g.y : g.x) - s1[i] * inv_c -
                                  acc[e] * (s2[i] * inv_c))
                     : 0.0f;
      }
    }
  }
  // acc is gz; rows past t_out hold zeros (their dout is zero)
  if (p.nq > 0) {
    warp_column_sums<NCOL>(red, warp, lane, [&](int e) { return acc[e]; });
    hw::bar_sync(1, CONSUMERS);
    if (threadIdx.x < NCOL && n0 + threadIdx.x < p.c) {
      for (int q = 0; q < p.nq; ++q) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < 8; ++w) s += red[(q * 8 + w) * NCOL + threadIdx.x];
        p.part[((long long)q * p.tiles + tile) * p.c + n0 + threadIdx.x] = s;
      }
    }
  }
  T* gz = static_cast<T*>(p.gz);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + lrow + 8 * i;
    if (t >= p.t_out) continue;
    T* o = gz + ((long long)bi * p.t_out + t) * p.c;
#pragma unroll
    for (int j = 0; j < NCOL / 8; ++j) {
      const int col = col0 + 8 * j;
      if (col >= p.c) continue;  // then col + 1 < c: c is even
      const float v0 = acc[4 * j + 2 * i], v1 = acc[4 * j + 2 * i + 1];
      smx::store_pair(o + col, v0, v1);
      if (p.gzt != nullptr) {
        float* ot = p.gzt + ((long long)bi * p.c + col) * p.ldt + t;
        ot[0] = v0;
        ot[p.ldt] = v1;
      }
    }
  }
}

struct DataArgs {
  RowOperands op;  // a[0]: gz (b, t_out, c); w: wd
  void* dx;        // (b, t_in, c)
  int t_in, taps, c, row_tiles, col_blocks;
};

// block x: column block x % col_blocks, then row tile, parity, batch row
template <typename T, int NCOL>
__global__ void __launch_bounds__(TC_THREADS, sizeof(T) == 4 ? 1 : 2)
    extractor_dgrad_kernel(const __grid_constant__ DataArgs p) {
  constexpr int NACC = NCOL / 2;
  constexpr int STAGE = stage_bytes<T, NCOL>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* stages = hw::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + STAGES * STAGE);
  uint64_t* empty = full + STAGES;

  const int nb = blockIdx.x % p.col_blocks;
  const int r = blockIdx.x / p.col_blocks;
  const int t0 = r % p.row_tiles * TILE, par = r / p.row_tiles % 2;
  const int bi = r / p.row_tiles / 2;
  const int n0 = nb * NCOL;
  // dx[2 t + par] = sum of gz[t + shift] w_tap^T over the parity's taps
  Taps tp;
  tp.n = (par == 0 && p.taps == 3) ? 2 : 1;
  tp.map[0] = tp.map[1] = tp.map[2] = 0;
  tp.shift[0] = 0;
  tp.shift[1] = -1;
  tp.shift[2] = 0;
  tp.w[0] = par;
  tp.w[1] = 2;
  tp.w[2] = 0;
  const int wg = threadIdx.x / WG_THREADS;
  hw::init_ring<STAGES>(full, empty);
  if (wg == 2) {
    if (threadIdx.x == CONSUMERS) {
      produce_rows<T, NCOL>(p.op, tp, stages, full, empty, t0, bi, n0);
    }
    return;
  }
  float acc[NACC];
  consume_rows<T, NCOL>(acc, stages, full, empty, tp.n * p.op.tap_steps, wg);
  const int lane = threadIdx.x % 32;
  const int lrow = wg * 64 + (threadIdx.x % WG_THREADS) / 32 * 16 + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);
  T* dx = static_cast<T*>(p.dx);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = 2 * (t0 + lrow + 8 * i) + par;
    if (row >= p.t_in) continue;
    T* o = dx + ((long long)bi * p.t_in + row) * p.c;
#pragma unroll
    for (int j = 0; j < NCOL / 8; ++j) {
      const int col = col0 + 8 * j;
      if (col >= p.c) continue;
      smx::store_pair(o + col, acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  }
}

// ------------------------------------------------------------ weight pass
struct WeightArgs {
  // bf16: gz (b, t_out, c) in (64 rows, 64) boxes, MN-major A; f32: gz^T
  // (b, c, t_out) in (128, 32) boxes, K-major A
  CUtensorMap a;
  // bf16: tap j of x (b, t_out, c), rows 2 c apart, in (64, 64) boxes;
  // f32: tap j's rows of x transposed, (b, c, ldt), in (128, 32) boxes
  CUtensorMap x[MAX_TAPS];
  float* out;  // splits records of (taps, c, c), or the result
  int taps, c, mtiles, chunks, steps, per_split;
};

// block x: tile x % tiles (tap, o tile, i tile), split x / tiles: steps
// [split per_split, + per_split) of the (batch row, row chunk) steps
struct WItem {
  int tap, m0, n0, split, k0, k1;
};

__device__ __forceinline__ WItem weight_item(const WeightArgs& p) {
  const int tiles = p.taps * p.mtiles * p.mtiles;
  const int t = blockIdx.x % tiles;
  WItem it;
  it.split = blockIdx.x / tiles;
  it.tap = t / (p.mtiles * p.mtiles);
  it.m0 = t / p.mtiles % p.mtiles * TILE;
  it.n0 = t % p.mtiles * TILE;
  it.k0 = it.split * p.per_split;
  it.k1 = min(p.steps, it.k0 + p.per_split);
  return it;
}

// the (128, 128) tile of o rows, i columns into the split's record
__device__ __forceinline__ void store_weight(const WeightArgs& p,
                                             const WItem& it,
                                             const float (&acc)[64], int wg) {
  const int t = threadIdx.x % WG_THREADS, lane = t % 32;
  const int wrow = it.m0 + wg * 64 + t / 32 * 16 + lane / 4;
  float* out = p.out + ((long long)it.split * p.taps + it.tap) * p.c * p.c;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = it.n0 + 8 * j + 2 * (lane % 4);
    if (col >= p.c) continue;  // then col + 1 < c: c is even
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = wrow + 8 * i;
      if (row >= p.c) continue;
      smx::store_pair(out + (long long)row * p.c + col, acc[4 * j + 2 * i],
                 acc[4 * j + 2 * i + 1]);
    }
  }
}

// The weight pass's blocks are ffn_bwd.cu's products kernels': a producer
// warpgroup (its first thread issues the loads) and two consumer warpgroups
__global__ void __launch_bounds__(THREADS, 1)
    extractor_wgrad_kernel(const __grid_constant__ WeightArgs p) {
  constexpr int DEPTH = 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* as = hw::align1024(smem_raw);  // W16_STAGES x BOX
  uint8_t* bs = as + W16_STAGES * BOX;
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + W16_STAGES * BOX);
  uint64_t* empty = full + W16_STAGES;
  const WItem it = weight_item(p);
  const int wg = threadIdx.x / WG_THREADS;
  hw::init_ring<W16_STAGES>(full, empty);
  if (wg == 2) {
    if (threadIdx.x == CONSUMERS) {
      hw::Ring<W16_STAGES> ring;
      for (int step = it.k0; step < it.k1; ++step) {
        const int bi = step / p.chunks, t0 = step % p.chunks * DEPTH;
        const int s = ring.s;
        uint8_t* a = as + s * BOX;
        uint8_t* b = bs + s * BOX;
        ring.acquire(full, empty, 2 * BOX);
        hw::tma_load3(a, &p.a, &full[s], it.m0, t0, bi);
        hw::tma_load3(a + HALF, &p.a, &full[s], it.m0 + 64, t0, bi);
        hw::tma_load3(b, &p.x[it.tap], &full[s], it.n0, t0, bi);
        hw::tma_load3(b + HALF, &p.x[it.tap], &full[s], it.n0 + 64, t0, bi);
        ring.advance();
      }
    }
    return;
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  hw::fence_regs(acc);
  hw::consume<W16_STAGES>(full, empty, it.k1 - it.k0, [&](int s) {
    const uint8_t* a = as + s * BOX + wg * HALF;
    const uint8_t* b = bs + s * BOX;
#pragma unroll
    for (int kk = 0; kk < DEPTH / 16; ++kk) {
      hw::wgmma_m64n128k16<1, 1>(acc,
                                 hw::desc_sw128(a + kk * 2048, MN_LBO, SBO),
                                 hw::desc_sw128(b + kk * 2048, MN_LBO, SBO));
    }
  });
  hw::fence_regs(acc);
  store_weight(p, it, acc, wg);
}

__global__ void __launch_bounds__(THREADS, 1)
    extractor_wgrad_f32_kernel(const __grid_constant__ WeightArgs p) {
  constexpr int DEPTH = 32;
  constexpr int HI = 2 * BOX;  // A, B (128 rows each)
  extern __shared__ uint8_t smem_raw[];
  // stage s: hi tiles A | B, then their lo halves
  uint8_t* stages = hw::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + W32_STAGES * 2 * HI);
  uint64_t* empty = full + W32_STAGES;
  const WItem it = weight_item(p);
  const int wg = threadIdx.x / WG_THREADS;
  hw::init_ring<W32_STAGES>(full, empty);
  if (wg == 2) {
    hw::setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS) {
      hw::Ring<W32_STAGES> ring;
      for (int step = it.k0; step < it.k1; ++step) {
        const int bi = step / p.chunks, t0 = step % p.chunks * DEPTH;
        const int s = ring.s;
        uint8_t* st = stages + s * 2 * HI;
        ring.acquire(full, empty, HI);
        hw::tma_load3(st, &p.a, &full[s], t0, it.m0, bi);
        hw::tma_load3(st + BOX, &p.x[it.tap], &full[s], t0, it.n0, bi);
        ring.advance();
      }
    }
    return;
  }
  hw::setmaxnreg_inc<232>();
  float acc[64], part[64];  // each stage's products in part
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.0f;
  hw::consume_split<W32_STAGES>(
      full, empty, it.k1 - it.k0,
      [&](int s) {
        uint8_t* st = stages + s * 2 * HI;
        hw::split_tf32(st, st + HI, HI, threadIdx.x, CONSUMERS);
      },
      [&](int s) {
        const uint8_t* hi = stages + s * 2 * HI;
        const uint8_t* lo = hi + HI;
        const int a = wg * HALF;
#pragma unroll
        for (int kk = 0; kk < DEPTH / 8; ++kk) {
          const int o = kk * 32;
          hw::wgmma_tf32x3<TILE>(part, hi + a + o, lo + a + o, hi + BOX + o,
                                 lo + BOX + o, kk == 0);
        }
      },
      [&]() { hw::promote_acc(acc, part); });
  // a wait every consumer thread passes (consume_split's last one is under
  // a branch), so that ptxas injects none in the stores' divergent code
  hw::wgmma_wait<0>();
  hw::fence_regs(part);
  hw::fence_regs(acc);
  store_weight(p, it, acc, wg);
}

// x (b, t_in, c) float32 -> xt (taps, b, c, ldt): xt[j, bi, i, t] =
// x[bi, 2 t + j, i], zero where 2 t + j >= t_in.  A block moves 32 t of
// every tap (66 rows of x: the even rows from 2 t0 to 2 t0 + 64, the odd
// ones between) of 32 channels of one batch row.
__global__ void __launch_bounds__(NT)
    extractor_transpose_kernel(const float* __restrict__ x,
                               float* __restrict__ xt, int b, int t_in, int c,
                               int ldt, int taps) {
  __shared__ float even[33][33], odd[32][33];
  const int ctiles = (c + 31) / 32, ttiles = (ldt + 31) / 32;
  const int ci = blockIdx.x % ctiles, tt = blockIdx.x / ctiles % ttiles;
  const int bi = blockIdx.x / ctiles / ttiles;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int col = ci * 32 + lane;
  for (int r = w; r < 65; r += NT / 32) {
    const int row = tt * 64 + r;
    const float v = (row < t_in && col < c)
                        ? x[((long long)bi * t_in + row) * c + col]
                        : 0.0f;
    if (r % 2) {
      odd[r / 2][lane] = v;
    } else {
      even[r / 2][lane] = v;
    }
  }
  __syncthreads();
  const int t = tt * 32 + lane;
  if (t >= ldt) return;
  for (int r = w; r < taps * 32; r += NT / 32) {
    const int j = r / 32, i = ci * 32 + r % 32;
    if (i >= c) continue;
    const float v = j == 1 ? odd[lane][r % 32] : even[lane + j / 2][r % 32];
    xt[(((long long)j * b + bi) * c + i) * ldt + t] = v;
  }
}

// out[e] = sum over s < n, in order, of in[s * size + e]
__global__ void __launch_bounds__(NT)
    extractor_bwd_reduce_kernel(const float* __restrict__ in,
                                float* __restrict__ out, long long size,
                                int n) {
  const long long e = (long long)blockIdx.x * NT + threadIdx.x;
  if (e >= size) return;
  float s = in[e];
  for (int i = 1; i < n; ++i) s += in[i * size + e];
  out[e] = s;
}

// out[q, col] = sum over rows of in[q, row, col], in a fixed order: warp w of
// block (col / 32, q) adds rows w, w + 8, ... in order, then the eight warps'
// sums are added in warp order
__global__ void __launch_bounds__(NT)
    extractor_colsum_kernel(const float* __restrict__ in,
                            float* __restrict__ out, int rows, int cols) {
  __shared__ float red[NT / 32][32];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + lane, q = blockIdx.y;
  const float* src = in + (long long)q * rows * cols;
  float s = 0.0f;
  if (col < cols) {
    for (int r = w; r < rows; r += NT / 32) s += src[(long long)r * cols + col];
  }
  red[w][lane] = s;
  __syncthreads();
  if (w == 0 && col < cols) {
    float t = 0.0f;
    for (int i = 0; i < NT / 32; ++i) t += red[i][lane];
    out[(long long)q * cols + col] = t;
  }
}

// ------------------------------------------------------------------ host
bool aligned(const void* p, unsigned nbytes) {
  return (reinterpret_cast<uintptr_t>(p) & (nbytes - 1u)) == 0;
}

// the kernels take c a multiple of 8 (x's rows and gz's are whole 16-byte
// words) up to 1024, cpo = 64 for c <= 64, else c rounded up to 128, kp
// = c rounded up to the stage depth, k in {2, 3}
bool bad_geometry(int b, int t_in, int c, int cpo, int kp, int k, bool f32) {
  const int ncol = cpo <= 64 ? 64 : 128;
  const int depth = f32 ? 32 : 64;
  return b <= 0 || c <= 0 || c % 8 != 0 || c > MAX_CLUSTER * 128 ||
         cpo < c || cpo % ncol != 0 || cpo / ncol > MAX_CLUSTER || kp < c ||
         kp % depth != 0 || (k != 2 && k != 3) || t_in < k;
}

bool row_operands(RowOperands* op, const void* w, int k, int cpo, int kp,
                  bool f32) {
  const int ncol = cpo <= 64 ? 64 : 128;
  op->tap_steps = kp / (f32 ? 32 : 64);
  op->cpo = cpo;
  return f32 ? hw::make_map_f32(&op->w, w, (uint64_t)k * cpo, kp, kp, ncol)
             : hw::make_map(&op->w, w, (uint64_t)k * cpo, kp, ncol, 64);
}

template <typename Kernel, typename Args>
int launch_rows(Kernel kernel, const Args& p, long long blocks, size_t smem,
                int cluster, cudaStream_t stream) {
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = reinterpret_cast<const void*>(kernel);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks), 1, 1);
  cfg.blockDim = dim3(TC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  void* args[] = {const_cast<Args*>(&p)};
  err = cudaLaunchKernelExC(&cfg, fn, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NCOL>
int launch_act(const ActArgs& p, int ln, cudaStream_t s) {
  const long long blocks = (long long)p.tiles * p.cluster;
  const size_t smem = row_smem_bytes<T, NCOL>();
  return ln ? launch_rows(extractor_bwd_act_kernel<T, NCOL, true>, p, blocks,
                          smem, p.cluster, s)
            : launch_rows(extractor_bwd_act_kernel<T, NCOL, false>, p, blocks,
                          smem, 1, s);
}

template <typename T, int NCOL>
int launch_data(const DataArgs& p, long long blocks, cudaStream_t s) {
  return launch_rows(extractor_dgrad_kernel<T, NCOL>, p, blocks,
                     row_smem_bytes<T, NCOL>(), 1, s);
}

int colsum(const float* in, float* out, int nq, int rows, int cols,
           cudaStream_t s) {
  extractor_colsum_kernel<<<dim3((cols + 31) / 32, nq), NT, 0, s>>>(
      in, out, rows, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The activation pass.  x (b, t_in, c); wt (k, cpo, kp), K6's layout;
// bias, g, beta (cpo,) float32 zero past c_ln (g, beta with ln); dout, gz
// (b, t_out, c) in x's dtype, gz zero past c_ln.  c_ln is the layer's
// width, over which LayerNorm normalises: c, or less where the caller
// padded the channels up to c with zeros (in x, wt, dout and the vectors).
// gzt: float32 only, null or (b, c, ldt); nq: 0, or 1 (dbias) or 3
// (dbias, dgamma, dbeta) column sums into vec (nq, c) through part (nq,
// b ceil(t_out / 128), c).
extern "C" int smx_conv_bwd_act(const void* x, const void* wt,
                                const float* bias, const float* g,
                                const float* beta, const void* dout, void* gz,
                                float* gzt, float* part, float* vec, int b,
                                int t_in, int c, int c_ln, int cpo, int kp,
                                int k, int ln, float eps, int nq, int ldt,
                                int dtype, int device, void* stream) {
  const bool f32 = dtype == smx::kF32;
  const int t_out = (t_in - k) / 2 + 1;
  if ((dtype != smx::kF32 && dtype != smx::kBF16) ||
      bad_geometry(b, t_in, c, cpo, kp, k, f32) || c_ln > c ||
      c_ln <= c - 8 || (ln && (g == nullptr || beta == nullptr)) ||
      bias == nullptr ||
      (nq != 0 && nq != 1 && nq != 3) || (ln == 0 && nq == 3) ||
      (nq > 0 && (part == nullptr || vec == nullptr)) ||
      (gzt != nullptr && (!f32 || ldt < t_out || ldt % 4 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!aligned(x, 16) || !aligned(wt, 16) || !aligned(bias, 8) ||
      !aligned(dout, 8) || !aligned(gz, 8) ||
      (ln && (!aligned(g, 8) || !aligned(beta, 8)))) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ncol = cpo <= 64 ? 64 : 128;
  const uint32_t elem = f32 ? 4 : 2;
  ActArgs p;
  const uint8_t* xb = static_cast<const uint8_t*>(x);
  for (int j = 0; j < k; ++j) {
    if (!hw::make_map3_strided(&p.op.a[j], xb + (size_t)j * c * elem, b,
                               t_out, c, 2 * (uint64_t)c, (uint64_t)t_in * c,
                               TILE, 128 / elem, elem)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (!row_operands(&p.op, wt, k, cpo, kp, f32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.bias = bias;
  p.g = g;
  p.beta = beta;
  p.dout = dout;
  p.gz = gz;
  p.gzt = gzt;
  p.part = part;
  p.t_out = t_out;
  p.row_tiles = (t_out + TILE - 1) / TILE;
  p.tiles = b * p.row_tiles;
  p.taps = k;
  p.c = c;
  p.c_ln = c_ln;
  p.cluster = cpo / ncol;  // the column blocks of a row tile
  p.nq = nq;
  p.ldt = ldt;
  p.b = b;
  p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (f32) {
    rc = ncol == 64 ? launch_act<float, 64>(p, ln, s)
                    : launch_act<float, 128>(p, ln, s);
  } else {
    rc = ncol == 64 ? launch_act<bf16, 64>(p, ln, s)
                    : launch_act<bf16, 128>(p, ln, s);
  }
  if (rc != 0 || nq == 0) return rc;
  return colsum(part, vec, nq, p.tiles, c, s);
}

// The data gradient.  gz (b, t_out, c) in x's dtype; wd (k, cpo, kp), wd[j,
// i, o] = kernel[o, i, j], zero past c; dx (b, t_in, c), every row written.
extern "C" int smx_conv_bwd_data(const void* gz, const void* wd, void* dx,
                                 int b, int t_in, int c, int cpo, int kp,
                                 int k, int dtype, int device, void* stream) {
  const bool f32 = dtype == smx::kF32;
  if ((dtype != smx::kF32 && dtype != smx::kBF16) ||
      bad_geometry(b, t_in, c, cpo, kp, k, f32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!aligned(gz, 16) || !aligned(wd, 16) || !aligned(dx, 8)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int t_out = (t_in - k) / 2 + 1;
  const int ncol = cpo <= 64 ? 64 : 128;
  const uint32_t elem = f32 ? 4 : 2;
  DataArgs p;
  if (!hw::make_map3_strided(&p.op.a[0], gz, b, t_out, c, c,
                             (uint64_t)t_out * c, TILE, 128 / elem, elem) ||
      !row_operands(&p.op, wd, k, cpo, kp, f32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.dx = dx;
  p.t_in = t_in;
  p.taps = k;
  p.c = c;
  p.row_tiles = ((t_in + 1) / 2 + TILE - 1) / TILE;
  p.col_blocks = cpo / ncol;
  const long long blocks = (long long)b * 2 * p.row_tiles * p.col_blocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32) {
    return ncol == 64 ? launch_data<float, 64>(p, blocks, s)
                      : launch_data<float, 128>(p, blocks, s);
  }
  return ncol == 64 ? launch_data<bf16, 64>(p, blocks, s)
                    : launch_data<bf16, 128>(p, blocks, s);
}

// The weight gradient, out (k, c, c) float32: out[j, o, i] = sum over rows
// of gz[t, o] x[2 t + j, i].  bfloat16: gz (b, t_out, c), xt unused; float32:
// gz is gz^T (b, c, ldt) and xt a (k, b, c, ldt) workspace.  The rows are
// b ceil(t_out / depth) steps (depth 64 bf16, 32 f32), cut into `splits`
// ranges of per_split steps, none empty; ws: splits x (k, c, c) float32
// when splits > 1.
extern "C" int smx_conv_bwd_weight(const void* x, const void* gz, float* xt,
                                   float* ws, float* out, int b, int t_in,
                                   int c, int k, int ldt, int splits,
                                   int per_split, int dtype, int device,
                                   void* stream) {
  const bool f32 = dtype == smx::kF32;
  const int t_out = (t_in - k) / 2 + 1;
  const int depth = f32 ? 32 : 64;
  const int chunks = (t_out + depth - 1) / depth;
  const long long steps = (long long)b * chunks;
  if ((dtype != smx::kF32 && dtype != smx::kBF16) || b <= 0 || c <= 0 ||
      c % 8 != 0 || c > MAX_CLUSTER * 128 || (k != 2 && k != 3) ||
      t_in < k || steps > 2147483647LL || splits < 1 || per_split < 1 ||
      (long long)splits * per_split < steps ||
      (long long)(splits - 1) * per_split >= steps ||
      (splits > 1 && ws == nullptr) ||
      (f32 && (xt == nullptr || ldt < t_out || ldt % 4 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!aligned(x, 16) || !aligned(gz, 16) || !aligned(out, 8) ||
      (f32 && !aligned(xt, 16)) || (splits > 1 && !aligned(ws, 8))) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  WeightArgs p;
  bool mapped = true;
  if (f32) {
    const int ttiles = (ldt + 31) / 32, ctiles = (c + 31) / 32;
    const long long blocks = (long long)b * ttiles * ctiles;
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    extractor_transpose_kernel<<<(unsigned)blocks, NT, 0, s>>>(
        static_cast<const float*>(x), xt, b, t_in, c, ldt, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    mapped = hw::make_map3_strided(&p.a, gz, b, c, t_out, ldt,
                                   (uint64_t)c * ldt, TILE, 32, 4);
    for (int j = 0; j < k && mapped; ++j) {
      mapped = hw::make_map3_strided(&p.x[j], xt + (size_t)j * b * c * ldt,
                                     b, c, t_out, ldt, (uint64_t)c * ldt,
                                     TILE, 32, 4);
    }
  } else {
    mapped = hw::make_map3_strided(&p.a, gz, b, t_out, c, c,
                                   (uint64_t)t_out * c, 64, 64, 2);
    const uint8_t* xb = static_cast<const uint8_t*>(x);
    for (int j = 0; j < k && mapped; ++j) {
      mapped = hw::make_map3_strided(&p.x[j], xb + (size_t)j * c * 2, b,
                                     t_out, c, 2 * (uint64_t)c,
                                     (uint64_t)t_in * c, 64, 64, 2);
    }
  }
  if (!mapped) return static_cast<int>(cudaErrorInvalidValue);
  p.out = splits > 1 ? ws : out;
  p.taps = k;
  p.c = c;
  p.mtiles = (c + TILE - 1) / TILE;
  p.chunks = chunks;
  p.steps = static_cast<int>(steps);
  p.per_split = per_split;
  const long long blocks = (long long)splits * k * p.mtiles * p.mtiles;
  const void* fn =
      f32 ? reinterpret_cast<const void*>(extractor_wgrad_f32_kernel)
          : reinterpret_cast<const void*>(extractor_wgrad_kernel);
  const size_t smem =
      f32 ? 1024 + (size_t)W32_STAGES * 4 * BOX + 2 * W32_STAGES * 8
          : 1024 + (size_t)W16_STAGES * 2 * BOX + 2 * W16_STAGES * 8;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (f32) {
    extractor_wgrad_f32_kernel<<<(unsigned)blocks, THREADS, smem, s>>>(p);
  } else {
    extractor_wgrad_kernel<<<(unsigned)blocks, THREADS, smem, s>>>(p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long size = (long long)k * c * c;
  extractor_bwd_reduce_kernel<<<(unsigned)((size + NT - 1) / NT), NT, 0, s>>>(
      ws, out, size, splits);
  return static_cast<int>(cudaGetLastError());
}
