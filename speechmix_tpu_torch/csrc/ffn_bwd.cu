// K8: ffn_bwd — backward of y = act(x @ w1 + b1) @ w2 + b2 given g = dy.
//
// Replaces the two TPU kernels of speechmix_tpu/ops/pallas/ffn_kernel.py:
// ffn_fused_bwd (:608), _kernel_bwd_dx (:549, pallas_call :631) and
// _kernel_bwd_dw (:574, pallas_call :647).  With a = x @ w1 + b1 (f32),
// h = round(act(a)), dh = g @ w2^T (f32) and da = round(dh * act'(a)),
// round() to x's dtype:
//   dx  = da @ w1^T          (n, h), x's dtype
//   dw1 = x^T @ da           (h, f) float32
//   dw2 = h^T @ g            (f, h) float32
//   db1 = sum_rows da        (f,)   float32
// db2 = sum_rows g stays with the caller, as in the TPU package.  The
// dropout twins are the backward of y = drop_a(act(x @ w1 + b1)) @ w2 + b2,
// the FFN of K12 and K13 (ffn_fwd.cu): they regenerate the activation
// mask m (dropout.cuh, stream 0, at (row, f column)) and take
// h = round(act(a) * m), da = round(dh * act'(a) * m), as the TPU package's
// _ffn_bwd_hand(amask=) does (ffn_kernel.py:700, run in XLA there).
//
// bfloat16, the train step's path (any n; h % 64 == 0 here, the wrapper
// admits h % 128 == 0 as the TPU package's gate does, checked on the card at
// h = 256, 512, 768, 1024 and 1536; f % 64 == 0):
//   smx_ffn_bwd_recompute (smx_ffn_dropout_bwd_recompute with the mask)
//     forms h and da once, as two (n, f) bf16 buffers, and the column sums
//     of da per 128-row tile, an f32 (row tiles, f) workspace.  A block owns
//     a 128 x 128 tile of (n, f); one producer warp keeps TMA loads of x, g
//     (128 rows x 64 of h), w1 (64 x 128) and w2 (128 x 64) three stages
//     ahead; two consumer warpgroups of 64 rows each run wgmma into two f32
//     accumulators (a and dh), then apply b1, act, act', the mask and the
//     roundings in registers.
//   smx_ffn_bwd_products runs the three products as one TMA + wgmma GEMM
//     kernel (128 x 128 output tiles, 64-deep stages, six stages in flight,
//     one producer warp, two consumer warpgroups): dx = da w1^T (both
//     operands K-major), dw1 = x^T da and dw2 = h^T g (both operands read
//     MN-major through the descriptors: no transposed copy).  The row
//     contraction of dw1 and dw2 is cut into `splits` fixed row ranges whose
//     f32 partials are added in split order by a second kernel, and db1 is
//     the ordered sum of the recompute's tile sums: no atomics, so two runs
//     give the same bits.
// float32, the compute dtype users run by default (SpeechMixConfig.dtype,
// the eval command, the train command without --bf16): the same two
// passes, smx_ffn_bwd_recompute_f32 (smx_ffn_dropout_bwd_recompute_f32 with
// the mask) on (128, 64) tiles of (n, f) and smx_ffn_bwd_products_f32, with
// f32-accurate products on the tensor cores: each operand is split into
// tf32 halves in shared memory and each product is hi hi + hi lo + lo hi,
// three tf32 wgmma into one f32 accumulator.  tf32 wgmma reads K-major
// operands only, so the wrapper lays out w1^T, x^T and g^T per call and the
// recompute writes da^T and h^T beside da: dw1 = x^T da and dw2 = h^T g
// contract over rows that are then contiguous.  Any h (the wrapper pads h
// to a multiple of 4; the wrapper admits h <= 2048), f % 16 == 0, any n.
//
// What bounds it on the H100: 10 n h f FLOPs (4 for the recompute, 6 for
// the products) against ~0.5 GB at n = 12800 (bf16; f32 twice the bytes),
// so the tensor cores: h and da are formed once, and every operand load is
// kept off the math warps' path (PERF.md).  In f32 the three tf32 products
// at 495 TFLOP/s make 165 TFLOP/s of f32 work, beyond the CUDA cores' 67;
// what the f32 body adds is the split (a read and two writes of each
// stage's tiles in shared memory, overlapping the stage before's products)
// and the f32 tiles' doubled shared memory, which leaves two stages in
// flight in the recompute and three in the products.

// x, g, dx: (n, h); w1: (h, f); w2: (f, h), row-major; b1: (f,) float32.
// act: 0 gelu (erf), 1 gelu_new (tanh), 2 relu, 3 silu.  The launchers
// refuse anything else.

#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int NT = 256;  // the reduction kernel's threads

// ------------------------------------------------------------------ bfloat16
namespace hw = smx::hopper;
using bf16 = __nv_bfloat16;

using hw::BK;
using hw::BOX;
using hw::CONSUMERS;
using hw::HALF;
using hw::MN_LBO;
using hw::SBO;
using hw::THREADS;
using hw::TILE;
using hw::WG_THREADS;
constexpr int RC_STAGES = 3;           // recompute: 4 tiles (64 KB) a stage
constexpr int GEMM_STAGES = 6;         // products: 2 tiles (32 KB) a stage

// act(x) and act'(x) with the expressions of smx::activate and
// smx::dactivate, their common terms computed once
template <int ACT>
__device__ __forceinline__ void act_dact(float x, float& y, float& dy) {
  if constexpr (ACT == smx::kGelu) {
    const float e = erff(x * 0.70710678118654752f);
    const float pdf = expf(-0.5f * x * x) * 0.39894228040143268f;
    y = 0.5f * x * (1.0f + e);
    dy = 0.5f * (1.0f + e) + x * pdf;
  } else if constexpr (ACT == smx::kGeluTanh) {
    const float c = 0.79788456080286536f;
    const float t = tanhf(c * (x + 0.044715f * x * x * x));
    y = 0.5f * x * (1.0f + t);
    dy = 0.5f * (1.0f + t) +
         0.5f * x * (1.0f - t * t) * c * (1.0f + 3.0f * 0.044715f * x * x);
  } else if constexpr (ACT == smx::kRelu) {
    y = fmaxf(x, 0.0f);
    dy = x > 0.0f ? 1.0f : 0.0f;
  } else {
    const float den = 1.0f + expf(-x);
    const float s = 1.0f / den;
    y = x / den;
    dy = s * (1.0f + x * (1.0f - s));
  }
}

// ------------------------------------------------------- recompute pass
struct RecomputeArgs {
  CUtensorMap x, g;  // (n, h) in (128, 64) boxes
  CUtensorMap w1;    // (h, f) in (64, 64) boxes: MN-major B of a
  CUtensorMap w2;    // (f, h) in (128, 64) boxes: K-major B of dh
  const float* b1;
  bf16* hid;         // (n, f)
  bf16* da;          // (n, f)
  float* colsum;     // (row tiles, f): column sums of da per 128-row tile
  int n, h, f;
  smx::Dropout drop;
};

constexpr size_t rc_smem_bytes() {
  return 1024 + (size_t)RC_STAGES * 4 * BOX + 8 * TILE * sizeof(float) +
         2 * RC_STAGES * sizeof(uint64_t);
}

// The epilogue of one consumer thread: its 2 x 32 elements of the block's
// tile (rows wrow + 8 i, columns n0 + 8 j + 2 (lane % 4) + c).
template <int ACT, bool DROP>
__device__ __forceinline__ void recompute_epilogue(const RecomputeArgs& p,
                                                   float (&acc_a)[64],
                                                   float (&acc_d)[64],
                                                   float* red_w, int wrow,
                                                   int n0, int lane) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int cl = 8 * j + 2 * (lane % 4);
    const int col = n0 + cl;
    const bool col_ok = col < p.f;  // then col + 1 < f: f is even
    float bias[2] = {0.0f, 0.0f};
    if (col_ok) {
      bias[0] = p.b1[col];
      bias[1] = p.b1[col + 1];
    }
    float m[2][2] = {{1.0f, 1.0f}, {1.0f, 1.0f}};
    if constexpr (DROP) smx::accum_mask(p.drop, wrow, col, lane, m);
    float cs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = wrow + 8 * i;
      float hv[2], dv[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float y, dy;
        act_dact<ACT>(acc_a[4 * j + 2 * i + c] + bias[c], y, dy);
        hv[c] = y * m[i][c];
        dv[c] = acc_d[4 * j + 2 * i + c] * dy * m[i][c];
      }
      const __nv_bfloat162 hb = __floats2bfloat162_rn(hv[0], hv[1]);
      const __nv_bfloat162 db = __floats2bfloat162_rn(dv[0], dv[1]);
      if (row < p.n && col_ok) {
        const size_t at = (size_t)row * p.f + col;
        *reinterpret_cast<__nv_bfloat162*>(p.hid + at) = hb;
        *reinterpret_cast<__nv_bfloat162*>(p.da + at) = db;
        cs[0] += __low2float(db);
        cs[1] += __high2float(db);
      }
    }
    // the warp's 16 rows: lanes with one lane % 4 share the columns
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        cs[c] += __shfl_xor_sync(0xffffffffu, cs[c], off);
      }
    }
    if (lane < 4) {
      red_w[cl] = cs[0];
      red_w[cl + 1] = cs[1];
    }
  }
}

template <bool DROP>
__global__ void __launch_bounds__(THREADS, 1)
    recompute_kernel(const __grid_constant__ RecomputeArgs p, int act) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* xs = hw::align1024(smem_raw);       // RC_STAGES x BOX each
  uint8_t* gs = xs + RC_STAGES * BOX;
  uint8_t* w1s = gs + RC_STAGES * BOX;
  uint8_t* w2s = w1s + RC_STAGES * BOX;
  float* red = reinterpret_cast<float*>(w2s + RC_STAGES * BOX);  // (8, TILE)
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 8 * TILE);
  uint64_t* empty = full + RC_STAGES;

  const int ftiles = (p.f + TILE - 1) / TILE;
  const int tm = blockIdx.x / ftiles;
  const int m0 = tm * TILE, n0 = (blockIdx.x % ftiles) * TILE;
  const int ksteps = p.h / BK;
  const int wg = threadIdx.x / WG_THREADS;
  hw::init_ring<RC_STAGES>(full, empty);

  if (wg == 2) {  // producer
    hw::setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS) {
      hw::Ring<RC_STAGES> ring;
      for (int kb = 0; kb < ksteps; ++kb) {
        const int k = kb * BK, s = ring.s;
        ring.acquire(full, empty, 4 * BOX);
        hw::tma_load(xs + s * BOX, &p.x, &full[s], k, m0);
        hw::tma_load(gs + s * BOX, &p.g, &full[s], k, m0);
        hw::tma_load(w1s + s * BOX, &p.w1, &full[s], n0, k);
        hw::tma_load(w1s + s * BOX + HALF, &p.w1, &full[s], n0 + 64, k);
        hw::tma_load(w2s + s * BOX, &p.w2, &full[s], k, n0);
        ring.advance();
      }
    }
  } else {  // consumers: rows m0 + 64 wg .. + 63
    hw::setmaxnreg_inc<232>();
    float acc_a[64], acc_d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc_a[i] = acc_d[i] = 0.0f;
    hw::fence_regs(acc_a);
    hw::fence_regs(acc_d);
    hw::consume<RC_STAGES>(full, empty, ksteps, [&](int s) {
      const uint8_t* xa = xs + s * BOX + wg * HALF;
      const uint8_t* ga = gs + s * BOX + wg * HALF;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        hw::wgmma_m64n128k16<0, 1>(
            acc_a, hw::desc_sw128(xa + kk * 32, 16, SBO),
            hw::desc_sw128(w1s + s * BOX + kk * 2048, MN_LBO, SBO));
        hw::wgmma_m64n128k16<0, 0>(
            acc_d, hw::desc_sw128(ga + kk * 32, 16, SBO),
            hw::desc_sw128(w2s + s * BOX + kk * 32, 16, SBO));
      }
    });
    hw::fence_regs(acc_a);
    hw::fence_regs(acc_d);
    const int t = threadIdx.x % WG_THREADS, warp = t / 32, lane = t % 32;
    const int wrow = m0 + wg * 64 + warp * 16 + lane / 4;
    float* red_w = red + (wg * 4 + warp) * TILE;
    switch (act) {
      case smx::kGelu:
        recompute_epilogue<smx::kGelu, DROP>(p, acc_a, acc_d, red_w, wrow,
                                             n0, lane);
        break;
      case smx::kGeluTanh:
        recompute_epilogue<smx::kGeluTanh, DROP>(p, acc_a, acc_d, red_w,
                                                 wrow, n0, lane);
        break;
      case smx::kRelu:
        recompute_epilogue<smx::kRelu, DROP>(p, acc_a, acc_d, red_w, wrow,
                                             n0, lane);
        break;
      default:
        recompute_epilogue<smx::kSilu, DROP>(p, acc_a, acc_d, red_w, wrow,
                                             n0, lane);
    }
    hw::bar_sync(1, CONSUMERS);
    if (threadIdx.x < TILE && n0 + threadIdx.x < p.f) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < 8; ++w) s += red[w * TILE + threadIdx.x];
      p.colsum[(size_t)tm * p.f + n0 + threadIdx.x] = s;
    }
  }
}

// --------------------------------------------------------- the products
struct ProductsArgs {
  CUtensorMap dx_a, dx_b;  // da (n, f), w1 (h, f) in (128, 64) boxes
  CUtensorMap w1_a, w1_b;  // x (n, h), da (n, f) in (64, 64) boxes
  CUtensorMap w2_a, w2_b;  // hid (n, f), g (n, h) in (64, 64) boxes
  bf16* dx;                // (n, h)
  float* dw;               // splits records of dw1 (h, f) | dw2 (f, h)
  int n, h, f;
  int dx_items;            // row tiles x h tiles
  int dw_tiles;            // (h / 128) x (f / 128) tiles of dw1 and of dw2
  int splits, rows_per_split;
};

constexpr size_t gemm_smem_bytes() {
  return 1024 + (size_t)GEMM_STAGES * 2 * BOX +
         2 * GEMM_STAGES * sizeof(uint64_t);
}

// Work items, in launch order: the dx tiles (row tile major), then the dw1
// tiles of split 0, 1, ..., then the dw2 tiles likewise.
struct Item {
  int mode;  // 0 dx, 1 dw1, 2 dw2
  int m0, n0, k0, k1, split;
  int rows, cols;  // of this item's output matrix
};

template <typename Args>
__device__ __forceinline__ Item decode(const Args& p, int item) {
  Item it;
  const int htiles = (p.h + TILE - 1) / TILE, ftiles = (p.f + TILE - 1) / TILE;
  if (item < p.dx_items) {
    it.mode = 0;
    it.m0 = item / htiles * TILE;
    it.n0 = item % htiles * TILE;
    it.k0 = 0;
    it.k1 = p.f;
    it.split = 0;
    it.rows = p.n;
    it.cols = p.h;
    return it;
  }
  item -= p.dx_items;
  const int per_product = p.splits * p.dw_tiles;
  const int t = item % per_product % p.dw_tiles;
  it.mode = 1 + item / per_product;
  it.split = item % per_product / p.dw_tiles;
  it.k0 = it.split * p.rows_per_split;
  it.k1 = min(p.n, it.k0 + p.rows_per_split);
  if (it.mode == 1) {  // dw1 = x^T da: (h, f)
    it.m0 = t / ftiles * TILE;
    it.n0 = t % ftiles * TILE;
    it.rows = p.h;
    it.cols = p.f;
  } else {  // dw2 = hid^T g: (f, h)
    it.m0 = t / htiles * TILE;
    it.n0 = t % htiles * TILE;
    it.rows = p.f;
    it.cols = p.h;
  }
  return it;
}

__global__ void __launch_bounds__(THREADS, 1)
    products_kernel(const __grid_constant__ ProductsArgs p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* as = hw::align1024(smem_raw);       // GEMM_STAGES x BOX
  uint8_t* bs = as + GEMM_STAGES * BOX;    // GEMM_STAGES x BOX
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + GEMM_STAGES * BOX);
  uint64_t* empty = full + GEMM_STAGES;

  const Item it = decode(p, blockIdx.x);
  const bool mn = it.mode != 0;
  const int ksteps = (it.k1 - it.k0 + BK - 1) / BK;
  const int wg = threadIdx.x / WG_THREADS;
  hw::init_ring<GEMM_STAGES>(full, empty);

  if (wg == 2) {  // producer
    if (threadIdx.x == CONSUMERS) {
      const CUtensorMap* ma = it.mode == 0 ? &p.dx_a
                              : it.mode == 1 ? &p.w1_a : &p.w2_a;
      const CUtensorMap* mb = it.mode == 0 ? &p.dx_b
                              : it.mode == 1 ? &p.w1_b : &p.w2_b;
      hw::Ring<GEMM_STAGES> ring;
      for (int kb = 0; kb < ksteps; ++kb) {
        const int k = it.k0 + kb * BK, s = ring.s;
        uint8_t* a = as + s * BOX;
        uint8_t* b = bs + s * BOX;
        ring.acquire(full, empty, 2 * BOX);
        if (!mn) {
          hw::tma_load(a, ma, &full[s], k, it.m0);
          hw::tma_load(b, mb, &full[s], k, it.n0);
        } else {
          hw::tma_load(a, ma, &full[s], it.m0, k);
          hw::tma_load(a + HALF, ma, &full[s], it.m0 + 64, k);
          hw::tma_load(b, mb, &full[s], it.n0, k);
          hw::tma_load(b + HALF, mb, &full[s], it.n0 + 64, k);
        }
        ring.advance();
      }
    }
    return;
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  hw::fence_regs(acc);
  if (!mn) {
    hw::consume<GEMM_STAGES>(full, empty, ksteps, [&](int s) {
      const uint8_t* a = as + s * BOX + wg * HALF;
      const uint8_t* b = bs + s * BOX;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        hw::wgmma_m64n128k16<0, 0>(acc, hw::desc_sw128(a + kk * 32, 16, SBO),
                                   hw::desc_sw128(b + kk * 32, 16, SBO));
      }
    });
  } else {
    hw::consume<GEMM_STAGES>(full, empty, ksteps, [&](int s) {
      const uint8_t* a = as + s * BOX + wg * HALF;
      const uint8_t* b = bs + s * BOX;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        hw::wgmma_m64n128k16<1, 1>(
            acc, hw::desc_sw128(a + kk * 2048, MN_LBO, SBO),
            hw::desc_sw128(b + kk * 2048, MN_LBO, SBO));
      }
    });
  }
  hw::fence_regs(acc);
  const int t = threadIdx.x % WG_THREADS, warp = t / 32, lane = t % 32;
  const int wrow = it.m0 + wg * 64 + warp * 16 + lane / 4;
  float* dw = nullptr;
  if (mn) {
    dw = p.dw + (size_t)it.split * 2 * p.h * p.f +
         (it.mode == 2 ? (size_t)p.h * p.f : 0);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = it.n0 + 8 * j + 2 * (lane % 4);
    if (col >= it.cols) continue;  // then col + 1 < cols: cols is even
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = wrow + 8 * i;
      if (row >= it.rows) continue;
      const float v0 = acc[4 * j + 2 * i], v1 = acc[4 * j + 2 * i + 1];
      const size_t at = (size_t)row * it.cols + col;
      if (mn) {
        *reinterpret_cast<float2*>(dw + at) = make_float2(v0, v1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(p.dx + at) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

int bad_bf16_shape(int n, int h, int f) {
  return n <= 0 || h <= 0 || f <= 0 || h % BK != 0 || f % BK != 0;
}

template <bool DROP>
int recompute(const void* x, const void* g, const void* w1, const float* b1,
              const void* w2, void* hid, void* da, float* colsum, int n,
              int h, int f, int act, smx::Dropout drop, int device,
              void* stream) {
  if (bad_bf16_shape(n, h, f) || act < 0 || act > 3 ||
      !aligned(x, 16) || !aligned(g, 16) || !aligned(w1, 16) ||
      !aligned(w2, 16) || !aligned(hid, 16) || !aligned(da, 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  RecomputeArgs p;
  if (!hw::make_map(&p.x, x, n, h, TILE, BK) ||
      !hw::make_map(&p.g, g, n, h, TILE, BK) ||
      !hw::make_map(&p.w1, w1, h, f, BK, BK) ||
      !hw::make_map(&p.w2, w2, f, h, TILE, BK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.b1 = b1;
  p.hid = static_cast<bf16*>(hid);
  p.da = static_cast<bf16*>(da);
  p.colsum = colsum;
  p.n = n;
  p.h = h;
  p.f = f;
  p.drop = drop;
  const size_t smem = rc_smem_bytes();
  err = cudaFuncSetAttribute(recompute_kernel<DROP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = ((n + TILE - 1) / TILE) * ((f + TILE - 1) / TILE);
  recompute_kernel<DROP><<<blocks, THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(p, act);
  return static_cast<int>(cudaGetLastError());
}

// out[i] = sum over splits, in split order, of ws[s * size + i]
__global__ void __launch_bounds__(NT)
    ffn_bwd_reduce_kernel(const float* __restrict__ ws, float* __restrict__ out,
                          long long size, int splits) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  if (i >= size) return;
  float s = ws[i];
  for (int p = 1; p < splits; ++p) s += ws[p * size + i];
  out[i] = s;
}

int reduce(const float* ws, float* out, long long size, int splits,
           cudaStream_t s) {
  ffn_bwd_reduce_kernel<<<(unsigned)((size + NT - 1) / NT), NT, 0, s>>>(
      ws, out, size, splits);
  return static_cast<int>(cudaGetLastError());
}

// The row plan of dw1 / dw2: `splits` ranges of rows_per_split rows (a
// multiple of BK) that cover the n rows, none empty.
bool bad_plan(int n, int splits, int rows_per_split) {
  return splits < 1 || rows_per_split <= 0 || rows_per_split % BK != 0 ||
         (long long)splits * rows_per_split < n ||
         (long long)(splits - 1) * rows_per_split >= n;
}

int products(const void* x, const void* g, const void* w1, const void* hid,
             const void* da, const float* colsum, void* dx, float* out,
             float* ws, int n, int h, int f, int splits, int rows_per_split,
             int device, void* stream) {
  if (bad_bf16_shape(n, h, f) || bad_plan(n, splits, rows_per_split) ||
      colsum == nullptr || dx == nullptr || out == nullptr ||
      !aligned(x, 16) || !aligned(g, 16) ||
      !aligned(w1, 16) || !aligned(hid, 16) || !aligned(da, 16) ||
      !aligned(dx, 16) || !aligned(out, 16) ||
      (splits > 1 && (ws == nullptr || !aligned(ws, 16)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ProductsArgs p;
  if (!hw::make_map(&p.dx_a, da, n, f, TILE, BK) ||
      !hw::make_map(&p.dx_b, w1, h, f, TILE, BK) ||
      !hw::make_map(&p.w1_a, x, n, h, BK, BK) ||
      !hw::make_map(&p.w1_b, da, n, f, BK, BK) ||
      !hw::make_map(&p.w2_a, hid, n, f, BK, BK) ||
      !hw::make_map(&p.w2_b, g, n, h, BK, BK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int htiles = (h + TILE - 1) / TILE, ftiles = (f + TILE - 1) / TILE;
  p.dx = static_cast<bf16*>(dx);
  p.dw = splits > 1 ? ws : out;
  p.n = n;
  p.h = h;
  p.f = f;
  p.dx_items = ((n + TILE - 1) / TILE) * htiles;
  p.dw_tiles = htiles * ftiles;
  p.splits = splits;
  p.rows_per_split = rows_per_split;
  const size_t smem = gemm_smem_bytes();
  err = cudaFuncSetAttribute(products_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = p.dx_items + 2LL * splits * p.dw_tiles;
  products_kernel<<<(unsigned)items, THREADS, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long size = 2LL * h * f;
  if (splits > 1) {
    const int rc = reduce(ws, out, size, splits, s);
    if (rc != 0) return rc;
  }
  // db1: the recompute's per-tile column sums, added in tile order
  return reduce(colsum, out + size, f, (n + TILE - 1) / TILE, s);
}

// ------------------------------------------------------------------ float32
// The bf16 structure on f32 operands: every product is hi hi + hi lo + lo hi
// of tf32 halves (hopper.cuh: split_tf32, wgmma_tf32x3), the split made in
// shared memory by the consumers as each stage lands.  tf32 wgmma takes
// K-major operands only, so the recompute reads w1^T (f, h) and the
// products read x^T, g^T (h, n) and the recompute's da^T and h^T (f, n), all
// with rows `ldt` apart (n rounded up to 8: 16-byte TMA strides, 32-byte
// rows for the transposed stores), beside da (n, f) for dx.
constexpr int FBK = 32;                     // f32 elements in a 128-byte row
constexpr int RC32_N = 64;                  // recompute tiles: 128 x 64 of (n, f)
constexpr int RC32_STAGES = 2;
constexpr int RC32_HI = 2 * BOX + 2 * HALF;  // x, g (128 rows), w1^T, w2 (64)
constexpr int GEMM32_STAGES = 3;
constexpr int GEMM32_HI = 2 * BOX;           // A, B (128 rows each)

struct RecomputeF32Args {
  CUtensorMap x, g;  // (n, h) in (128, 32) boxes
  CUtensorMap w1t;   // w1^T (f, h) in (64, 32) boxes
  CUtensorMap w2;    // (f, h) in (64, 32) boxes
  const float* b1;
  float* da;         // (n, f)
  float* da_t;       // (f, ldt)
  float* hid_t;      // (f, ldt)
  float* colsum;     // (row tiles, f): column sums of da per 128-row tile
  int n, h, f, ldt;
  smx::Dropout drop;
};

constexpr size_t rc32_smem_bytes() {
  return 1024 + (size_t)RC32_STAGES * 2 * RC32_HI +
         8 * RC32_N * sizeof(float) + 2 * RC32_STAGES * sizeof(uint64_t);
}

// one consumer thread's 2 x 16 elements of the block's (128, 64) tile: rows
// wrow + 8 i, columns n0 + 8 j + 2 (lane % 4) + c; da by rows, da^T and
// h^T by columns (each store of a warp fills four 32-byte sectors)
template <int ACT, bool DROP>
__device__ __forceinline__ void recompute_f32_epilogue(
    const RecomputeF32Args& p, float (&acc_a)[32], float (&acc_d)[32],
    float* red_w, int wrow, int n0, int lane) {
#pragma unroll
  for (int j = 0; j < RC32_N / 8; ++j) {
    const int cl = 8 * j + 2 * (lane % 4);
    const int col = n0 + cl;
    const bool col_ok = col < p.f;  // then col + 1 < f: f is even
    float bias[2] = {0.0f, 0.0f};
    if (col_ok) {
      bias[0] = p.b1[col];
      bias[1] = p.b1[col + 1];
    }
    float m[2][2] = {{1.0f, 1.0f}, {1.0f, 1.0f}};
    if constexpr (DROP) smx::accum_mask(p.drop, wrow, col, lane, m);
    float cs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = wrow + 8 * i;
      float hv[2], dv[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float y, dy;
        act_dact<ACT>(acc_a[4 * j + 2 * i + c] + bias[c], y, dy);
        hv[c] = y * m[i][c];
        dv[c] = acc_d[4 * j + 2 * i + c] * dy * m[i][c];
      }
      if (row < p.n && col_ok) {
        *reinterpret_cast<float2*>(p.da + (size_t)row * p.f + col) =
            make_float2(dv[0], dv[1]);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const size_t at = (size_t)(col + c) * p.ldt + row;
          p.da_t[at] = dv[c];
          p.hid_t[at] = hv[c];
          cs[c] += dv[c];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        cs[c] += __shfl_xor_sync(0xffffffffu, cs[c], off);
      }
    }
    if (lane < 4) {
      red_w[cl] = cs[0];
      red_w[cl + 1] = cs[1];
    }
  }
}

// A block owns a (128, 64) tile of (n, f): a = x w1 and dh = g w2^T over
// h in 32-deep stages, two stages in flight (each 48 KB of f32 tiles and
// 48 KB of their lo halves).
template <bool DROP>
__global__ void __launch_bounds__(THREADS, 1)
    recompute_f32_kernel(const __grid_constant__ RecomputeF32Args p,
                         int act) {
  extern __shared__ uint8_t smem_raw[];
  // stage s: hi tiles x | g | w1^T | w2, then their lo halves
  uint8_t* stages = hw::align1024(smem_raw);
  float* red = reinterpret_cast<float*>(stages + RC32_STAGES * 2 * RC32_HI);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 8 * RC32_N);
  uint64_t* empty = full + RC32_STAGES;

  const int ftiles = (p.f + RC32_N - 1) / RC32_N;
  const int tm = blockIdx.x / ftiles;
  const int m0 = tm * TILE, n0 = (blockIdx.x % ftiles) * RC32_N;
  const int ksteps = (p.h + FBK - 1) / FBK;
  const int wg = threadIdx.x / WG_THREADS;
  hw::init_ring<RC32_STAGES>(full, empty);

  if (wg == 2) {  // producer
    hw::setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS) {
      hw::Ring<RC32_STAGES> ring;
      for (int kb = 0; kb < ksteps; ++kb) {
        const int k = kb * FBK, s = ring.s;
        uint8_t* st = stages + s * 2 * RC32_HI;
        ring.acquire(full, empty, RC32_HI);
        hw::tma_load(st, &p.x, &full[s], k, m0);
        hw::tma_load(st + BOX, &p.g, &full[s], k, m0);
        hw::tma_load(st + 2 * BOX, &p.w1t, &full[s], k, n0);
        hw::tma_load(st + 2 * BOX + HALF, &p.w2, &full[s], k, n0);
        ring.advance();
      }
    }
  } else {  // consumers: rows m0 + 64 wg .. + 63
    hw::setmaxnreg_inc<232>();
    // a = x w1 and dh = g w2^T; each stage's products in the partials
    float acc_a[32], acc_d[32], part_a[32], part_d[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc_a[i] = acc_d[i] = part_a[i] = part_d[i] = 0.0f;
    }
    hw::consume_split<RC32_STAGES>(
        full, empty, ksteps,
        [&](int s) {
          uint8_t* st = stages + s * 2 * RC32_HI;
          hw::split_tf32(st, st + RC32_HI, RC32_HI, threadIdx.x, CONSUMERS);
        },
        [&](int s) {
          const uint8_t* hi = stages + s * 2 * RC32_HI;
          const uint8_t* lo = hi + RC32_HI;
          const int xa = wg * HALF, ga = BOX + wg * HALF;
          const int w1b = 2 * BOX, w2b = 2 * BOX + HALF;
#pragma unroll
          for (int kk = 0; kk < FBK / 8; ++kk) {
            const int o = kk * 32;
            hw::wgmma_tf32x3<RC32_N>(part_a, hi + xa + o, lo + xa + o,
                                     hi + w1b + o, lo + w1b + o, kk == 0);
            hw::wgmma_tf32x3<RC32_N>(part_d, hi + ga + o, lo + ga + o,
                                     hi + w2b + o, lo + w2b + o, kk == 0);
          }
        },
        [&]() {
          hw::promote_acc(acc_a, part_a);
          hw::promote_acc(acc_d, part_d);
        });
    const int t = threadIdx.x % WG_THREADS, warp = t / 32, lane = t % 32;
    const int wrow = m0 + wg * 64 + warp * 16 + lane / 4;
    float* red_w = red + (wg * 4 + warp) * RC32_N;
    switch (act) {
      case smx::kGelu:
        recompute_f32_epilogue<smx::kGelu, DROP>(p, acc_a, acc_d, red_w,
                                                 wrow, n0, lane);
        break;
      case smx::kGeluTanh:
        recompute_f32_epilogue<smx::kGeluTanh, DROP>(p, acc_a, acc_d, red_w,
                                                     wrow, n0, lane);
        break;
      case smx::kRelu:
        recompute_f32_epilogue<smx::kRelu, DROP>(p, acc_a, acc_d, red_w,
                                                 wrow, n0, lane);
        break;
      default:
        recompute_f32_epilogue<smx::kSilu, DROP>(p, acc_a, acc_d, red_w,
                                                 wrow, n0, lane);
    }
    hw::bar_sync(1, CONSUMERS);
    if (threadIdx.x < RC32_N && n0 + threadIdx.x < p.f) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < 8; ++w) s += red[w * RC32_N + threadIdx.x];
      p.colsum[(size_t)tm * p.f + n0 + threadIdx.x] = s;
    }
  }
}

struct ProductsF32Args {
  CUtensorMap dx_a, dx_b;  // da (n, f), w1 (h, f): K = f
  CUtensorMap w1_a, w1_b;  // x^T (h, n), da^T (f, n): K = n
  CUtensorMap w2_a, w2_b;  // h^T (f, n), g^T (h, n): K = n
  float* dx;               // (n, h)
  float* dw;               // splits records of dw1 (h, f) | dw2 (f, h)
  int n, h, f;
  int dx_items, dw_tiles, splits, rows_per_split;
};

constexpr size_t gemm32_smem_bytes() {
  return 1024 + (size_t)GEMM32_STAGES * 2 * GEMM32_HI +
         2 * GEMM32_STAGES * sizeof(uint64_t);
}

// The three products of decode()'s items, every operand K-major: a
// (128, 128) output tile, 32-deep stages, three in flight (each 32 KB of f32
// tiles and 32 KB of their lo halves).
__global__ void __launch_bounds__(THREADS, 1)
    products_f32_kernel(const __grid_constant__ ProductsF32Args p) {
  extern __shared__ uint8_t smem_raw[];
  // stage s: hi tiles A | B, then their lo halves
  uint8_t* stages = hw::align1024(smem_raw);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(stages + GEMM32_STAGES * 2 * GEMM32_HI);
  uint64_t* empty = full + GEMM32_STAGES;

  const Item it = decode(p, blockIdx.x);
  const int ksteps = (it.k1 - it.k0 + FBK - 1) / FBK;
  const int wg = threadIdx.x / WG_THREADS;
  hw::init_ring<GEMM32_STAGES>(full, empty);

  if (wg == 2) {  // producer
    hw::setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS) {
      const CUtensorMap* ma = it.mode == 0 ? &p.dx_a
                              : it.mode == 1 ? &p.w1_a : &p.w2_a;
      const CUtensorMap* mb = it.mode == 0 ? &p.dx_b
                              : it.mode == 1 ? &p.w1_b : &p.w2_b;
      hw::Ring<GEMM32_STAGES> ring;
      for (int kb = 0; kb < ksteps; ++kb) {
        const int k = it.k0 + kb * FBK, s = ring.s;
        uint8_t* st = stages + s * 2 * GEMM32_HI;
        ring.acquire(full, empty, GEMM32_HI);
        hw::tma_load(st, ma, &full[s], k, it.m0);
        hw::tma_load(st + BOX, mb, &full[s], k, it.n0);
        ring.advance();
      }
    }
    return;
  }
  hw::setmaxnreg_inc<232>();
  float acc[64], part[64];  // each stage's products in part
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.0f;
  hw::consume_split<GEMM32_STAGES>(
      full, empty, ksteps,
      [&](int s) {
        uint8_t* st = stages + s * 2 * GEMM32_HI;
        hw::split_tf32(st, st + GEMM32_HI, GEMM32_HI, threadIdx.x, CONSUMERS);
      },
      [&](int s) {
        const uint8_t* hi = stages + s * 2 * GEMM32_HI;
        const uint8_t* lo = hi + GEMM32_HI;
        const int a = wg * HALF;
#pragma unroll
        for (int kk = 0; kk < FBK / 8; ++kk) {
          const int o = kk * 32;
          hw::wgmma_tf32x3<TILE>(part, hi + a + o, lo + a + o, hi + BOX + o,
                                 lo + BOX + o, kk == 0);
        }
      },
      [&]() { hw::promote_acc(acc, part); });
  const int t = threadIdx.x % WG_THREADS, warp = t / 32, lane = t % 32;
  const int wrow = it.m0 + wg * 64 + warp * 16 + lane / 4;
  float* out = p.dx;
  if (it.mode != 0) {
    out = p.dw + (size_t)it.split * 2 * p.h * p.f +
          (it.mode == 2 ? (size_t)p.h * p.f : 0);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = it.n0 + 8 * j + 2 * (lane % 4);
    if (col >= it.cols) continue;  // then col + 1 < cols: cols is even
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = wrow + 8 * i;
      if (row >= it.rows) continue;
      *reinterpret_cast<float2*>(out + (size_t)row * it.cols + col) =
          make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  }
}

// f32 widths: h a multiple of 4 (16-byte TMA strides; the wrapper pads
// others with zero columns), f a multiple of 16, ldt >= n a multiple of 8
int bad_f32_shape(int n, int h, int f, int ldt) {
  return n <= 0 || h <= 0 || f <= 0 || h % 4 != 0 || f % 16 != 0 ||
         ldt < n || ldt % 8 != 0;
}

template <bool DROP>
int recompute_f32(const void* x, const void* g, const void* w1t,
                  const float* b1, const void* w2, float* da, float* da_t,
                  float* hid_t, float* colsum, int n, int h, int f, int ldt,
                  int act, smx::Dropout drop, int device, void* stream) {
  if (bad_f32_shape(n, h, f, ldt) || act < 0 || act > 3 ||
      !aligned(x, 16) || !aligned(g, 16) || !aligned(w1t, 16) ||
      !aligned(w2, 16) || !aligned(da, 16) || !aligned(da_t, 16) ||
      !aligned(hid_t, 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  RecomputeF32Args p;
  if (!hw::make_map_f32(&p.x, x, n, h, h, TILE) ||
      !hw::make_map_f32(&p.g, g, n, h, h, TILE) ||
      !hw::make_map_f32(&p.w1t, w1t, f, h, h, RC32_N) ||
      !hw::make_map_f32(&p.w2, w2, f, h, h, RC32_N)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.b1 = b1;
  p.da = da;
  p.da_t = da_t;
  p.hid_t = hid_t;
  p.colsum = colsum;
  p.n = n;
  p.h = h;
  p.f = f;
  p.ldt = ldt;
  p.drop = drop;
  const size_t smem = rc32_smem_bytes();
  err = cudaFuncSetAttribute(recompute_f32_kernel<DROP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = ((n + TILE - 1) / TILE) * ((f + RC32_N - 1) / RC32_N);
  recompute_f32_kernel<DROP><<<blocks, THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(p, act);
  return static_cast<int>(cudaGetLastError());
}

int products_f32(const void* xt, const void* gt, const void* w1,
                 const void* hid_t, const void* da, const void* da_t,
                 const float* colsum, float* dx, float* out, float* ws, int n,
                 int h, int f, int ldt, int splits, int rows_per_split,
                 int device, void* stream) {
  if (bad_f32_shape(n, h, f, ldt) || bad_plan(n, splits, rows_per_split) ||
      colsum == nullptr || dx == nullptr || out == nullptr ||
      !aligned(xt, 16) || !aligned(gt, 16) || !aligned(w1, 16) ||
      !aligned(hid_t, 16) || !aligned(da, 16) || !aligned(da_t, 16) ||
      !aligned(dx, 16) || !aligned(out, 16) ||
      (splits > 1 && (ws == nullptr || !aligned(ws, 16)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ProductsF32Args p;
  if (!hw::make_map_f32(&p.dx_a, da, n, f, f, TILE) ||
      !hw::make_map_f32(&p.dx_b, w1, h, f, f, TILE) ||
      !hw::make_map_f32(&p.w1_a, xt, h, n, ldt, TILE) ||
      !hw::make_map_f32(&p.w1_b, da_t, f, n, ldt, TILE) ||
      !hw::make_map_f32(&p.w2_a, hid_t, f, n, ldt, TILE) ||
      !hw::make_map_f32(&p.w2_b, gt, h, n, ldt, TILE)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int htiles = (h + TILE - 1) / TILE, ftiles = (f + TILE - 1) / TILE;
  p.dx = dx;
  p.dw = splits > 1 ? ws : out;
  p.n = n;
  p.h = h;
  p.f = f;
  p.dx_items = ((n + TILE - 1) / TILE) * htiles;
  p.dw_tiles = htiles * ftiles;
  p.splits = splits;
  p.rows_per_split = rows_per_split;
  const size_t smem = gemm32_smem_bytes();
  err = cudaFuncSetAttribute(products_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = p.dx_items + 2LL * splits * p.dw_tiles;
  products_f32_kernel<<<(unsigned)items, THREADS, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long size = 2LL * h * f;
  if (splits > 1) {
    const int rc = reduce(ws, out, size, splits, s);
    if (rc != 0) return rc;
  }
  return reduce(colsum, out + size, f, (n + TILE - 1) / TILE, s);
}
}  // namespace

// float32: x, g (n, h), w1t = w1^T (f, h), w2 (f, h); da (n, f); da_t,
// hid_t (f, ldt); colsum (ceil(n / 128), f)
extern "C" int smx_ffn_bwd_recompute_f32(const void* x, const void* g,
                                         const void* w1t, const float* b1,
                                         const void* w2, float* da,
                                         float* da_t, float* hid_t,
                                         float* colsum, int n, int h, int f,
                                         int ldt, int act, int device,
                                         void* stream) {
  return recompute_f32<false>(x, g, w1t, b1, w2, da, da_t, hid_t, colsum, n,
                              h, f, ldt, act, smx::Dropout{}, device, stream);
}

// The dropout twin: k0, k1 the site's key, threshold and scale of the
// activation mask (stream 0), from the host.
extern "C" int smx_ffn_dropout_bwd_recompute_f32(
    const void* x, const void* g, const void* w1t, const float* b1,
    const void* w2, float* da, float* da_t, float* hid_t, float* colsum,
    int n, int h, int f, int ldt, int act, uint32_t k0, uint32_t k1,
    uint32_t threshold, float scale, int device, void* stream) {
  return recompute_f32<true>(
      x, g, w1t, b1, w2, da, da_t, hid_t, colsum, n, h, f, ldt, act,
      smx::make_dropout(k0, k1, smx::kStreamAct, threshold, scale), device,
      stream);
}

// xt = x^T, gt = g^T (h, ldt); w1 (h, f); dx (n, h); out (2 h f + f) =
// dw1 | dw2 | db1; ws: splits * 2 h f when splits > 1
extern "C" int smx_ffn_bwd_products_f32(
    const void* xt, const void* gt, const void* w1, const void* hid_t,
    const void* da, const void* da_t, const float* colsum, float* dx,
    float* out, float* ws, int n, int h, int f, int ldt, int splits,
    int rows_per_split, int device, void* stream) {
  return products_f32(xt, gt, w1, hid_t, da, da_t, colsum, dx, out, ws, n, h,
                      f, ldt, splits, rows_per_split, device, stream);
}

// bfloat16.  hid, da: (n, f) bf16; colsum: (ceil(n / 128), f) float32.
extern "C" int smx_ffn_bwd_recompute(const void* x, const void* g,
                                     const void* w1, const float* b1,
                                     const void* w2, void* hid, void* da,
                                     float* colsum, int n, int h, int f,
                                     int act, int device, void* stream) {
  return recompute<false>(x, g, w1, b1, w2, hid, da, colsum, n, h, f, act,
                          smx::Dropout{}, device, stream);
}

extern "C" int smx_ffn_dropout_bwd_recompute(
    const void* x, const void* g, const void* w1, const float* b1,
    const void* w2, void* hid, void* da, float* colsum, int n, int h, int f,
    int act, uint32_t k0, uint32_t k1, uint32_t threshold, float scale,
    int device, void* stream) {
  return recompute<true>(
      x, g, w1, b1, w2, hid, da, colsum, n, h, f, act,
      smx::make_dropout(k0, k1, smx::kStreamAct, threshold, scale), device,
      stream);
}

// dx (n, h) bf16; out (2 h f + f) float32 = dw1 | dw2 | db1; ws: splits *
// 2 h f float32 when splits > 1.
extern "C" int smx_ffn_bwd_products(const void* x, const void* g,
                                    const void* w1, const void* hid,
                                    const void* da, const float* colsum,
                                    void* dx, float* out, float* ws, int n,
                                    int h, int f, int splits,
                                    int rows_per_split, int device,
                                    void* stream) {
  return products(x, g, w1, hid, da, colsum, dx, out, ws, n, h, f, splits,
                  rows_per_split, device, stream);
}
