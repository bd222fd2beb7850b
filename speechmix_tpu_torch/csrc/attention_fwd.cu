// K1: attention_fwd — masked multi-head attention forward,
//   out = softmax(q k^T * scale + mask) v,  per (batch, head),
// on the (B, T, H*D) projection slabs, any head width D that is a multiple
// of 8 with 8 <= D <= 128 (entry smx_attention_fwd), and
// K14: attention_dropout_fwd — the same with attention-probability dropout,
//   out = (softmax(q k^T * scale + mask) * m) v,  m in {0, 1 / (1 - rate)}
// (entry smx_attention_dropout_fwd).  K14 replaces the TPU kernels of
// flash_attention_kernel.py: _flash_dropout_fwd_tpu (_attn_dropout_fused_kernel
// and _attn_single_dropout_kernel).  As there, each tile's unnormalised
// probabilities are multiplied by the mask before P . v, while the running
// row sum and the log-sum-exp stay undropped.  The mask is drawn in the
// kernel from dropout.cuh (stream 0, row (b * H + h) * Tq + q, column k), so
// K15 (attention_bwd.cu) regenerates it per tile; it never reaches device
// memory.  In the bf16 kernel the two lanes of a pair (t4, t4 ^ 1), which
// hold the same four keys of rows r and r + 8 of the accumulator, each draw
// one row's four words and swap the halves the other needs (accum_mask's
// pairing): one Philox call per four probabilities, drawn after the
// tile's softmax while the previous tile's P v runs (drawn before it, as
// keep bits while both products run, was slower; PERF.md).  There is no
// length limit (the TPU kernels hold whole rows and stop at T = 1024).
//
// Replaces the TPU kernel speechmix_tpu/ops/pallas/flash_attention_kernel.py:
// flash_attention_fused_layout (_attn_single_fused_kernel), and covers the
// same function's other layouts and lengths in that file:
// flash_attention_masked's (B*H, T, D) single-pass kernel
// (_attn_single_kernel), flash_attention_multihead (_attn_single_mh_kernel)
// and the tiled online-softmax kernel for T > 1024 (_flash_kernel).
//
// q: (B, Tq, H*D), k, v: (B, Tk, H*D), out: (B, Tq, H*D), float32 or
// bfloat16 (bfloat16 q / k / v 16-byte aligned); mask: (B, Tk) bool
// (1 = key valid); causal: key j is excluded for query i when j > i.
// Excluded logits are -1e30 (the TPU kernel's NEG_INF), not -inf, so a fully
// masked row gives a finite average over all Tk keys, never NaN.
// lse: optional (B, H, Tq) float32 output, the row log-sum-exp of the masked,
// scaled logits (max + log denominator), which attention_bwd.cu reads to
// recompute the probabilities; null skips it.
//
// What bounds it on the H100: at the flagship speech shape (B = 16,
// T = 800, H = 12) the two products are 4*B*H*T*T*D ~ 31 GFLOP against
// ~60 MB of q/k/v/out traffic, so the tensor cores are the limit
// (~0.03 ms); beside them, on the CUDA cores and the special-function unit,
// the online softmax: one exp and ~8 other operations per score (B*H*T*T,
// 123 M), and for K14 one Philox-4x32-10 call per four scores, which costs
// more than the softmax (PERF.md has the times).
// Each dtype has one kernel: float32 inputs (the f32 path, the default dtype) take
// an f32-FMA kernel, bound by those FMAs.
//
// Head widths.  Both kernels are built for a padded width DP, 64 or 128
// (the smallest that holds D), and D = 64 runs the body it always ran.
// Other widths compute over DP columns of which those past D are zeros:
// the f32 kernel loads zeros there, the bf16 kernel reads each head
// through a 4-D tensor map with the head as its own dimension
// (hopper.cuh: make_map_heads), so TMA fills the columns past D with zeros
// instead of reading the next head's.  Only D columns are stored.  At
// DP = 128 an operand tile is two 64-column boxes (one 128-byte swizzle
// row each): S = q k^T takes eight k16 slices, four from each box, and
// O += P v is two m64n64 products, one per box of v, into 64 f32
// registers; the ring holds 2 stages, and two blocks share an SM.  Padding
// D = 16 to 64 or D = 80 to 128 wastes that share of the products: a
// simple body that is right.
//
// float32 kernel: one block of 256 threads per (64-query tile, head,
// batch).  Heads are read straight from the slabs by stride, so no head
// transpose.  The block keeps its q tile in shared memory and loops over
// 64-key tiles with an online softmax: running max, denominator and a
// 64 x 64 output accumulator in f32 registers (each thread owns 4 queries x
// 4 keys of the score tile and 4 queries x 4 dims of the accumulator; the
// 16 threads of a query row reduce with shuffles).  The (Tq, Tk) scores
// never reach device memory.  q and k tiles are stored transposed (D, 64)
// in shared memory and the probabilities (64 keys, 64 queries), so every
// inner-loop read is a float4.  Ragged ends of Tq and Tk are masked in the
// kernel.
//
// bfloat16 kernel, TMA + wgmma on Hopper (the FlashAttention-3 layout for
// D = 64): one block per (64-query tile, head, batch) is a consumer
// warpgroup of 64 query rows and a producer warp, three blocks per SM.  One
// producer thread loads the block's q tile once, then streams 64-key tiles
// of k and v through a ring of STAGES stages by TMA (3-D tensor maps over
// (B, T, H*D) in boxes of one head's 64 columns: rows past T load as zeros
// within their batch); the producer warp stages each tile's key mask
// beside it as a 64-bit word (key < Tk and mask[key]), so no consumer reads
// the mask.  The consumer warpgroup computes S = q k^T (wgmma m64n64k16,
// both operands K-major) into 32 f32 registers, masks it branch-free from
// the stage's word (keys past Tk at -inf, excluded keys at -1e30; a tile
// that is all valid and below the diagonal skips the masking), runs the
// online softmax on the registers in log2 units (ex2.approx; the four
// lanes of a row reduce the max with shuffles, the denominator is summed
// per lane and reduced once at the end), rounds P to bf16 pairs that are
// the register A operand of O += P v (wgmma m64n64k16, v MN-major), and
// keeps the 64 x 64 f32 O in registers.  S of tile j + 1 is issued before
// O += P_j v_j, so the softmax of one tile runs while the tensor cores do
// the other's product.  The denominator sums the unrounded f32
// probabilities; O is divided by it at the end and lse = m + log l.  Under
// `causal` a block visits the key tiles up to its last query only, unless
// a row of the block has no valid key at or before its query: such a row
// averages every key, so that block visits them all.  Timed alternatives,
// slower at the path's launch shapes (PERF.md): 128-key tiles (at T = 800
// and 400 the last one is mostly empty), 128-query blocks of two consumer
// warpgroups with or without the two taking turns at the tensor cores.

#include <math.h>

#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int LD = 68;  // padded row of the transposed tiles (float4-aligned)
constexpr float kNegInf = -1e30f;
template <int DP>
constexpr size_t smem_f32() {
  return (size_t)(DP * LD + DP * LD + BK * DP) * sizeof(float);
}

// DP: the padded head width (64 or 128); d <= DP the real one, the
// columns past it zeros
template <int DP, bool DROP>
__global__ void __launch_bounds__(NT)
    attention_fwd_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const unsigned char* __restrict__ mask,
                         float* __restrict__ out, float* __restrict__ lse,
                         int tq, int tk, int heads, int d, float scale,
                         int causal, smx::Dropout drop) {
  constexpr int NB = DP / 64;  // 64-column groups of the accumulator
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;           // (DP, LD): qs[c * LD + query]
  float* ks = qs + DP * LD;   // (DP, LD): ks[c * LD + key]; then P (BK, LD)
  float* vs = ks + DP * LD;   // (BK, DP): vs[key * DP + c]
  const int tid = threadIdx.x;
  const int tx = tid & 15;    // keys tx*4 .. +3 of the score tile; dims of out
  const int ty = tid >> 4;    // queries ty*4 .. +3
  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const long long row = (long long)heads * d;  // slab row stride
  const float* qb = q + (long long)b * tq * row + head * d;
  const float* kb = k + (long long)b * tk * row + head * d;
  const float* vb = v + (long long)b * tk * row + head * d;
  const unsigned char* mb = mask + (long long)b * tk;

  for (int i = tid; i < BQ * DP; i += NT) {
    const int r = i / DP, c = i % DP;
    const int t = q0 + r;
    qs[c * LD + r] = t < tq && c < d ? qb[t * row + c] : 0.0f;
  }

  float m[4], l[4], acc[4][4 * NB];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4 * NB; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < tk; k0 += BK) {
    __syncthreads();  // previous tile's readers of ks / vs are done
    for (int i = tid; i < BK * DP; i += NT) {
      const int r = i / DP, c = i % DP;
      const int t = k0 + r;
      const bool in = t < tk && c < d;
      ks[c * LD + r] = in ? kb[t * row + c] : 0.0f;
      vs[r * DP + c] = in ? vb[t * row + c] : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int c = 0; c < DP; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(qs + c * LD + ty * 4);
      const float4 kv = *reinterpret_cast<const float4*>(ks + c * LD + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += av[i] * cv[j];
    }

    // mask, then the online-softmax update of each of this thread's rows
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx * 4 + j;
        float x;
        if (kj >= tk) {
          x = -INFINITY;  // past the end: no weight at all
        } else if (!mb[kj] || (causal && kj > qi)) {
          x = kNegInf;
        } else {
          x = s[i][j] * scale;
        }
        s[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      }
      // the tile holds key k0 < tk, so rmax >= kNegInf is finite
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      float rsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = expf(s[i][j] - m_new);
        rsum += p[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      }
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * NB; ++j) acc[i][j] *= alpha;
    }
    if constexpr (DROP) {
      // this thread's four keys are one Philox group of each of its rows
      const long long rbase = ((long long)b * heads + head) * tq + q0 + ty * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint4 bits = drop.bits4(rbase + i, (k0 + tx * 4) / 4);
#pragma unroll
        for (int j = 0; j < 4; ++j) p[i][j] *= drop.keep(smx::word(bits, j));
      }
    }

    __syncthreads();  // every thread is done reading ks
    float* ps = ks;   // (BK, LD): ps[key * LD + query]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(ps + (tx * 4 + j) * LD + ty * 4) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(ps + kk * LD + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int h = 0; h < NB; ++h) {
        const float4 vv = *reinterpret_cast<const float4*>(
            vs + kk * DP + 64 * h + tx * 4);
        const float cv[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][4 * h + j] += av[i] * cv[j];
      }
    }
  }

  float* ob = out + (long long)b * tq * row + head * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= tq) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int h = 0; h < NB; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 64 * h + tx * 4 + j;
        if (c < d) ob[t * row + c] = acc[i][4 * h + j] * inv;
      }
    if (lse != nullptr && tx == 0) {
      lse[((long long)b * heads + head) * tq + t] = m[i] + logf(l[i]);
    }
  }
}

template <int DP, bool DROP>
int launch_f32(const void* q, const void* k, const void* v,
               const unsigned char* mask, void* out, float* lse, int batch,
               int tq, int tk, int heads, int d, float scale, int causal,
               smx::Dropout drop, cudaStream_t stream) {
  constexpr size_t smem = smem_f32<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel<DP, DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((tq + BQ - 1) / BQ, heads, batch);
  attention_fwd_kernel<DP, DROP><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), mask, static_cast<float*>(out), lse, tq,
      tk, heads, d, scale, causal, drop);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ bfloat16
namespace hw = smx::hopper;
using bf16 = __nv_bfloat16;

constexpr int WG = hw::WG_THREADS;
constexpr int BOX_ROWS = 64;                   // rows of one TMA box
constexpr int BOX_BYTES = BOX_ROWS * 64 * 2;   // 64 x 64 columns, 8 KB
constexpr int BKV = BOX_ROWS;                  // keys of a k / v tile
constexpr uint32_t SBO = hw::SBO;
constexpr uint32_t LBO = hw::MN_LBO;           // unused at N = 64
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf2 = kNegInf * kLog2e;   // an excluded logit, log2 units

// a consumer warpgroup of BQ = 64 queries (the float32 kernel's tile) and a
// producer warp; at DP = 64 three blocks per SM, at DP = 128 two
constexpr int TC_THREADS = WG + 32;
template <int DP>
struct Tc {
  static constexpr int NB = DP / 64;             // 64-column boxes a tile
  static constexpr int TILE_BYTES = NB * BOX_BYTES;
  static constexpr int KV_BYTES = 2 * TILE_BYTES;  // a stage: k, v tiles
  static constexpr int STAGES = DP == 64 ? 4 : 2;
  static constexpr int BLOCKS_PER_SM = DP == 64 ? 3 : 2;
  // the q tile, the ring, each stage's 64 key bits, barriers
  static constexpr size_t SMEM = 1024 + (size_t)TILE_BYTES +
                                 STAGES * KV_BYTES +
                                 STAGES * sizeof(uint64_t) +
                                 (2 * STAGES + 1) * sizeof(uint64_t);
};

struct FwdArgs {
  // (B, Tq, H*D) / (B, Tk, H*D): at D = 64 3-D maps in (64, 64) boxes,
  // else make_map_heads maps
  CUtensorMap q;
  CUtensorMap k, v;
  const unsigned char* mask;
  bf16* out;
  float* lse;
  int tq, tk, heads, d;
  float scale;
  int causal;
  smx::Dropout drop;
};

// 2^x by the special-function unit (relative error ~2^-22, far below the
// bf16 rounding of p that follows)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// bits 0 .. n of a 64-bit word (none for n < 0)
__device__ __forceinline__ uint64_t bits_upto(int n) {
  return n < 0 ? 0ull : n >= 63 ? ~0ull : (2ull << n) - 1;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// How many key tiles the block visits: every tile, or under `causal`
// those up to its last query, when every row of the block has a valid key
// at or before its query (a row without one averages all Tk keys).  Called
// by every thread of the block.
__device__ __forceinline__ int key_tiles(const FwdArgs& p, int b, int q0) {
  const int all = (p.tk + BKV - 1) / BKV;
  if (!p.causal) return all;
  // every row q >= q0 has an allowed key iff a valid key <= q0 exists
  const int upto = min(q0, p.tk - 1);
  int found = 0;
  for (int k = threadIdx.x; k <= upto && !found; k += blockDim.x) {
    found = p.mask[(long long)b * p.tk + k];
  }
  if (!__syncthreads_or(found)) return all;
  const int q_last = min(q0 + BQ, p.tq) - 1;
  return min(all, q_last / BKV + 1);
}

// One consumer thread's scores of a tile, s[4 j + 2 i + c] (row r + 8 i,
// key k0 + 8 j + 2 (lane % 4) + c, j < 8), to log2 units with the
// exclusions applied: -inf past Tk, -1e30 for a masked key or one after the
// query under causal.  `valid` is the stage's 64 bits (key < Tk and
// mask[key]); q[i] the rows' query indices.
__device__ __forceinline__ void mask_scores(float (&s)[32], float sl2,
                                            uint64_t valid, int k0, int tk,
                                            int causal, const int (&q)[2],
                                            int t4) {
  const int first = k0 + 2 * t4;  // key of element (j = 0, c = 0)
  const uint64_t v = valid >> (2 * t4);
  const uint64_t in_range = bits_upto(tk - 1 - first);
  uint64_t allow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    allow[i] = causal ? v & bits_upto(q[i] - first) : v;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int bit = 8 * j + c;
        float& x = s[4 * j + 2 * i + c];
        const float excluded = (in_range >> bit) & 1 ? kNegInf2 : -INFINITY;
        x = (allow[i] >> bit) & 1 ? x * sl2 : excluded;
      }
}

// the producer's loads of one 64-row tile of a slab into NB boxes at dst:
// at MAP4 one box per 64 columns of the head (zeros past D), else one 3-D
// box of the head's 64 columns
template <int NB, bool MAP4>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int head, int row,
                                          int b) {
  if constexpr (MAP4) {
#pragma unroll
    for (int h = 0; h < NB; ++h) {
      hw::tma_load_head(dst + h * BOX_BYTES, map, bar, 64 * h, head, row, b);
    }
  } else {
    hw::tma_load3(dst, map, bar, head * 64, row, b);
  }
}

// O += P v: box h of O (64 columns) from box h of the v tile at vs, P the
// register A operand
template <int NB>
__device__ __forceinline__ void pv_product(float (&o)[NB][32],
                                           const uint32_t (&pa)[16],
                                           const uint8_t* vs) {
#pragma unroll
  for (int h = 0; h < NB; ++h)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hw::wgmma_m64n64k16_rs<1>(
          o[h], pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
          hw::desc_sw128(vs + h * BOX_BYTES + kk * 2048, LBO, SBO), 1);
    }
}

template <int NB>
__device__ __forceinline__ void fence_o(float (&o)[NB][32]) {
#pragma unroll
  for (int h = 0; h < NB; ++h) hw::fence_regs(o[h]);
}

// DP: the padded head width (64 or 128); MAP4: the slabs are read through
// make_map_heads maps (every D but 64)
template <int DP, bool MAP4, bool DROP>
__global__ void __launch_bounds__(TC_THREADS, Tc<DP>::BLOCKS_PER_SM)
    attention_fwd_tc_kernel(const __grid_constant__ FwdArgs p) {
  using C = Tc<DP>;
  constexpr int NB = C::NB, STAGES = C::STAGES;
  constexpr int KV_BYTES = C::KV_BYTES, TILE_BYTES = C::TILE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = hw::align1024(smem_raw);       // the block's 64 queries
  uint8_t* ring = qs + TILE_BYTES;             // stage s: k tile, v tile
  uint64_t* kbits = reinterpret_cast<uint64_t*>(ring + STAGES * KV_BYTES);
  uint64_t* full = kbits + STAGES;
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;

  const int q0 = blockIdx.x * BQ, head = blockIdx.y, b = blockIdx.z;
  const int ntiles = key_tiles(p, b, q0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // the producer's expect and its warp's key bits
      hw::mbar_init(&full[s], 1 + 32);
      hw::mbar_init(&empty[s], WG);
    }
    hw::mbar_init(q_full, 1);
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= WG) {  // the producer warp
    const int pl = threadIdx.x - WG;
    if (pl == 0) {
      hw::mbar_expect_tx(q_full, TILE_BYTES);
      load_tile<NB, MAP4>(qs, &p.q, q_full, head, q0, b);
    }
    const unsigned char* mb = p.mask + (long long)b * p.tk;
    hw::Ring<STAGES> r;
    for (int t = 0; t < ntiles; ++t) {
      const int k0 = t * BKV;
      hw::mbar_wait(&empty[r.s], r.phase ^ 1);
      if (pl == 0) {
        uint8_t* st = ring + r.s * KV_BYTES;
        hw::mbar_expect_tx(&full[r.s], KV_BYTES);
        load_tile<NB, MAP4>(st, &p.k, &full[r.s], head, k0, b);
        load_tile<NB, MAP4>(st + TILE_BYTES, &p.v, &full[r.s], head, k0, b);
      }
      // lane pl: keys k0 + 2 pl, k0 + 2 pl + 1, bits 2 pl .. of the tile's 64
      uint32_t bits = 0;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = k0 + 2 * pl + i;
        if (key < p.tk && mb[key]) bits |= 1u << i;
      }
      bits <<= 2 * (pl % 16);
      uint32_t* words = reinterpret_cast<uint32_t*>(kbits + r.s);
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const uint32_t word =
            __reduce_or_sync(0xffffffffu, pl / 16 == w ? bits : 0u);
        if (pl == w) words[w] = word;
      }
      hw::mbar_arrive(&full[r.s]);
      r.advance();
    }
    return;
  }

  // the consumer warpgroup: this thread holds rows q[0], q[1] = q[0] + 8
  // and columns 8 j + 2 t4 + {0, 1} of each tile (of each 64-column box of
  // O)
  const int lane = threadIdx.x % 32, t4 = lane % 4;
  const int wrow = 16 * (threadIdx.x / 32) + lane / 4;
  const int q[2] = {q0 + wrow, q0 + wrow + 8};
  const long long bh = (long long)b * p.heads + head;
  const float sl2 = p.scale * kLog2e;
  float o[NB][32], s[32];
  uint32_t pa[16];  // P in bf16 pairs: slice kk of the A operand is pa[4 kk ..]
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < NB; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[h][i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) pa[i] = 0u;
  fence_o(o);
  hw::fence_regs(pa);
  hw::mbar_wait(q_full, 0);

  int st = 0, prev = -1;
  uint32_t phase = 0;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * BKV;
    const uint8_t* ks = ring + st * KV_BYTES;
    hw::mbar_wait(&full[st], phase);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk) {  // S = q k^T
      const int at = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      hw::wgmma_m64n64k16<0, 0>(s, hw::desc_sw128(qs + at, 16, SBO),
                                hw::desc_sw128(ks + at, 16, SBO), kk);
    }
    hw::wgmma_commit();
    if (prev >= 0) {  // O += P v of the previous tile, behind S
      pv_product(o, pa, ring + prev * KV_BYTES + TILE_BYTES);
      hw::wgmma_commit();
    }
    // a tile of valid keys below the diagonal needs no masking
    const uint64_t valid = kbits[st];
    const bool plain_tile =
        valid == ~0ull && (!p.causal || k0 + BKV - 1 <= q0);
    if (prev >= 0) {
      hw::wgmma_wait<1>();  // S; P v may still run
    } else {
      hw::wgmma_wait<0>();
    }
    hw::fence_regs(s);
    if (plain_tile) {
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] *= sl2;
    } else {
      mask_scores(s, sl2, valid, k0, p.tk, p.causal, q, t4);
    }
    // the online softmax in log2 units; the tile holds key k0 < Tk, so each
    // row's new max is at least -1e30 and finite
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
      }
      const float mn = fmaxf(m[i], quad_max(mx));
      alpha[i] = ex2(m[i] - mn);  // 0 on the first tile
      m[i] = mn;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[4 * j + 2 * i + c];
          x = ex2(x - mn);
          sum += x;
        }
      l[i] = l[i] * alpha[i] + sum;  // this lane's share of the row
    }
    if constexpr (DROP) {  // K14's mask, while the previous tile's P v runs
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (k0 + 8 * j >= p.tk) break;  // p is 0 past Tk (the whole warp)
        float mk[2][2];
        smx::accum_mask(p.drop, bh * p.tq + q[0], k0 + 8 * j + 2 * t4, lane,
                        mk);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          s[4 * j + 2 * i] *= mk[i][0];
          s[4 * j + 2 * i + 1] *= mk[i][1];
        }
      }
    }
    if (prev >= 0) {
      hw::wgmma_wait<0>();  // P v of the previous tile: its stage is free
      fence_o(o);
      hw::fence_regs(pa);
      hw::mbar_arrive(&empty[prev]);
    }
#pragma unroll
    for (int h = 0; h < NB; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          o[h][4 * j + 2 * i] *= alpha[i];
          o[h][4 * j + 2 * i + 1] *= alpha[i];
        }
#pragma unroll
    for (int e = 0; e < 16; ++e) pa[e] = pack_bf16(s[2 * e], s[2 * e + 1]);
    prev = st;
    if (++st == STAGES) {
      st = 0;
      phase ^= 1;
    }
  }
  {  // O += P v of the last tile
    hw::wgmma_fence();
    pv_product(o, pa, ring + prev * KV_BYTES + TILE_BYTES);
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    fence_o(o);
    hw::fence_regs(pa);
  }
  const int d = MAP4 ? p.d : 64;
  const long long stride = (long long)p.heads * d;
  bf16* ob = p.out + (long long)b * p.tq * stride + head * d + 2 * t4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = quad_sum(l[i]);
    if (q[i] >= p.tq) continue;
    const float inv = 1.0f / fmaxf(li, 1e-30f);
#pragma unroll
    for (int h = 0; h < NB; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // D is a multiple of 8: a column group is wholly in or past it
        if (MAP4 && 64 * h + 8 * j >= d) continue;
        *reinterpret_cast<__nv_bfloat162*>(ob + q[i] * stride + 64 * h +
                                           8 * j) =
            __floats2bfloat162_rn(o[h][4 * j + 2 * i] * inv,
                                  o[h][4 * j + 2 * i + 1] * inv);
      }
    if (p.lse != nullptr && t4 == 0) {
      p.lse[bh * p.tq + q[i]] = m[i] * kLn2 + logf(li);
    }
  }
}

template <int DP, bool MAP4, bool DROP>
int launch_tc(const void* q, const void* k, const void* v,
              const unsigned char* mask, void* out, float* lse, int batch,
              int tq, int tk, int heads, int d, float scale, int causal,
              smx::Dropout drop, cudaStream_t stream) {
  FwdArgs p;
  bool mapped;
  if constexpr (MAP4) {
    mapped = hw::make_map_heads(&p.q, q, batch, tq, heads, d, BOX_ROWS) &&
             hw::make_map_heads(&p.k, k, batch, tk, heads, d, BOX_ROWS) &&
             hw::make_map_heads(&p.v, v, batch, tk, heads, d, BOX_ROWS);
  } else {
    const uint64_t cols = (uint64_t)heads * 64;
    mapped = hw::make_map3(&p.q, q, batch, tq, cols, BOX_ROWS, 64) &&
             hw::make_map3(&p.k, k, batch, tk, cols, BOX_ROWS, 64) &&
             hw::make_map3(&p.v, v, batch, tk, cols, BOX_ROWS, 64);
  }
  if (!mapped) return static_cast<int>(cudaErrorInvalidValue);
  p.mask = mask;
  p.out = static_cast<bf16*>(out);
  p.lse = lse;
  p.tq = tq;
  p.tk = tk;
  p.heads = heads;
  p.d = d;
  p.scale = scale;
  p.causal = causal;
  p.drop = drop;
  constexpr size_t smem = Tc<DP>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_tc_kernel<DP, MAP4, DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((tq + BQ - 1) / BQ, heads, batch);
  attention_fwd_tc_kernel<DP, MAP4, DROP>
      <<<grid, TC_THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <bool DROP>
int launch(const void* q, const void* k, const void* v,
           const unsigned char* mask, void* out, float* lse, int batch, int tq,
           int tk, int heads, int head_dim, float scale, int causal,
           smx::Dropout drop, int dtype, int device, void* stream) {
  if (head_dim < 8 || head_dim > 128 || head_dim % 8 || batch <= 0 ||
      tq <= 0 || tk <= 0 || heads <= 0 || heads > 65535 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = head_dim;
  if (dtype == smx::kBF16) {
    // the TMA reads q / k / v from 16-byte-aligned bases
    if (!aligned16(q) || !aligned16(k) || !aligned16(v)) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    if (d == 64) {
      return launch_tc<64, false, DROP>(q, k, v, mask, out, lse, batch, tq,
                                        tk, heads, d, scale, causal, drop, s);
    }
    if (d < 64) {
      return launch_tc<64, true, DROP>(q, k, v, mask, out, lse, batch, tq,
                                       tk, heads, d, scale, causal, drop, s);
    }
    return launch_tc<128, true, DROP>(q, k, v, mask, out, lse, batch, tq, tk,
                                      heads, d, scale, causal, drop, s);
  }
  if (d <= 64) {
    return launch_f32<64, DROP>(q, k, v, mask, out, lse, batch, tq, tk,
                                heads, d, scale, causal, drop, s);
  }
  return launch_f32<128, DROP>(q, k, v, mask, out, lse, batch, tq, tk, heads,
                               d, scale, causal, drop, s);
}

}  // namespace

extern "C" int smx_attention_fwd(const void* q, const void* k, const void* v,
                                 const unsigned char* mask, void* out,
                                 float* lse, int batch, int tq, int tk,
                                 int heads,
                                 int head_dim, float scale, int causal,
                                 int dtype, int device, void* stream) {
  return launch<false>(q, k, v, mask, out, lse, batch, tq, tk, heads, head_dim,
                       scale, causal, smx::Dropout{}, dtype, device, stream);
}

// K14: k0, k1 the site's key, threshold and scale of the probability mask
// (stream 0), from the host.
extern "C" int smx_attention_dropout_fwd(
    const void* q, const void* k, const void* v, const unsigned char* mask,
    void* out, float* lse, int batch, int tq, int tk, int heads, int head_dim,
    float scale, int causal, uint32_t k0, uint32_t k1, uint32_t threshold,
    float drop_scale, int dtype, int device, void* stream) {
  return launch<true>(
      q, k, v, mask, out, lse, batch, tq, tk, heads, head_dim, scale, causal,
      smx::make_dropout(k0, k1, smx::kStreamAct, threshold, drop_scale), dtype,
      device, stream);
}
