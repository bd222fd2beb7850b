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
// bfloat16, q / k / v 16-byte aligned (the TMA reads them); mask: (B, Tk)
// bool (1 = key valid); causal: key j is excluded for query i when j > i.
// Excluded logits are -1e30 (the TPU kernel's NEG_INF), not -inf, so a fully
// masked row gives a finite average over all Tk keys, never NaN.
// lse: optional (B, H, Tq) float32 output, the row log-sum-exp of the masked,
// scaled logits (max + log denominator), which attention_bwd.cu reads to
// recompute the probabilities; null skips it.
//
// What bounds it on the H100: at the flagship speech shape (B = 16,
// T = 800, H = 12) the two products are 4*B*H*T*T*D ~ 31 GFLOP against
// ~60 MB of q/k/v/out traffic, so the tensor cores are the limit
// (~0.03 ms in bf16, ~0.19 ms for f32-accurate products as three tf32
// ones); beside them, on the CUDA cores and the special-function unit,
// the online softmax: one exp and ~8 other operations per score (B*H*T*T,
// 123 M), and for K14 one Philox-4x32-10 call per four scores, which costs
// more than the softmax (PERF.md has the times).  Each dtype has one
// kernel, both TMA + wgmma bodies for Hopper.
//
// Head widths.  Both kernels are built for a padded width DP, 64 or 128
// (the smallest that holds D), and bf16 D = 64 runs the body it always
// ran.  Other widths compute over DP columns of which those past D are zeros:
// the kernels read each head through a 4-D tensor map with the head as its
// own dimension (hopper.cuh: make_map_heads), so TMA fills the columns past
// D with zeros instead of reading the next head's (bf16 D = 64 reads 3-D
// maps instead).  Only D columns are stored.  In bf16,
// at DP = 128 an operand tile is two 64-column boxes (one 128-byte swizzle
// row each): S = q k^T takes eight k16 slices, four from each box, and
// O += P v is two m64n64 products, one per box of v, into 64 f32
// registers; the ring holds 2 stages, and two blocks share an SM.  Padding
// D = 16 to 64 or D = 80 to 128 wastes that share of the products: a
// simple body that is right.
//
// float32 kernel (the f32 path, the default dtype), TMA + tf32 wgmma: every
// product is three tf32 products of split operands, lo hi + hi lo + hi hi,
// f32-accurate at up to 165 TFLOP/s of f32 work on this card against the
// CUDA cores' 67.  The tensor cores read the top 19 bits of an f32
// operand, so x as TMA wrote it is its own hi half and the split writes lo
// = tf32(x - trunc(x)) (hopper.cuh: tf32_lo).  A block is a producer
// warpgroup and CONS consumer warpgroups of 64 queries; the key axis
// streams in stages of SK keys through two rings of two slots, one for k,
// one for v, so that a k slot is free once its S is formed and a v slot
// once its P v is:
//   * the producer lands the block's q rows once and splits them (lo
//     beside hi), then its first two warps stream k (TMA, the lo half in
//     place, the stage's key word: key < Tk and mask[key], 64 bits) and
//     its other two v (TMA, then the transposed hi and lo copies v^T, DP
//     rows of SK keys: tf32 wgmma reads K-major operands only, and P v
//     contracts over keys).  v^T lays each 8 keys in the order 0, 2, 4, 6,
//     1, 3, 5, 7, so that P enters as the register A operand just as the S
//     accumulator holds it (hopper.cuh: to_fragments).  Heads go through
//     make_map_heads maps in 32-column f32 boxes (zeros past D, and past T
//     within the batch);
//   * a consumer forms S = q k^T over the padded head's DP / 8 slices into
//     one accumulator, masks it branch-free from the stage's key word,
//     runs the online softmax on the registers in log2 units (ex2.approx;
//     the denominator sums the undropped f32 probabilities), multiplies
//     K14's mask in (drawn per stage as in the bf16 body), and splits P in
//     registers into its hi (P itself) and lo halves;
//   * P v goes into a per-stage partial (3 SK / 8 products per 64 columns
//     of O), which the CUDA cores fold into O as O alpha + partial in f32:
//     the tensor cores' sums drop low bits over a long K (PERF.md).  S of
//     stage n and P v of stage n - 1 go to the tensor cores as one group,
//     48 products back to back at D = 64, and one wait retires both.
//     ptxas serializes the products (under -Xptxas -v) where a product
//     that starts an accumulator reads it (start write-only), where an
//     instruction outside the products defines one before the loop, where
//     a wait sits on a divergent path (C7515 / C7518), and where the
//     softmax writes S's registers between a wait<1> that retires S and
//     the wait<0> of P v (C7513): the softmax of stage n cannot overlap
//     P v of stage n - 1 within one warpgroup, and two consumers overlap
//     each other's instead;
//   * at DP = 64 two consumers of 64 queries share each stage (SK = 64, so
//     S is an m64n64k8 at the full tf32 rate), the producer holding 120
//     registers and the consumers 192 (setmaxnreg: ptxas fits each role
//     into its count, the split spilling more the fewer it gets); at DP = 128
//     (D = 72 to 128) one consumer and 32-key stages (S an m64n32k8),
//     whose 64 + 64 registers of O and its partial leave room for nothing
//     more.
// Shared memory: q, q lo 64 KB; a k slot (hi, lo) 32 KB; a v slot (as
// landed, v^T hi, lo) 48 KB: 224 KB, one block an SM, at both DP.  Under
// `causal` a block skips key stages as the bf16 body does.
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

constexpr int BQ = 64;      // the queries of a consumer warpgroup
constexpr float kNegInf = -1e30f;

namespace hw = smx::hopper;

constexpr int WG = hw::WG_THREADS;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf2 = kNegInf * kLog2e;   // an excluded logit, log2 units

// ------------------------------------------------------------------ bfloat16
// (with the helpers of the online softmax both bodies share)
using bf16 = __nv_bfloat16;

constexpr int BOX_ROWS = 64;                   // rows of one TMA box
constexpr int BOX_BYTES = BOX_ROWS * 64 * 2;   // 64 x 64 columns, 8 KB
constexpr int BKV = BOX_ROWS;                  // keys of a k / v tile
constexpr uint32_t SBO = hw::SBO;
constexpr uint32_t LBO = hw::MN_LBO;           // unused at N = 64

// a consumer warpgroup of BQ = 64 queries and a producer warp; at DP = 64
// three blocks per SM, at DP = 128 two
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
// bf16 rounding of p that follows, and within the f32 body's limits)
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

// How many key tiles of `tile` keys a block of `rows` queries from q0
// visits: every tile, or under `causal` those up to its last query, when
// every row of the block has a valid key at or before its query (a row
// without one averages all Tk keys).  Called by every thread of the block.
__device__ __forceinline__ int key_tiles(const unsigned char* mask, int tk,
                                         int tq, int causal, int b, int q0,
                                         int rows, int tile) {
  const int all = (tk + tile - 1) / tile;
  if (!causal) return all;
  // every row q >= q0 has an allowed key iff a valid key <= q0 exists
  const int upto = min(q0, tk - 1);
  int found = 0;
  for (int k = threadIdx.x; k <= upto && !found; k += blockDim.x) {
    found = mask[(long long)b * tk + k];
  }
  if (!__syncthreads_or(found)) return all;
  const int q_last = min(q0 + rows, tq) - 1;
  return min(all, q_last / tile + 1);
}

// One consumer thread's scores of a tile of 8 NJ keys, s[4 j + 2 i + c]
// (row r + 8 i, key k0 + 8 j + 2 (lane % 4) + c, j < NJ), to log2 units
// with the exclusions applied: -inf past Tk, -1e30 for a masked key or one
// after the query under causal.  `valid` is the stage's key bits (key < Tk
// and mask[key]); q[i] the rows' query indices.
template <int NJ>
__device__ __forceinline__ void mask_scores(float (&s)[4 * NJ], float sl2,
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
  for (int j = 0; j < NJ; ++j)
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
  const int ntiles =
      key_tiles(p.mask, p.tk, p.tq, p.causal, b, q0, BQ, BKV);
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
      mask_scores<8>(s, sl2, valid, k0, p.tk, p.causal, q, t4);
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

// ------------------------------------------------------------------ float32
// The f32 body (see the header).  DP: the padded head width (64 or 128).
// Tiles: Q_TILE one consumer's 64 q rows, S_TILE a stage's SK k or v rows
// (NB boxes of 32 columns, the swizzled 128-byte rows TMA writes) or v^T's
// DP rows of SK keys (SK / 32 boxes); each with its lo half after it.
template <int DP>
struct F32 {
  static constexpr int CONS = DP == 64 ? 2 : 1;  // consumer warpgroups
  static constexpr int SK = DP == 64 ? 64 : 32;  // keys of a stage
  static constexpr int NJ = SK / 8;              // k8 slices of a stage
  static constexpr int NB = DP / 32;             // 32-column boxes a row
  static constexpr int NH = DP / 64;             // 64-column halves of O
  static constexpr int ROWS = CONS * BQ;         // queries of a block
  static constexpr int THREADS = (CONS + 1) * WG;
  static constexpr int Q_TILE = BQ * DP * 4;
  static constexpr int S_TILE = SK * DP * 4;
  static constexpr int K_SLOT = 2 * S_TILE;      // k hi, lo
  static constexpr int V_SLOT = 3 * S_TILE;      // v as landed; v^T hi, lo
};

// the producer's threads in each of its two roles (k, v)
constexpr int ROLE = WG / 2;

// q landed (TMA) and split (the producer warpgroup); per slot of each ring
// its stage landed (TMA), split (the role's threads) and free again (every
// consumer thread); the k stages' key words
struct F32Bars {
  uint64_t q_land, q_ready;
  uint64_t k_land[2], k_ready[2], k_empty[2];
  uint64_t v_land[2], v_ready[2], v_empty[2];
  uint64_t kbits[2];
};

template <int DP>
constexpr size_t f32_smem_bytes() {
  using G = F32<DP>;
  return 1024 + (size_t)G::CONS * 2 * G::Q_TILE +
         2 * (size_t)(G::K_SLOT + G::V_SLOT) + sizeof(F32Bars);
}

struct F32Args {
  // make_map_heads maps in 32-column f32 boxes: q in BQ rows, k and v in
  // SK rows
  CUtensorMap q, k, v;
  const unsigned char* mask;
  float* out;
  float* lse;
  int tq, tk, heads, d;
  float scale;
  int causal;
  smx::Dropout drop;
};

// v^T (hi at vt, lo at vt + S_TILE) of a stage's v rows as landed at v:
// key kr at position 8 (kr / 8) + (0, 4, 1, 5, 2, 6, 3, 7)[kr % 8] of the SK
// columns (to_fragments' order), box pos / 32, column pos % 32.  Thread r
// of the role takes key r % SK and every (ROLE / SK)-th 16-byte word of it,
// so a warp's loads and its transposed stores meet no bank twice.
template <int DP>
__device__ __forceinline__ void split_v(const uint8_t* v, uint8_t* vt,
                                        int r) {
  using G = F32<DP>;
  constexpr int SK = G::SK;
  const int kr = r % SK;
  const int pos = (kr & ~7) | ((kr & 1) << 2) | ((kr & 7) >> 1);
  uint8_t* col = vt + (pos / 32) * (DP * 128);
  const int c = pos % 32;
#pragma unroll
  for (int ch = r / SK; ch < DP / 4; ch += ROLE / SK) {
    const int at =
        (ch / 8) * SK * 128 + kr * 128 + (((ch % 8) ^ (kr % 8)) << 4);
    const float4 x = *reinterpret_cast<const float4*>(v + at);
    const float h[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 4 * ch + e;
      const int o = n * 128 + (((c >> 2) ^ (n & 7)) << 4) + (c & 3) * 4;
      *reinterpret_cast<float*>(col + o) = h[e];
      *reinterpret_cast<float*>(col + G::S_TILE + o) = hw::tf32_lo(h[e]);
    }
  }
}

// The producer warpgroup: its thread 0 lands the block's q rows (the
// consumers' 64 each) and every thread splits them; then threads 0 .. 63
// stream the k stages and 64 .. 127 the v stages, each into slot n % 2 of
// its ring as soon as the consumers free it, split in place.
template <int DP>
__device__ __forceinline__ void produce_f32(const F32Args& p, uint8_t* qs,
                                            uint8_t* ks, uint8_t* vs,
                                            F32Bars* bars, int q0, int head,
                                            int b, int ntiles) {
  using G = F32<DP>;
  constexpr int SK = G::SK;
  const int t = threadIdx.x - G::CONS * WG, r = t % ROLE;
  if (t == 0) {
    hw::mbar_expect_tx(&bars->q_land, G::CONS * G::Q_TILE);
#pragma unroll
    for (int c = 0; c < G::CONS; ++c)
#pragma unroll
      for (int x = 0; x < G::NB; ++x) {
        hw::tma_load_head(qs + c * 2 * G::Q_TILE + x * BQ * 128, &p.q,
                          &bars->q_land, 32 * x, head, q0 + BQ * c, b);
      }
  }
  hw::mbar_wait(&bars->q_land, 0);
#pragma unroll
  for (int c = 0; c < G::CONS; ++c) {
    hw::split_lo(qs + c * 2 * G::Q_TILE, G::Q_TILE, t, WG);
  }
  hw::fence_async_smem();
  hw::mbar_arrive(&bars->q_ready);
  if (t < ROLE) {
    const unsigned char* mb = p.mask + (long long)b * p.tk;
    for (int n = 0; n < ntiles; ++n) {
      const int s = n & 1;
      const uint32_t par = (n >> 1) & 1;
      uint8_t* kh = ks + s * G::K_SLOT;
      if (r == 0) {
        hw::mbar_wait(&bars->k_empty[s], par ^ 1);
        hw::mbar_expect_tx(&bars->k_land[s], G::S_TILE);
#pragma unroll
        for (int x = 0; x < G::NB; ++x) {
          hw::tma_load_head(kh + x * SK * 128, &p.k, &bars->k_land[s],
                            32 * x, head, n * SK, b);
        }
      }
      hw::mbar_wait(&bars->k_land[s], par);
      hw::split_lo(kh, G::S_TILE, r, ROLE);
      if (r < 32) {  // the first warp: bit kk of the word for key n SK + kk
        uint64_t word = 0;
#pragma unroll
        for (int i = 0; i < SK / 32; ++i) {
          const int key = n * SK + 32 * i + r;
          const bool ok = key < p.tk && mb[key];
          word |= (uint64_t)__ballot_sync(0xffffffffu, ok) << (32 * i);
        }
        if (r == 0) bars->kbits[s] = word;
      }
      hw::fence_async_smem();
      hw::mbar_arrive(&bars->k_ready[s]);
    }
  } else {
    for (int n = 0; n < ntiles; ++n) {
      const int s = n & 1;
      const uint32_t par = (n >> 1) & 1;
      uint8_t* vl = vs + s * G::V_SLOT;
      if (r == 0) {
        hw::mbar_wait(&bars->v_empty[s], par ^ 1);
        hw::mbar_expect_tx(&bars->v_land[s], G::S_TILE);
#pragma unroll
        for (int x = 0; x < G::NB; ++x) {
          hw::tma_load_head(vl + x * SK * 128, &p.v, &bars->v_land[s],
                            32 * x, head, n * SK, b);
        }
      }
      hw::mbar_wait(&bars->v_land[s], par);
      split_v<DP>(vl, vl + G::S_TILE, r);
      hw::fence_async_smem();
      hw::mbar_arrive(&bars->v_ready[s]);
    }
  }
}

// x (64 x SK) = q k^T over the padded head's DP / 8 k8 slices, three tf32
// products each (lo hi, hi lo, hi hi): q a consumer's rows (hi at q, lo at
// q + Q_TILE), k a stage's (hi at k, lo at k + S_TILE), both K-major in
// 32-column boxes.  Every slice runs, also past D (zeros there), and the
// first product starts x write-only (the header's note on ptxas).
template <int DP>
__device__ __forceinline__ void product_s(float (&x)[F32<DP>::SK / 2],
                                          const uint8_t* q,
                                          const uint8_t* k) {
  using G = F32<DP>;
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    const int ao = (kk / 4) * BQ * 128 + (kk % 4) * 32;
    const int bo = (kk / 4) * G::SK * 128 + (kk % 4) * 32;
    const uint64_t ah = hw::desc_sw128(q + ao, 16, 1024);
    const uint64_t al = hw::desc_sw128(q + G::Q_TILE + ao, 16, 1024);
    const uint64_t bh = hw::desc_sw128(k + bo, 16, 1024);
    const uint64_t bl = hw::desc_sw128(k + G::S_TILE + bo, 16, 1024);
    if constexpr (G::SK == 64) {
      if (kk == 0) {
        hw::wgmma_m64n64k8_tf32_zero(x, al, bh);
      } else {
        hw::wgmma_m64n64k8_tf32(x, al, bh, 1);
      }
      hw::wgmma_m64n64k8_tf32(x, ah, bl, 1);
      hw::wgmma_m64n64k8_tf32(x, ah, bh, 1);
    } else {
      if (kk == 0) {
        hw::wgmma_m64n32k8_tf32_zero(x, al, bh);
      } else {
        hw::wgmma_m64n32k8_tf32(x, al, bh, 1);
      }
      hw::wgmma_m64n32k8_tf32(x, ah, bl, 1);
      hw::wgmma_m64n32k8_tf32(x, ah, bh, 1);
    }
  }
}

// x (64 x DP, a 64-column half each) = P v over the stage's NJ k8 slices:
// P in registers (to_fragments' halves), v^T at vt (lo at vt + S_TILE);
// each half's first product starts it write-only
template <int DP>
__device__ __forceinline__ void product_pv(
    float (&x)[F32<DP>::NH][32], const uint32_t (&ph)[F32<DP>::NJ][4],
    const uint32_t (&pl)[F32<DP>::NJ][4], const uint8_t* vt) {
  using G = F32<DP>;
#pragma unroll
  for (int j = 0; j < G::NJ; ++j)
#pragma unroll
    for (int h = 0; h < G::NH; ++h) {
      const int o = (j / 4) * DP * 128 + h * 64 * 128 + (j % 4) * 32;
      const uint64_t bh = hw::desc_sw128(vt + o, 16, 1024);
      const uint64_t bl = hw::desc_sw128(vt + G::S_TILE + o, 16, 1024);
      if (j == 0) {
        hw::wgmma_m64n64k8_tf32_rs_zero(x[h], pl[j], bh);
      } else {
        hw::wgmma_m64n64k8_tf32_rs(x[h], pl[j], bh, 1);
      }
      hw::wgmma_m64n64k8_tf32_rs(x[h], ph[j], bl, 1);
      hw::wgmma_m64n64k8_tf32_rs(x[h], ph[j], bh, 1);
    }
}

// A stage's scores s (its 8 NJ keys from k0) to probabilities in place:
// masked, the online softmax in log2 units (m the running max, l this
// lane's share of the undropped denominator, alpha = 2^(m_old - m_new), 0
// on the first stage), then with DROP K14's mask multiplied in
template <int NJ, bool DROP>
__device__ __forceinline__ void stage_probs(float (&s)[4 * NJ], float (&m)[2],
                                            float (&l)[2], float (&alpha)[2],
                                            const F32Args& p, uint64_t valid,
                                            int k0, const int (&q)[2],
                                            long long bh, float sl2,
                                            int lane) {
  const int t4 = lane % 4;
  mask_scores<NJ>(s, sl2, valid, k0, p.tk, p.causal, q, t4);
  // the stage holds key k0 < Tk, so each row's new max is finite
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
    }
    const float mn = fmaxf(m[i], quad_max(mx));
    alpha[i] = ex2(m[i] - mn);
    m[i] = mn;
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = s[4 * j + 2 * i + c];
        x = ex2(x - mn);
        sum += x;
      }
    l[i] = l[i] * alpha[i] + sum;
  }
  if constexpr (DROP) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
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
}

// O = O alpha + part, alpha per row i of element 4 j + 2 i + c
template <int NH>
__device__ __forceinline__ void fold(float (&o)[NH][32],
                                     float (&part)[NH][32],
                                     const float (&alpha)[2]) {
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    hw::fence_regs(part[h]);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      o[h][e] = fmaf(o[h][e], alpha[(e >> 1) & 1], part[h][e]);
    }
  }
}

// A consumer warpgroup: its 64 queries from q0 (q hi at qc, lo after), the
// key stages of both rings.  This thread holds rows q[0], q[1] = q[0] + 8
// and columns 8 j + 2 (lane % 4) + {0, 1} of each 64-column half of O.
template <int DP, bool DROP>
__device__ __forceinline__ void consume_f32(const F32Args& p,
                                            const uint8_t* qc,
                                            const uint8_t* ks,
                                            const uint8_t* vs, F32Bars* bars,
                                            int q0, int head, int b,
                                            int ntiles) {
  using G = F32<DP>;
  constexpr int SK = G::SK, NJ = G::NJ, NH = G::NH;
  const int tid = threadIdx.x % WG, lane = tid % 32, t4 = lane % 4;
  const int wrow = 16 * (tid / 32) + lane / 4;
  const int q[2] = {q0 + wrow, q0 + wrow + 8};
  const long long bh = (long long)b * p.heads + head;
  const float sl2 = p.scale * kLog2e;
  // s and part are written first by products that start them afresh
  float o[NH][32], part[NH][32], s[SK / 2];
  uint32_t ph[NJ][4], pl[NJ][4];  // P of the stage whose P v is next
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float alpha[2], carry[2];  // carry: alpha of the stage of ph, pl
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[h][e] = 0.0f;
  hw::mbar_wait(&bars->q_ready, 0);

  // stage 0: S, then P
  hw::mbar_wait(&bars->k_ready[0], 0);
  uint64_t valid = bars->kbits[0];
  hw::wgmma_fence();
  product_s<DP>(s, qc, ks);
  hw::wgmma_commit();
  hw::wgmma_wait<0>();
  hw::fence_regs(s);
  hw::mbar_arrive(&bars->k_empty[0]);
  stage_probs<NJ, DROP>(s, m, l, alpha, p, valid, 0, q, bh, sl2, lane);
  hw::to_fragments(s, ph, pl);
  carry[0] = alpha[0];
  carry[1] = alpha[1];
  for (int n = 1; n < ntiles; ++n) {
    // S of stage n, then P v of stage n - 1 behind it
    const int sn = n & 1, sp = sn ^ 1;
    hw::mbar_wait(&bars->k_ready[sn], (n >> 1) & 1);
    hw::mbar_wait(&bars->v_ready[sp], ((n - 1) >> 1) & 1);
    valid = bars->kbits[sn];
    hw::wgmma_fence();
    product_s<DP>(s, qc, ks + sn * G::K_SLOT);
    hw::wgmma_commit();
    product_pv<DP>(part, ph, pl, vs + sp * G::V_SLOT + G::S_TILE);
    hw::wgmma_commit();
    hw::wgmma_wait<0>();  // both: stage n's k slot, n - 1's v slot free
    hw::fence_regs(s);
    hw::fence_regs(ph);
    hw::fence_regs(pl);
    hw::mbar_arrive(&bars->k_empty[sn]);
    hw::mbar_arrive(&bars->v_empty[sp]);
    stage_probs<NJ, DROP>(s, m, l, alpha, p, valid, n * SK, q, bh, sl2,
                          lane);
    fold(o, part, carry);
    hw::to_fragments(s, ph, pl);
    carry[0] = alpha[0];
    carry[1] = alpha[1];
  }
  {  // P v of the last stage
    const int sl = (ntiles - 1) & 1;
    hw::mbar_wait(&bars->v_ready[sl], ((ntiles - 1) >> 1) & 1);
    hw::wgmma_fence();
    product_pv<DP>(part, ph, pl, vs + sl * G::V_SLOT + G::S_TILE);
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_regs(ph);
    hw::fence_regs(pl);
    fold(o, part, carry);
  }
  const long long stride = (long long)p.heads * p.d;
  float* ob = p.out + (long long)b * p.tq * stride + head * p.d + 2 * t4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = quad_sum(l[i]);
    if (q[i] >= p.tq) continue;
    const float inv = 1.0f / fmaxf(li, 1e-30f);
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // D is a multiple of 8: a column group is wholly in or past it
        if (64 * h + 8 * j >= p.d) continue;
        *reinterpret_cast<float2*>(ob + q[i] * stride + 64 * h + 8 * j) =
            make_float2(o[h][4 * j + 2 * i] * inv,
                        o[h][4 * j + 2 * i + 1] * inv);
      }
    if (p.lse != nullptr && t4 == 0) {
      p.lse[bh * p.tq + q[i]] = m[i] * kLn2 + logf(li);
    }
  }
}

template <int DP, bool DROP>
__global__ void __launch_bounds__(F32<DP>::THREADS, 1)
    attention_fwd_f32_kernel(const __grid_constant__ F32Args p) {
  using G = F32<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = hw::align1024(smem_raw);  // per consumer: q hi, lo
  uint8_t* ks = qs + G::CONS * 2 * G::Q_TILE;
  uint8_t* vs = ks + 2 * G::K_SLOT;
  F32Bars* bars = reinterpret_cast<F32Bars*>(vs + 2 * G::V_SLOT);
  const int q0 = blockIdx.x * G::ROWS, head = blockIdx.y, b = blockIdx.z;
  const int ntiles =
      key_tiles(p.mask, p.tk, p.tq, p.causal, b, q0, G::ROWS, G::SK);
  // the consumers whose rows start before Tq; the others return at once
  const int active = min(G::CONS, (p.tq - q0 + BQ - 1) / BQ);
  if (threadIdx.x == 0) {
    hw::mbar_init(&bars->q_land, 1);
    hw::mbar_init(&bars->q_ready, WG);
    for (int s = 0; s < 2; ++s) {
      hw::mbar_init(&bars->k_land[s], 1);
      hw::mbar_init(&bars->k_ready[s], ROLE);
      hw::mbar_init(&bars->k_empty[s], active * WG);
      hw::mbar_init(&bars->v_land[s], 1);
      hw::mbar_init(&bars->v_ready[s], ROLE);
      hw::mbar_init(&bars->v_empty[s], active * WG);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / WG;
  if (wg == G::CONS) {
    if constexpr (G::CONS > 1) hw::setmaxnreg_dec<120>();
    produce_f32<DP>(p, qs, ks, vs, bars, q0, head, b, ntiles);
    return;
  }
  if constexpr (G::CONS > 1) hw::setmaxnreg_inc<192>();
  if (wg >= active) return;
  consume_f32<DP, DROP>(p, qs + wg * 2 * G::Q_TILE, ks, vs, bars,
                        q0 + BQ * wg, head, b, ntiles);
}

template <int DP, bool DROP>
int launch_tf32(const void* q, const void* k, const void* v,
                const unsigned char* mask, void* out, float* lse, int batch,
                int tq, int tk, int heads, int d, float scale, int causal,
                smx::Dropout drop, cudaStream_t stream) {
  using G = F32<DP>;
  F32Args p;
  const uint32_t f = sizeof(float);
  if (!hw::make_map_heads(&p.q, q, batch, tq, heads, d, BQ, f) ||
      !hw::make_map_heads(&p.k, k, batch, tk, heads, d, G::SK, f) ||
      !hw::make_map_heads(&p.v, v, batch, tk, heads, d, G::SK, f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.mask = mask;
  p.out = static_cast<float*>(out);
  p.lse = lse;
  p.tq = tq;
  p.tk = tk;
  p.heads = heads;
  p.d = d;
  p.scale = scale;
  p.causal = causal;
  p.drop = drop;
  constexpr size_t smem = f32_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_f32_kernel<DP, DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((tq + G::ROWS - 1) / G::ROWS, heads, batch);
  attention_fwd_f32_kernel<DP, DROP>
      <<<grid, G::THREADS, smem, stream>>>(p);
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
  // the TMA reads q / k / v from 16-byte-aligned bases
  if (!aligned16(q) || !aligned16(k) || !aligned16(v)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = head_dim;
  if (dtype == smx::kBF16) {
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
    return launch_tf32<64, DROP>(q, k, v, mask, out, lse, batch, tq, tk,
                                 heads, d, scale, causal, drop, s);
  }
  return launch_tf32<128, DROP>(q, k, v, mask, out, lse, batch, tq, tk,
                                heads, d, scale, causal, drop, s);
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
