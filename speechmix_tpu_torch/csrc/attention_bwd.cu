// K7: attention_bwd — backward of masked multi-head attention,
//   out = softmax(q k^T * scale + mask) v,  per (batch, head),
// on the (B, T, H*D) projection slabs, any head width D that is a multiple
// of 8 with 8 <= D <= 128: given g = d(out) it writes dq,
// dk and dv with the probabilities recomputed on chip (entry
// smx_attention_bwd).  K15: attention_dropout_bwd — the same for K14's
// out = (p * m) v (entry smx_attention_dropout_bwd), with the mask m
// regenerated from dropout.cuh (the forward's key, stream 0, row
// (b * H + h) * Tq + q, column k; in float32 per tile in both tiled passes,
// in bfloat16 by the dk/dv pass, which hands its bits to the dq pass):
//   dv_j = sum_i round(p_ij m_ij) g_i      dp_ij = (g_i . v_j) m_ij
//   ds_ij = round(p_ij (dp_ij - delta_i))
// delta_i = g_i . out_i stays right, as out is the dropped output:
// sum_j p_ij dp_ij = sum_j p_ij m_ij (g_i . v_j) = g_i . out_i.
//
// K7 replaces the TPU kernels of
// speechmix_tpu/ops/pallas/flash_attention_kernel.py:
// _flash_bwd_fused_layout (_attn_bwd_fused_kernel, heads as 64-lane columns
// of the (B, T, H*D) slabs) and _trainable_bwd (_attn_bwd_kernel, heads
// transposed to (B*H, T, D)); K15 those of _dropout_bwd
// (_attn_bwd_dropout_fused_kernel, _attn_bwd_dropout_kernel), which
// regenerate the mask from (seed, program_id).  Reading heads by stride
// covers both layouts.  The TPU kernels hold a whole (Tq, Tk) f32 score
// matrix per head and stop at T = 1024; this one tiles both axes and takes
// any length.
//
// q, out, g, dq: (B, Tq, H*D); k, v, dk, dv: (B, Tk, H*D), float32 or
// bfloat16, 16-byte aligned; mask: (B, Tk) bool (1 = key valid); lse:
// (B, H, Tq) float32, the row log-sum-exp attention_fwd.cu wrote; delta:
// (B, H, Tq) float32 workspace.  With p = exp(s - lse):
//   delta_i = sum_d g_id out_id           (= sum_j p_ij dp_ij)
//   dv_j = sum_i round(p_ij) g_i          dp_ij = g_i . v_j
//   ds_ij = round(p_ij (dp_ij - delta_i))
//   dq_i = scale sum_j ds_ij k_j          dk_j = scale sum_i ds_ij q_i
// where round() is to the tensors' dtype (the TPU kernel's roundings,
// flash_attention_kernel.py:300-309 and :335-347) and all sums are f32.
// Excluded logits are -1e30 as in the forward kernel, so their p is 0.  A
// row whose every logit is excluded has lse = -1e30, in which log(Tk) is
// lost; its probabilities are 1 / Tk on every key, as the softmax of a
// constant row is, and the kernel takes that branch when lse <= -1e29.
// Tiles are not skipped under `causal`: such a row attends every key, so a
// tile above the diagonal is not always empty.
//
// Three passes, no atomics, so two calls give the same bits:
//   delta:   one warp per (batch, query, head);
//   dk, dv:  one block per (key tile, head, batch) loops over the query
//            tiles and accumulates p^T g and ds^T q;
//   dq:      one block per (query tile, head, batch) loops over the key
//            tiles and accumulates ds k.
// Both tiled passes recompute s = q k^T and dp = g v^T.
//
// bfloat16 (the train step's path).  What bounds it on the H100: the five
// products, 10 * H * D * Tq * sum(valid keys) FLOPs (this structure computes
// s and dp twice: 14), against the seven slabs' traffic; at the flagship's
// shapes the tensor cores are the limit, and beside them, on the CUDA
// cores, the softmax and, for K15, the Philox words of the mask (ten rounds
// per four elements).  The design keeps operand loads off the math warps'
// path and p and ds on chip:
//   * a block is a producer warpgroup and two consumer warpgroups of 64
//     rows (128 keys in the dk/dv pass, 128 queries in the dq pass); one
//     producer thread loads the block's own tiles once and streams the
//     other side's 64-row tiles through a ring of STAGES stages with TMA
//     (3-D tensor maps over (B, T, H*D): rows past T load as zeros within
//     their batch, so a ragged tile never reads the next batch); setmaxnreg
//     moves the producer's registers to the consumers (24 / 240);
//   * every product is an m64n64k16 wgmma with f32 accumulators in
//     registers; s and dp are two commit groups, so the mask and the
//     excluded-logit bits are formed while both run and p while dp runs;
//   * p is branch-free: one ex2.approx per element, selected by a 64-bit
//     word per row of which elements take one (key mask, T, causal, the
//     uniform row);
//   * dk/dv pass, keys as M: s^T = k q^T and dp^T = v g^T, so p^T and ds^T
//     are, rounded in pairs, the register A operands of dv += (p m)^T g and
//     dk += ds^T q (g, q MN-major B); nothing goes through shared memory.
//     The producer's first warp stages each query tile's lse and delta
//     beside it, read a tile ahead.  A Philox word covers four keys of one
//     query, which lie on four lanes here: each lane draws a quarter of the
//     words of its column group and the four share keep nibbles;
//   * dq pass, queries as M: ds stays in registers as the A operand of
//     dq += ds k (k MN-major B).  K15's dk/dv pass writes the mask's keep
//     bits (16 keys to a 16-bit word, laid out (B*H, key tile, Tq, 4) so
//     that stores and loads coalesce) and its dq pass reads them instead of
//     drawing the words again: the same bits, a B*H*Tq*ceil(Tk/64)*8-byte
//     workspace from the wrapper;
//   * two consumer warpgroups per SM: one's softmax runs while the other's
//     products do.
// float32 (the f32 path, the default dtype): the same three passes on 64 x 64
// tiles staged in shared memory, the products as f32 FMAs (each thread a
// 4 x 4 patch), bound by the CUDA cores.
//
// Head widths.  Both kernels are built for a padded width DP, 64 or 128,
// and D = 64 runs the body it always ran.  Other widths compute over DP
// columns whose part past D is zeros (the f32 kernels load zeros there;
// the bf16 kernels read the slabs through 4-D tensor maps with the head as
// its own dimension, hopper.cuh's make_map_heads, so that TMA fills those
// columns with zeros instead of reading the next head), and store D
// columns.  At DP = 128 a 64-row operand tile is two 64-column boxes; the
// products over the head (s, dp) take eight k16 slices; and a block holds
// 64 keys (dk/dv pass) or 64 queries (dq pass) instead of 128: both
// consumer warpgroups form the same s, dp, p and ds, and each accumulates
// dk, dv or dq for one 64-column half of the head, so that every
// accumulator stays at 32 registers a thread (two halves in one warpgroup
// would need 64 each, beyond the 240 that setmaxnreg gives).  The shared
// s and dp products are computed twice: a simple body that is right.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hw = smx::hopper;
using bf16 = __nv_bfloat16;

constexpr int BT = 64;    // tile edge, queries and keys
constexpr int NT = 256;   // threads of the delta and float32 kernels
constexpr float kNegInf = -1e30f;
constexpr float kAllMasked = -1e29f;

// delta[b, h, i] = sum_c g[b, i, h, c] * out[b, i, h, c]: one warp each;
// ANY_D: head width d, else 64
template <typename T, bool ANY_D>
__global__ void __launch_bounds__(NT)
    attention_bwd_delta_kernel(const T* __restrict__ g, const T* __restrict__ o,
                               float* __restrict__ delta, int tq, int heads,
                               int d, long long total) {
  const long long w = (long long)blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  if (w >= total) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int h = (int)(w % heads);
  const long long bi = w / heads;  // b * tq + i
  float s;
  if constexpr (ANY_D) {
    const T* gp = g + w * d;
    const T* op = o + w * d;
    s = 0.0f;
    for (int c = lane; c < d; c += 32) {
      s += smx::to_f32(gp[c]) * smx::to_f32(op[c]);
    }
  } else {
    const T* gp = g + w * 64;
    const T* op = o + w * 64;
    s = smx::to_f32(gp[lane]) * smx::to_f32(op[lane]) +
        smx::to_f32(gp[lane + 32]) * smx::to_f32(op[lane + 32]);
  }
  s = smx::warp_sum(s);
  if (lane == 0) {
    const long long b = bi / tq, i = bi % tq;
    delta[(b * heads + h) * tq + i] = s;
  }
}

template <typename T>
int launch_delta(const void* g, const void* out, float* delta, int batch,
                 int tq, int heads, int d, cudaStream_t stream) {
  const long long warps = (long long)batch * tq * heads;
  const unsigned blocks = (unsigned)((warps + NT / 32 - 1) / (NT / 32));
  if (d == 64) {
    attention_bwd_delta_kernel<T, false><<<blocks, NT, 0, stream>>>(
        static_cast<const T*>(g), static_cast<const T*>(out), delta, tq,
        heads, d, warps);
  } else {
    attention_bwd_delta_kernel<T, true><<<blocks, NT, 0, stream>>>(
        static_cast<const T*>(g), static_cast<const T*>(out), delta, tq,
        heads, d, warps);
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ bfloat16
constexpr int WG = hw::WG_THREADS;                // a warpgroup
constexpr int CONSUMERS = hw::CONSUMERS;          // two consumer warpgroups
constexpr int BF16_THREADS = hw::THREADS;         // + a producer warpgroup
constexpr int TILE_BYTES = BT * 64 * 2;           // a 64 x 64 bf16 box, 8 KB
constexpr int STAGES = 3;                         // ring depth, 2 tiles each
constexpr uint32_t SBO = hw::SBO;
constexpr uint32_t LBO = hw::MN_LBO;              // unused at M = N = 64
constexpr float kLog2e = 1.4426950408889634f;

// DP: the padded head width; a 64-row operand tile is NB boxes of 64
// columns, and at DP = 128 the two consumer warpgroups share a block's 64
// rows and split the head's columns (SPLIT)
template <int DP>
struct Bwd {
  static constexpr int NB = DP / 64;
  static constexpr bool SPLIT = DP == 128;
  static constexpr int BLOCK_ROWS = SPLIT ? BT : 2 * BT;
  static constexpr int STAGE_BYTES = 2 * NB * TILE_BYTES;  // two tiles
};

struct BwdArgs {
  // (B, Tq, H*D) and (B, Tk, H*D): at D = 64 3-D maps in (64, 64) boxes,
  // else make_map_heads maps
  CUtensorMap q, g;
  CUtensorMap k, v;
  const unsigned char* mask;
  const float* lse;
  const float* delta;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  // K15: the mask's keep bits, handed from the dk/dv pass to the dq pass,
  // (B*H, ceil(Tk / 64), Tq, 4) 16-bit words: bit k of word w of (query,
  // key tile kt) keeps key 64 kt + 16 w + k
  uint16_t* keep;
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

// A consumer thread's two query rows (row + 8 i) of a tile: what its
// softmax needs of them.
struct Rows {
  float lse2[2];    // lse * log2(e)
  float delta[2];
  bool uniform[2];  // every logit excluded: p = 1 / Tk on every key
  int q[2];         // the query index; rows >= Tq take no key
};

__device__ __forceinline__ Rows load_rows(const BwdArgs& p, long long bh,
                                          int q_first) {
  Rows r;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q_first + 8 * i;
    const bool in = qi < p.tq;
    const float l = in ? p.lse[bh * p.tq + qi] : 0.0f;
    r.delta[i] = in ? p.delta[bh * p.tq + qi] : 0.0f;
    r.lse2[i] = l * kLog2e;
    r.uniform[i] = l <= kAllMasked;
    r.q[i] = in ? qi : -1;
  }
  return r;
}

// Which of a thread's 32 elements of a tile take a probability, as a bit
// 8 j + c per row i (key kcol + 8 j + c): `valid` has the unmasked keys
// < Tk; a row >= Tq takes none, a uniform row every key < Tk, a causal row
// the keys <= its query.
struct Allowed {
  uint64_t bits[2];
};

__device__ __forceinline__ Allowed allowed(const BwdArgs& p, const Rows& r,
                                           uint64_t valid, int kcol) {
  const uint64_t in_range = bits_upto(p.tk - 1 - kcol);
  Allowed a;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint64_t bits = r.uniform[i] ? in_range : valid;
    if (p.causal && !r.uniform[i]) bits &= bits_upto(r.q[i] - kcol);
    a.bits[i] = r.q[i] < 0 ? 0ull : bits;
  }
  return a;
}

// p of one thread's 32 elements in place of s (element 4 j + 2 i + c: row
// i, key kcol + 8 j + c): exp(s * scale - lse) where allowed, 1 / Tk on a
// uniform row, else 0
__device__ __forceinline__ void probs(const BwdArgs& p, float (&s)[32],
                                      const Rows& r, const Allowed& a) {
  const float sl2 = p.scale * kLog2e;
  const float inv_tk = 1.0f / (float)p.tk;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = s[4 * j + 2 * i + c];
        const float e = r.uniform[i] ? inv_tk : ex2(fmaf(x, sl2, -r.lse2[i]));
        x = (a.bits[i] >> (8 * j + c)) & 1 ? e : 0.0f;
      }
}

// The dk/dv pass's keep bits of key tile kt for a thread's two rows of the
// dq pass: one 64-bit word per row, shifted to the thread's first key
// (none without DROP)
struct Keep {
  uint64_t w[2];
};

template <bool DROP>
__device__ __forceinline__ Keep load_keep(const BwdArgs& p, long long bh,
                                          int q_first, int kt, int lane) {
  Keep k = {{0ull, 0ull}};
  if constexpr (DROP) {
    const uint64_t* words = reinterpret_cast<const uint64_t*>(p.keep) +
                            (bh * ((p.tk + BT - 1) / BT) + kt) * p.tq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = q_first + 8 * i;
      if (qi < p.tq) k.w[i] = words[qi] >> (2 * (lane % 4));
    }
  }
  return k;
}

// The dropout multipliers of the same 32 elements, m[4 j + 2 i + c] (all 1
// without DROP)
template <bool DROP>
__device__ __forceinline__ void keep_mult(const BwdArgs& p, const Keep& k,
                                          float (&m)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        m[4 * j + 2 * i + c] =
            !DROP ? 1.0f : (k.w[i] >> (8 * j + c)) & 1 ? p.drop.scale : 0.0f;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// round(p (dp m - delta)) as bf16 pairs, out[2 j + i] = columns 8 j +
// {0, 1} of row i: for the dq pass, slice kk of the A fragment of ds is
// out[4 kk .. 4 kk + 3]
template <bool DROP>
__device__ __forceinline__ void pack_ds(const float (&pr)[32],
                                        const float (&dp)[32],
                                        const float (&m)[32], const Rows& r,
                                        uint32_t (&out)[16]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = 4 * j + 2 * i;
      float d0 = dp[e], d1 = dp[e + 1];
      if constexpr (DROP) {
        d0 *= m[e];
        d1 *= m[e + 1];
      }
      out[2 * j + i] = pack_bf16(pr[e] * (d0 - r.delta[i]),
                                 pr[e + 1] * (d1 - r.delta[i]));
    }
}

// one thread's 64 x 64 f32 accumulator (rows row + 8 i of one head of a
// slab, rows < tmax; with CUT only the columns col0 + c < d) times `mult`,
// rounded to bf16; `out` points at the accumulator's first column
template <bool CUT>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out,
                                           const float (&acc)[32], int row,
                                           int tmax, long long stride,
                                           float mult, int lane, int col0 = 0,
                                           int d = 64) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row + 8 * i >= tmax) continue;
    bf16* at = out + (row + 8 * i) * stride + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // D is a multiple of 8: a column group is wholly in or past it
      if (CUT && col0 + 8 * j >= d) continue;
      *reinterpret_cast<__nv_bfloat162*>(at + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * i] * mult, acc[4 * j + 2 * i + 1] * mult);
    }
  }
}

// acc = a_tile b_tile^T over the head: 4 NB k16 slices, both operands
// K-major 64-row tiles of NB 64-column boxes (the slices of box h start
// at h * TILE_BYTES)
template <int NB>
__device__ __forceinline__ void product_nt(float (&acc)[32], const uint8_t* a,
                                           const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4 * NB; ++kk) {
    const int at = (kk / 4) * TILE_BYTES + (kk % 4) * 32;
    hw::wgmma_m64n64k16<0, 0>(acc, hw::desc_sw128(a + at, 16, SBO),
                              hw::desc_sw128(b + at, 16, SBO), kk);
  }
}

// 64 rows from `row` of one head of a slab into NB boxes at dst: at MAP4
// one make_map_heads box per 64 columns (zeros past D), else the 3-D box
// of the head's 64 columns
template <int NB, bool MAP4>
__device__ __forceinline__ void load_tile_tma(uint8_t* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int head, int row,
                                              int batch) {
  if constexpr (MAP4) {
#pragma unroll
    for (int h = 0; h < NB; ++h) {
      hw::tma_load_head(dst + h * TILE_BYTES, map, bar, 64 * h, head, row,
                        batch);
    }
  } else {
    hw::tma_load3(dst, map, bar, head * 64, row, batch);
  }
}

// every stage's full / empty barriers (`arrivals` on full: the producer's
// expect, and any of its threads that also write the stage; one per thread
// of the `consumers` active consumer warpgroups on empty) and the block's
// own tiles' barrier
__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty,
                                              uint64_t* own, int arrivals,
                                              int consumers) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hw::mbar_init(&full[s], arrivals);
      hw::mbar_init(&empty[s], consumers * WG);
    }
    hw::mbar_init(own, 1);
    hw::mbar_fence_init();
  }
  __syncthreads();
}

// The producer thread: the block's own rows of two slabs (a, b) once (128
// rows of NB = 1 box, or 64 of 2: four boxes), then `tiles` 64-row tiles of
// two others (c, d) through the ring.
template <int DP, bool MAP4>
__device__ __forceinline__ void produce(const CUtensorMap* a,
                                        const CUtensorMap* b,
                                        const CUtensorMap* c,
                                        const CUtensorMap* d, uint8_t* own,
                                        uint8_t* ring, uint64_t* own_full,
                                        uint64_t* full, uint64_t* empty,
                                        int head, int r0, int batch,
                                        int tiles) {
  constexpr int NB = Bwd<DP>::NB, STAGE_BYTES = Bwd<DP>::STAGE_BYTES;
  hw::mbar_expect_tx(own_full, 4 * TILE_BYTES);
#pragma unroll
  for (int r = 0; r < 2 / NB; ++r) {
    load_tile_tma<NB, MAP4>(own + r * NB * TILE_BYTES, a, own_full, head,
                            r0 + r * BT, batch);
  }
#pragma unroll
  for (int r = 0; r < 2 / NB; ++r) {
    load_tile_tma<NB, MAP4>(own + (2 + r * NB) * TILE_BYTES, b, own_full,
                            head, r0 + r * BT, batch);
  }
  hw::Ring<STAGES> r;
  for (int t = 0; t < tiles; ++t) {
    uint8_t* st = ring + r.s * STAGE_BYTES;
    r.acquire(full, empty, STAGE_BYTES);
    load_tile_tma<NB, MAP4>(st, c, &full[r.s], head, t * BT, batch);
    load_tile_tma<NB, MAP4>(st + NB * TILE_BYTES, d, &full[r.s], head,
                            t * BT, batch);
    r.advance();
  }
}

// ------------------------------------------ the dk/dv pass, keys as M
// Here s^T = k q^T and dp^T = v g^T: a thread's element 4 j + 2 i + c is
// key row + 8 i (row = 16 warp + lane / 4 of the warpgroup's 64 keys) and
// query q0 + 2 (lane % 4) + 8 j + c, so p^T and ds^T are, pair by pair, the
// register A fragments of dv += (p m)^T g and dk += ds^T q.

// what the producer stages beside each q, g tile, per query of the tile
struct QueryRows {
  float lse2[BT];   // lse * log2(e); 0 past Tq
  float delta[BT];
};

// The dropout multipliers of a thread's 32 elements of an s^T tile.  The
// Philox word of (query, 4 keys) belongs to the four lanes u = (lane / 4)
// % 4 that hold those keys in one column: each of them draws the words of
// a quarter of the columns (8 calls), turns them into keep nibbles, and the
// four share the nibbles (bh: the head's row; kgroup: the 4-key group of
// the warp's first key).  The lanes of a = 0 also write the warp's keep
// words of their four queries for the dq pass (of the `writer` warpgroup,
// where two draw the same words).
template <bool DROP>
__device__ __forceinline__ void drop_mask_t(const BwdArgs& p, long long bh,
                                            int q0, int kgroup, int lane,
                                            float (&m)[32],
                                            bool writer = true) {
  if constexpr (!DROP) {
#pragma unroll
    for (int e = 0; e < 32; ++e) m[e] = 1.0f;
  } else {
    const int t = lane & 3, u = (lane >> 2) & 3, a = lane >> 4;
    const uint32_t th = p.drop.threshold;
    uint32_t nib = 0;
#pragma unroll
    for (int blk = 0; blk < 4; ++blk)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = 4 * blk + u;  // this lane's column of the block
        const uint4 w =
            p.drop.bits4(bh * p.tq + q0 + 8 * (e >> 1) + 2 * t + (e & 1),
                         kgroup + 2 * i + a);
        const uint32_t n = (uint32_t)(w.x >= th) | (uint32_t)(w.y >= th) << 1 |
                           (uint32_t)(w.z >= th) << 2 |
                           (uint32_t)(w.w >= th) << 3;
        nib |= n << (4 * (2 * blk + i));
      }
    // keep word of query column 4 blk + u: nibble (blk, i) of lane a at bit
    // 8 i + 4 a (keys 16 warp + 8 i + 4 a + 0 .. 3)
    const int ktiles = (p.tk + BT - 1) / BT, kt = kgroup / 16;
    uint16_t* words =
        p.keep + (bh * ktiles + kt) * p.tq * 4 + kgroup / 4 % 4;
#pragma unroll
    for (int blk = 0; blk < 4; ++blk) {
      uint32_t v =
          ((nib >> (8 * blk)) & 0xf) | ((nib >> (8 * blk + 4)) & 0xf) << 8;
      v <<= 4 * a;
      v |= __shfl_xor_sync(0xffffffffu, v, 16);
      const int e = 4 * blk + u;
      const int qi = q0 + 8 * (e >> 1) + 2 * t + (e & 1);
      if (writer && a == 0 && qi < p.tq && kt < ktiles) {
        words[4 * qi] = (uint16_t)v;
      }
    }
    // nx[x]: the nibbles of the lane that drew columns 4 blk + x, shifted
    // to this lane's key
    uint32_t nx[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      nx[x] = __shfl_sync(0xffffffffu, nib, (lane & ~12) | (x << 2)) >> u;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * j + c;
          m[4 * j + 2 * i + c] =
              (nx[e & 3] >> (4 * (2 * (e >> 2) + i))) & 1 ? p.drop.scale
                                                          : 0.0f;
        }
  }
}

template <int DP>
constexpr size_t dkdv_smem_bytes() {
  // k, v (four boxes), the ring with its query rows, barriers
  return 1024 + (size_t)4 * TILE_BYTES + STAGES * Bwd<DP>::STAGE_BYTES +
         STAGES * sizeof(QueryRows) + (2 * STAGES + 1) * sizeof(uint64_t);
}

template <int DP, bool MAP4, bool DROP>
__global__ void __launch_bounds__(BF16_THREADS, 1)
    dkdv_kernel(const __grid_constant__ BwdArgs p) {
  using G = Bwd<DP>;
  constexpr int NB = G::NB, STAGE_BYTES = G::STAGE_BYTES;
  constexpr bool SPLIT = G::SPLIT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* kv = hw::align1024(smem_raw);        // the keys of k, then of v
  uint8_t* ring = kv + 4 * TILE_BYTES;          // stage s: q tile, g tile
  QueryRows* qrows =
      reinterpret_cast<QueryRows*>(ring + STAGES * STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(qrows + STAGES);
  uint64_t* empty = full + STAGES;
  uint64_t* kv_full = empty + STAGES;

  const int k0 = blockIdx.x * G::BLOCK_ROWS, head = blockIdx.y;
  const int b = blockIdx.z;
  const int qtiles = (p.tq + BT - 1) / BT;
  const int wg = threadIdx.x / WG;
  const long long bh = (long long)b * p.heads + head;
  // A stage is full after the producer's expect and its first warp's query
  // rows.  Without SPLIT the last block's second warpgroup may hold no
  // key: it leaves at once, and the stages wait for the first alone.
  const int active = SPLIT || k0 + BT < p.tk ? 2 : 1;
  init_barriers(full, empty, kv_full, 1 + 32, active);

  if (wg == 2) {
    hw::setmaxnreg_dec<24>();
    const int pl = threadIdx.x - CONSUMERS;
    if (pl >= 32) return;
    if (pl == 0) {
      hw::mbar_expect_tx(kv_full, 4 * TILE_BYTES);
#pragma unroll
      for (int r = 0; r < 2 / NB; ++r) {
        load_tile_tma<NB, MAP4>(kv + r * NB * TILE_BYTES, &p.k, kv_full,
                                head, k0 + r * BT, b);
      }
#pragma unroll
      for (int r = 0; r < 2 / NB; ++r) {
        load_tile_tma<NB, MAP4>(kv + (2 + r * NB) * TILE_BYTES, &p.v,
                                kv_full, head, k0 + r * BT, b);
      }
    }
    // lane pl stages queries pl and pl + 32 of each tile, read one tile
    // ahead so that no stage waits for them
    float l[2], d[2];
    auto fetch = [&](int t) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qi = t * BT + pl + 32 * h;
        const bool in = qi < p.tq;
        l[h] = in ? p.lse[bh * p.tq + qi] * kLog2e : 0.0f;
        d[h] = in ? p.delta[bh * p.tq + qi] : 0.0f;
      }
    };
    fetch(0);
    hw::Ring<STAGES> r;
    for (int t = 0; t < qtiles; ++t) {
      hw::mbar_wait(&empty[r.s], r.phase ^ 1);
      if (pl == 0) {
        uint8_t* st = ring + r.s * STAGE_BYTES;
        hw::mbar_expect_tx(&full[r.s], STAGE_BYTES);
        load_tile_tma<NB, MAP4>(st, &p.q, &full[r.s], head, t * BT, b);
        load_tile_tma<NB, MAP4>(st + NB * TILE_BYTES, &p.g, &full[r.s], head,
                                t * BT, b);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        qrows[r.s].lse2[pl + 32 * h] = l[h];
        qrows[r.s].delta[pl + 32 * h] = d[h];
      }
      hw::mbar_arrive(&full[r.s]);
      if (t + 1 < qtiles) fetch(t + 1);
      r.advance();
    }
    return;
  }
  hw::setmaxnreg_inc<240>();
  if (wg >= active) return;

  // consumers: warpgroup wg owns keys k0 + 64 wg .. + 63 as its M rows, or
  // with SPLIT keys k0 .. + 63 and the head's columns 64 wg .. + 63
  const int lane = threadIdx.x % 32, t = lane % 4;
  const int row = 16 * ((threadIdx.x % WG) / 32) + lane / 4;
  const int kfirst = k0 + (SPLIT ? 0 : BT * wg);  // the warpgroup's keys
  const int key0 = kfirst + row;                  // keys key0 + 8 i
  bool key_in[2], key_valid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = key0 + 8 * i;
    key_in[i] = kj < p.tk;
    key_valid[i] = key_in[i] && p.mask[(long long)b * p.tk + kj];
  }
  const int kgroup = (kfirst + row - lane / 4) / 4;
  const float sl2 = p.scale * kLog2e;
  const float inv_tk = 1.0f / (float)p.tk;
  const uint8_t* kw = kv + (SPLIT ? 0 : wg) * TILE_BYTES;
  const uint8_t* vw = kv + (2 + (SPLIT ? 0 : wg)) * TILE_BYTES;
  const int half = SPLIT ? wg : 0;  // the box of q and g this wg's dk, dv use
  float dk_acc[32], dv_acc[32], s_acc[32], dp_acc[32];
  uint32_t pa[16], dsa[16];  // the A fragments of (p m)^T and ds^T
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) pa[i] = dsa[i] = 0u;
  hw::fence_regs(dk_acc);
  hw::fence_regs(dv_acc);
  hw::mbar_wait(kv_full, 0);

  int s = 0, prev = -1;
  uint32_t phase = 0;
  for (int qt = 0; qt < qtiles; ++qt) {
    const int q0 = qt * BT, qcol = q0 + 2 * t;
    const uint8_t* qs = ring + s * STAGE_BYTES;
    const uint8_t* gs = qs + NB * TILE_BYTES;
    hw::mbar_wait(&full[s], phase);
    hw::wgmma_fence();
    product_nt<NB>(s_acc, kw, qs);   // s^T = k q^T
    hw::wgmma_commit();
    product_nt<NB>(dp_acc, vw, gs);  // dp^T = v g^T
    hw::wgmma_commit();
    // while the products run: the mask, and which elements take a p
    float m[32];
    drop_mask_t<DROP>(p, bh, q0, kgroup, lane, m, !SPLIT || wg == 0);
    float2 l2[8];
    uint64_t uniform = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      l2[j] = *reinterpret_cast<const float2*>(&qrows[s].lse2[8 * j + 2 * t]);
      if (l2[j].x <= kAllMasked * kLog2e) uniform |= 1ull << (8 * j);
      if (l2[j].y <= kAllMasked * kLog2e) uniform |= 2ull << (8 * j);
    }
    const uint64_t in_cols = bits_upto(p.tq - 1 - qcol);
    uint64_t allow[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // a query takes this key if the key is valid and, under causal, not
      // after the query; a uniform query takes every key < Tk
      uint64_t take = key_valid[i] ? ~0ull : 0ull;
      if (p.causal) take &= ~bits_upto(key0 + 8 * i - qcol - 1);
      allow[i] = key_in[i] ? in_cols & (take | uniform) : 0ull;
    }
    // s is done, and so are the previous tile's dv, dk products: its stage
    // and the A fragments they read are free again
    hw::wgmma_wait<1>();
    hw::fence_regs(s_acc);
    hw::fence_regs(dk_acc);
    hw::fence_regs(dv_acc);
    hw::fence_regs(pa);
    hw::fence_regs(dsa);
    if (prev >= 0) hw::mbar_arrive(&empty[prev]);

#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float pv[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s_acc[4 * j + 2 * i + c];
          const float lc = c ? l2[j].y : l2[j].x;
          const float e = (uniform >> (8 * j + c)) & 1
                              ? inv_tk : ex2(fmaf(x, sl2, -lc));
          x = (allow[i] >> (8 * j + c)) & 1 ? e : 0.0f;
          pv[c] = DROP ? x * m[4 * j + 2 * i + c] : x;
        }
        pa[2 * j + i] = pack_bf16(pv[0], pv[1]);
      }
    hw::wgmma_fence();
    // dv += (p m)^T g: A from registers, g (queries x d) MN-major
    const uint8_t* gh = gs + half * TILE_BYTES;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hw::wgmma_m64n64k16_rs<1>(dv_acc, pa[4 * kk], pa[4 * kk + 1],
                                pa[4 * kk + 2], pa[4 * kk + 3],
                                hw::desc_sw128(gh + kk * 2048, LBO, SBO), 1);
    }
    hw::wgmma_commit();
    hw::wgmma_wait<1>();         // dp
    hw::fence_regs(dp_acc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dl =
          *reinterpret_cast<const float2*>(&qrows[s].delta[8 * j + 2 * t]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = 4 * j + 2 * i;
        float d0 = dp_acc[e], d1 = dp_acc[e + 1];
        if constexpr (DROP) {
          d0 *= m[e];
          d1 *= m[e + 1];
        }
        dsa[2 * j + i] = pack_bf16(s_acc[e] * (d0 - dl.x),
                                   s_acc[e + 1] * (d1 - dl.y));
      }
    }
    hw::wgmma_fence();
    // dk += ds^T q: q (queries x d) MN-major
    const uint8_t* qh = qs + half * TILE_BYTES;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hw::wgmma_m64n64k16_rs<1>(dk_acc, dsa[4 * kk], dsa[4 * kk + 1],
                                dsa[4 * kk + 2], dsa[4 * kk + 3],
                                hw::desc_sw128(qh + kk * 2048, LBO, SBO), 1);
    }
    hw::wgmma_commit();
    prev = s;
    if (++s == STAGES) {
      s = 0;
      phase ^= 1;
    }
  }
  hw::wgmma_wait<0>();
  hw::fence_regs(dk_acc);
  hw::fence_regs(dv_acc);
  hw::fence_regs(pa);
  hw::fence_regs(dsa);
  const int d = MAP4 ? p.d : 64;
  const long long stride = (long long)p.heads * d;
  const long long base = (long long)b * p.tk * stride + head * d + 64 * half;
  store_rows<MAP4>(p.dk + base, dk_acc, key0, p.tk, stride, p.scale, lane,
                   64 * half, d);
  store_rows<MAP4>(p.dv + base, dv_acc, key0, p.tk, stride, 1.0f, lane,
                   64 * half, d);
}

// the dq pass's shared memory: q, g (four boxes), the ring, barriers and
// one valid bit per key, in 64-key words
template <int DP>
size_t dq_smem_bytes(int tk) {
  return 1024 + (size_t)4 * TILE_BYTES + STAGES * Bwd<DP>::STAGE_BYTES +
         (2 * STAGES + 1) * sizeof(uint64_t) +
         (size_t)((tk + BT - 1) / BT) * sizeof(uint64_t);
}

template <int DP, bool MAP4, bool DROP>
__global__ void __launch_bounds__(BF16_THREADS, 1)
    dq_kernel(const __grid_constant__ BwdArgs p) {
  using G = Bwd<DP>;
  constexpr int NB = G::NB, STAGE_BYTES = G::STAGE_BYTES;
  constexpr bool SPLIT = G::SPLIT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qg = hw::align1024(smem_raw);        // the queries of q, then g
  uint8_t* ring = qg + 4 * TILE_BYTES;          // stage s: k tile, v tile
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* qg_full = empty + STAGES;
  uint32_t* kbits = reinterpret_cast<uint32_t*>(qg_full + 1);

  const int q0 = blockIdx.x * G::BLOCK_ROWS, head = blockIdx.y;
  const int b = blockIdx.z;
  const int ktiles = (p.tk + BT - 1) / BT;
  const int wg = threadIdx.x / WG;
  // without SPLIT the last block's second warpgroup may hold no query: it
  // leaves after the key bits, and the stages wait for the first alone
  const int active = SPLIT || q0 + BT < p.tq ? 2 : 1;
  init_barriers(full, empty, qg_full, 1, active);

  if (wg == 2) {
    hw::setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS) {
      produce<DP, MAP4>(&p.q, &p.g, &p.k, &p.v, qg, ring, qg_full, full,
                        empty, head, q0, b, ktiles);
    }
    return;
  }
  hw::setmaxnreg_inc<240>();

  // consumers: the valid keys of this batch row as bits, 32 per warp ballot
  for (int k = threadIdx.x; k < ktiles * BT; k += CONSUMERS) {
    const bool ok = k < p.tk && p.mask[(long long)b * p.tk + k];
    const uint32_t word = __ballot_sync(0xffffffffu, ok);
    if ((threadIdx.x & 31) == 0) kbits[k / 32] = word;
  }
  hw::bar_sync(1, CONSUMERS);
  if (wg >= active) return;

  // warpgroup wg owns queries q0 + 64 wg .. + 63, or with SPLIT queries
  // q0 .. + 63 and the head's columns 64 wg .. + 63
  const int lane = threadIdx.x % 32;
  const int row = 16 * ((threadIdx.x % WG) / 32) + lane / 4;
  const int q_first = q0 + (SPLIT ? 0 : BT * wg) + row;
  const long long bh = (long long)b * p.heads + head;
  const Rows rows = load_rows(p, bh, q_first);
  const uint8_t* qw = qg + (SPLIT ? 0 : wg) * TILE_BYTES;
  const uint8_t* gw = qg + (2 + (SPLIT ? 0 : wg)) * TILE_BYTES;
  const int half = SPLIT ? wg : 0;  // the box of k this wg's dq uses
  float dq_acc[32], s_acc[32], dp_acc[32];
  uint32_t ds[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq_acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) ds[i] = 0u;
  hw::fence_regs(dq_acc);
  Keep keep = load_keep<DROP>(p, bh, q_first, 0, lane);
  hw::mbar_wait(qg_full, 0);

  int s = 0, prev = -1;
  uint32_t phase = 0;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int kcol = kt * BT + 2 * (lane % 4);
    const uint8_t* kst = ring + s * STAGE_BYTES;
    const uint8_t* vst = kst + NB * TILE_BYTES;
    hw::mbar_wait(&full[s], phase);
    hw::wgmma_fence();
    product_nt<NB>(s_acc, qw, kst);   // s = q k^T
    hw::wgmma_commit();
    product_nt<NB>(dp_acc, gw, vst);  // dp = g v^T
    hw::wgmma_commit();
    // what does not need s (the mask's Philox words) while the products run
    const uint64_t valid =
        *reinterpret_cast<const uint64_t*>(kbits + 2 * kt) >> (2 * (lane % 4));
    const Allowed allow = allowed(p, rows, valid, kcol);
    float m[32];
    keep_mult<DROP>(p, keep, m);
    // the next tile's keep words, a tile ahead of their use
    if (kt + 1 < ktiles) keep = load_keep<DROP>(p, bh, q_first, kt + 1, lane);
    // s is done, and so is the previous tile's dq product: its stage is
    // free, and so are the ds registers it read
    hw::wgmma_wait<1>();
    hw::fence_regs(s_acc);
    hw::fence_regs(dq_acc);
    hw::fence_regs(ds);
    if (prev >= 0) hw::mbar_arrive(&empty[prev]);

    probs(p, s_acc, rows, allow);
    hw::wgmma_wait<0>();          // dp
    hw::fence_regs(dp_acc);
    pack_ds<DROP>(s_acc, dp_acc, m, rows, ds);
    hw::wgmma_fence();
    // dq += ds k: ds from registers (pack_ds's pairs are the A fragment),
    // k (keys x d) MN-major
    const uint8_t* kh = kst + half * TILE_BYTES;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hw::wgmma_m64n64k16_rs<1>(dq_acc, ds[4 * kk], ds[4 * kk + 1],
                                ds[4 * kk + 2], ds[4 * kk + 3],
                                hw::desc_sw128(kh + kk * 2048, LBO, SBO), 1);
    }
    hw::wgmma_commit();
    prev = s;
    if (++s == STAGES) {
      s = 0;
      phase ^= 1;
    }
  }
  hw::wgmma_wait<0>();
  hw::fence_regs(dq_acc);
  hw::fence_regs(ds);
  const int d = MAP4 ? p.d : 64;
  const long long stride = (long long)p.heads * d;
  store_rows<MAP4>(p.dq + (long long)b * p.tq * stride + head * d + 64 * half,
                   dq_acc, q_first, p.tq, stride, p.scale, lane, 64 * half,
                   d);
}

template <int DP, bool MAP4, bool DROP>
int launch_bf16(const void* q, const void* k, const void* v, const void* out,
                const void* g, const unsigned char* mask, const float* lse,
                float* delta, uint16_t* keep, void* dq, void* dk, void* dv,
                int batch, int tq, int tk, int heads, int d, float scale,
                int causal, smx::Dropout drop, cudaStream_t stream) {
  BwdArgs p;
  bool mapped;
  if constexpr (MAP4) {
    mapped = hw::make_map_heads(&p.q, q, batch, tq, heads, d, BT) &&
             hw::make_map_heads(&p.g, g, batch, tq, heads, d, BT) &&
             hw::make_map_heads(&p.k, k, batch, tk, heads, d, BT) &&
             hw::make_map_heads(&p.v, v, batch, tk, heads, d, BT);
  } else {
    const uint64_t cols = (uint64_t)heads * 64;
    mapped = hw::make_map3(&p.q, q, batch, tq, cols, BT, 64) &&
             hw::make_map3(&p.g, g, batch, tq, cols, BT, 64) &&
             hw::make_map3(&p.k, k, batch, tk, cols, BT, 64) &&
             hw::make_map3(&p.v, v, batch, tk, cols, BT, 64);
  }
  if (!mapped) return static_cast<int>(cudaErrorInvalidValue);
  p.mask = mask;
  p.lse = lse;
  p.delta = delta;
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.keep = keep;
  p.tq = tq;
  p.tk = tk;
  p.heads = heads;
  p.d = d;
  p.scale = scale;
  p.causal = causal;
  p.drop = drop;
  const size_t smem_kv = dkdv_smem_bytes<DP>(),
               smem_q = dq_smem_bytes<DP>(tk);
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<DP, MAP4, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dq_kernel<DP, MAP4, DROP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = launch_delta<bf16>(g, out, delta, batch, tq, heads, d,
                                    stream);
  if (rc != 0) return rc;
  constexpr int rows = Bwd<DP>::BLOCK_ROWS;
  dkdv_kernel<DP, MAP4, DROP>
      <<<dim3((tk + rows - 1) / rows, heads, batch), BF16_THREADS, smem_kv,
         stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<DP, MAP4, DROP>
      <<<dim3((tq + rows - 1) / rows, heads, batch), BF16_THREADS, smem_q,
         stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ float32
// 64 x 64 block products over a depth K by the 256 threads of a block, each
// a 4 x 4 patch.  A(m, k) is A[m * LDA + k], or A[k * LDA + m] with TA;
// B(k, n) is B[k * LDB + n], or B[n * LDB + k] with TB.  Tiles of 64 rows
// by the padded head width DP have rows of LDD = DP + 4 floats; 64 x 64
// tiles (s, dp, p, ds) rows of LD.
constexpr int LD = 68;   // tile row (float4-aligned), operands and staging
template <int DP>
__host__ __device__ constexpr int ldd() {
  return DP + 4;
}

struct Acc {
  float v[4][4];  // rows ty * 4 .., columns tx * 4 ..
};

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc.v[i][j] = 0.0f;
}

template <bool TA, bool TB, int K, int LDA, int LDB>
__device__ __forceinline__ void mma(Acc& acc, const float* A, const float* B) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = TA ? A[k * LDA + ty * 4 + i] : A[(ty * 4 + i) * LDA + k];
      b[i] = TB ? B[(tx * 4 + i) * LDB + k] : B[k * LDB + tx * 4 + i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc.v[i][j] += a[i] * b[j];
  }
}

template <int LDC>
__device__ __forceinline__ void store(Acc& acc, float* C, float mult) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      C[(ty * 4 + i) * LDC + tx * 4 + j] = acc.v[i][j] * mult;
}

// rows t0 .. t0 + 63 (zero past tmax) of one head of a slab into a tile of
// DP columns (zero past d), in 16-byte words
template <int DP>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          long long row, int t0, int tmax,
                                          int d) {
  constexpr int VEC = 4;
  for (int i = threadIdx.x; i < BT * (DP / VEC); i += NT) {
    const int r = i / (DP / VEC), c = (i % (DP / VEC)) * VEC;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (t0 + r < tmax && c < d) {
      val = *reinterpret_cast<const float4*>(src + (t0 + r) * row + c);
    }
    *reinterpret_cast<float4*>(dst + r * ldd<DP>() + c) = val;
  }
}

// rows t0 .. of a staged tile (DP columns) into one head of a slab, its d
// columns
template <int DP>
__device__ __forceinline__ void write_tile(float* __restrict__ dst,
                                           const float* src, long long row,
                                           int t0, int tmax, int d) {
  for (int i = threadIdx.x; i < BT * DP; i += NT) {
    const int r = i / DP, c = i % DP;
    if (t0 + r < tmax && c < d) dst[(t0 + r) * row + c] = src[r * ldd<DP>() + c];
  }
}

// four operand tiles of 64 x DP, four 64 x 64 tiles (s, dp, p, ds)
template <int DP>
constexpr size_t smem_f32() {
  return (size_t)(4 * BT * ldd<DP>() + 4 * BT * LD) * sizeof(float);
}

// p and ds of one 64 x 64 tile from the staged s and dp, with the dropout
// mask m (= 1 without DROP): ps = p * m, dss = p * (dp * m - delta); one
// Philox call per four columns of a row.  ps may be null.
template <bool DROP>
__device__ __forceinline__ void probs_and_ds(
    const float* sf, const float* dpf, float* ps, float* dss,
    const float* lse_s, const float* delta_s, const unsigned char* kmask_s,
    int q0, int k0, int tq, int tk, float scale, int causal,
    const smx::Dropout& drop, long long row0) {
  const float inv_tk = 1.0f / (float)tk;
  for (int i = threadIdx.x; i < BT * (BT / 4); i += NT) {
    const int r = i / (BT / 4), c4 = (i % (BT / 4)) * 4;
    const int qi = q0 + r;
    uint4 bits = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (DROP) bits = drop.bits4(row0 + qi, (k0 + c4) / 4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c4 + j, kj = k0 + c;
      float p = 0.0f;
      if (qi < tq && kj < tk) {
        const float l = lse_s[r];
        if (l <= kAllMasked) {
          p = inv_tk;
        } else {
          const float x = (!kmask_s[c] || (causal && kj > qi))
                              ? kNegInf : sf[r * LD + c] * scale;
          p = expf(x - l);
        }
      }
      const float m = DROP ? drop.keep(smx::word(bits, j)) : 1.0f;
      if (ps != nullptr) ps[r * LD + c] = p * m;
      dss[r * LD + c] = p * (dpf[r * LD + c] * m - delta_s[r]);
    }
  }
}

template <int DP, bool DROP>
__global__ void __launch_bounds__(NT)
    attention_bwd_dkdv_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ g,
                              const unsigned char* __restrict__ mask,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int tq, int tk, int heads, int d, float scale,
                              int causal, smx::Dropout drop) {
  constexpr int NB = DP / 64, LDD = ldd<DP>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + BT * LDD;
  float* qs = vs + BT * LDD;
  float* gs = qs + BT * LDD;
  float* ps = gs + BT * LDD;
  float* dss = ps + BT * LD;
  float* sf = dss + BT * LD;
  float* dpf = sf + BT * LD;
  __shared__ float lse_s[BT], delta_s[BT];
  __shared__ unsigned char kmask_s[BT];
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BT, head = blockIdx.y, b = blockIdx.z;
  const long long row = (long long)heads * d;
  const float* qb = q + (long long)b * tq * row + head * d;
  const float* gb = g + (long long)b * tq * row + head * d;
  const float* kb = k + (long long)b * tk * row + head * d;
  const float* vb = v + (long long)b * tk * row + head * d;
  const float* lb = lse + ((long long)b * heads + head) * tq;
  const float* db = delta + ((long long)b * heads + head) * tq;

  load_tile<DP>(ks, kb, row, k0, tk, d);
  load_tile<DP>(vs, vb, row, k0, tk, d);
  if (tid < BT) {
    kmask_s[tid] = k0 + tid < tk ? mask[(long long)b * tk + k0 + tid] : 0;
  }
  Acc dk_acc[NB], dv_acc[NB];
#pragma unroll
  for (int h = 0; h < NB; ++h) {
    zero(dk_acc[h]);
    zero(dv_acc[h]);
  }

  for (int q0 = 0; q0 < tq; q0 += BT) {
    __syncthreads();  // the last tile's readers of qs, gs, ps, dss are done
    load_tile<DP>(qs, qb, row, q0, tq, d);
    load_tile<DP>(gs, gb, row, q0, tq, d);
    if (tid < BT) {
      const bool in = q0 + tid < tq;
      lse_s[tid] = in ? lb[q0 + tid] : 0.0f;
      delta_s[tid] = in ? db[q0 + tid] : 0.0f;
    }
    __syncthreads();
    {
      Acc s_acc, dp_acc;
      zero(s_acc);
      mma<false, true, DP, LDD, LDD>(s_acc, qs, ks);   // q k^T
      store<LD>(s_acc, sf, 1.0f);
      zero(dp_acc);
      mma<false, true, DP, LDD, LDD>(dp_acc, gs, vs);  // g v^T
      store<LD>(dp_acc, dpf, 1.0f);
    }
    __syncthreads();
    probs_and_ds<DROP>(sf, dpf, ps, dss, lse_s, delta_s, kmask_s, q0, k0, tq,
                       tk, scale, causal, drop,
                       ((long long)b * heads + head) * tq);
    __syncthreads();
#pragma unroll
    for (int h = 0; h < NB; ++h) {
      mma<true, false, BT, LD, LDD>(dv_acc[h], ps, gs + 64 * h);   // p^T g
      mma<true, false, BT, LD, LDD>(dk_acc[h], dss, qs + 64 * h);  // ds^T q
    }
  }
  __syncthreads();
  // stage dv and dk in the q and g tiles' place
#pragma unroll
  for (int h = 0; h < NB; ++h) {
    store<LDD>(dv_acc[h], qs + 64 * h, 1.0f);
    store<LDD>(dk_acc[h], gs + 64 * h, scale);
  }
  __syncthreads();
  write_tile<DP>(dv + (long long)b * tk * row + head * d, qs, row, k0, tk, d);
  write_tile<DP>(dk + (long long)b * tk * row + head * d, gs, row, k0, tk, d);
}

template <int DP, bool DROP>
__global__ void __launch_bounds__(NT)
    attention_bwd_dq_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ g,
                            const unsigned char* __restrict__ mask,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, int tq, int tk, int heads,
                            int d, float scale, int causal,
                            smx::Dropout drop) {
  constexpr int NB = DP / 64, LDD = ldd<DP>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + BT * LDD;
  float* qs = vs + BT * LDD;
  float* gs = qs + BT * LDD;
  float* dss = gs + BT * LDD;
  float* sf = dss + 2 * BT * LD;
  float* dpf = sf + BT * LD;
  __shared__ float lse_s[BT], delta_s[BT];
  __shared__ unsigned char kmask_s[BT];
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BT, head = blockIdx.y, b = blockIdx.z;
  const long long row = (long long)heads * d;
  const float* kb = k + (long long)b * tk * row + head * d;
  const float* vb = v + (long long)b * tk * row + head * d;

  load_tile<DP>(qs, q + (long long)b * tq * row + head * d, row, q0, tq, d);
  load_tile<DP>(gs, g + (long long)b * tq * row + head * d, row, q0, tq, d);
  if (tid < BT) {
    const bool in = q0 + tid < tq;
    const long long at = ((long long)b * heads + head) * tq + q0 + tid;
    lse_s[tid] = in ? lse[at] : 0.0f;
    delta_s[tid] = in ? delta[at] : 0.0f;
  }
  Acc dq_acc[NB];
#pragma unroll
  for (int h = 0; h < NB; ++h) zero(dq_acc[h]);

  for (int k0 = 0; k0 < tk; k0 += BT) {
    __syncthreads();  // the last tile's readers of ks, vs, dss are done
    load_tile<DP>(ks, kb, row, k0, tk, d);
    load_tile<DP>(vs, vb, row, k0, tk, d);
    if (tid < BT) {
      kmask_s[tid] = k0 + tid < tk ? mask[(long long)b * tk + k0 + tid] : 0;
    }
    __syncthreads();
    {
      Acc s_acc, dp_acc;
      zero(s_acc);
      mma<false, true, DP, LDD, LDD>(s_acc, qs, ks);
      store<LD>(s_acc, sf, 1.0f);
      zero(dp_acc);
      mma<false, true, DP, LDD, LDD>(dp_acc, gs, vs);
      store<LD>(dp_acc, dpf, 1.0f);
    }
    __syncthreads();
    probs_and_ds<DROP>(sf, dpf, nullptr, dss, lse_s, delta_s, kmask_s, q0,
                       k0, tq, tk, scale, causal, drop,
                       ((long long)b * heads + head) * tq);
    __syncthreads();
#pragma unroll
    for (int h = 0; h < NB; ++h) {
      mma<false, false, BT, LD, LDD>(dq_acc[h], dss, ks + 64 * h);  // ds k
    }
  }
  __syncthreads();
  // stage dq in the k tile's place
#pragma unroll
  for (int h = 0; h < NB; ++h) store<LDD>(dq_acc[h], ks + 64 * h, scale);
  __syncthreads();
  write_tile<DP>(dq + (long long)b * tq * row + head * d, ks, row, q0, tq, d);
}

template <int DP, bool DROP>
int launch_f32(const void* q, const void* k, const void* v, const void* out,
               const void* g, const unsigned char* mask, const float* lse,
               float* delta, void* dq, void* dk, void* dv, int batch, int tq,
               int tk, int heads, int d, float scale, int causal,
               smx::Dropout drop, cudaStream_t stream) {
  constexpr size_t smem = smem_f32<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dkdv_kernel<DP, DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attention_bwd_dq_kernel<DP, DROP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* gp = static_cast<const float*>(g);
  const int rc = launch_delta<float>(g, out, delta, batch, tq, heads, d,
                                     stream);
  if (rc != 0) return rc;
  attention_bwd_dkdv_kernel<DP, DROP>
      <<<dim3((tk + BT - 1) / BT, heads, batch), NT, smem, stream>>>(
          qp, kp, vp, gp, mask, lse, delta, static_cast<float*>(dk),
          static_cast<float*>(dv), tq, tk, heads, d, scale, causal, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dq_kernel<DP, DROP>
      <<<dim3((tq + BT - 1) / BT, heads, batch), NT, smem, stream>>>(
          qp, kp, vp, gp, mask, lse, delta, static_cast<float*>(dq), tq, tk,
          heads, d, scale, causal, drop);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <bool DROP>
int entry(const void* q, const void* k, const void* v, const void* out,
          const void* g, const unsigned char* mask, const float* lse,
          float* delta, uint16_t* keep, void* dq, void* dk, void* dv,
          int batch, int tq, int tk, int heads, int head_dim, float scale,
          int causal, smx::Dropout drop, int dtype, int device,
          void* stream) {
  if (head_dim < 8 || head_dim > 128 || head_dim % 8 || batch <= 0 ||
      tq <= 0 || tk <= 0 || heads <= 0 || heads > 65535 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // every slab is read and written in 16-byte words (TMA in bf16)
  const void* slabs[] = {q, k, v, out, g, dq, dk, dv};
  for (const void* p : slabs) {
    if (!aligned16(p)) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == smx::kBF16) {
    if (DROP && (keep == nullptr || !aligned16(keep))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int d = head_dim;
    if (d == 64) {
      return launch_bf16<64, false, DROP>(q, k, v, out, g, mask, lse, delta,
                                          keep, dq, dk, dv, batch, tq, tk,
                                          heads, d, scale, causal, drop, s);
    }
    if (d < 64) {
      return launch_bf16<64, true, DROP>(q, k, v, out, g, mask, lse, delta,
                                         keep, dq, dk, dv, batch, tq, tk,
                                         heads, d, scale, causal, drop, s);
    }
    return launch_bf16<128, true, DROP>(q, k, v, out, g, mask, lse, delta,
                                        keep, dq, dk, dv, batch, tq, tk, heads,
                                        d, scale, causal, drop, s);
  }
  if (head_dim <= 64) {
    return launch_f32<64, DROP>(q, k, v, out, g, mask, lse, delta, dq, dk, dv,
                                batch, tq, tk, heads, head_dim, scale, causal,
                                drop, s);
  }
  return launch_f32<128, DROP>(q, k, v, out, g, mask, lse, delta, dq, dk, dv,
                               batch, tq, tk, heads, head_dim, scale, causal,
                               drop, s);
}

}  // namespace

extern "C" int smx_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* out, const void* g,
                                 const unsigned char* mask, const float* lse,
                                 float* delta, void* dq, void* dk, void* dv,
                                 int batch, int tq, int tk, int heads,
                                 int head_dim, float scale, int causal,
                                 int dtype, int device, void* stream) {
  return entry<false>(q, k, v, out, g, mask, lse, delta, nullptr, dq, dk, dv,
                      batch, tq, tk, heads, head_dim, scale, causal,
                      smx::Dropout{}, dtype, device, stream);
}

// K15: the forward's key (k0, k1) and the probability mask's threshold and
// scale, from the host; `out` is K14's (dropped) output.  keep: in bfloat16
// a (B*H*Tq, 4 ceil(Tk / 64)) uint16 workspace, 16-byte aligned (float32
// regenerates the mask in both passes and takes null).
extern "C" int smx_attention_dropout_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* g, const unsigned char* mask, const float* lse, float* delta,
    void* keep, void* dq, void* dk, void* dv, int batch, int tq, int tk,
    int heads, int head_dim, float scale, int causal, uint32_t k0,
    uint32_t k1, uint32_t threshold, float drop_scale, int dtype, int device,
    void* stream) {
  return entry<true>(
      q, k, v, out, g, mask, lse, delta, static_cast<uint16_t*>(keep), dq, dk,
      dv, batch, tq, tk, heads, head_dim, scale, causal,
      smx::make_dropout(k0, k1, smx::kStreamAct, threshold, drop_scale), dtype,
      device, stream);
}
