// K7: attention_bwd — backward of masked multi-head attention,
//   out = softmax(q k^T * scale + mask) v,  per (batch, head),
// on the (B, T, H*D) projection slabs, any head width D that is a multiple
// of 8 with 8 <= D <= 128: given g = d(out) it writes dq,
// dk and dv with the probabilities recomputed on chip (entry
// smx_attention_bwd).  K15: attention_dropout_bwd — the same for K14's
// out = (p * m) v (entry smx_attention_dropout_bwd), with the mask m
// regenerated from dropout.cuh (the forward's key, stream 0, row
// (b * H + h) * Tq + q, column k; in float32 per stage in both tiled
// passes, in bfloat16 by the dk/dv pass, which hands its bits to the dq
// pass):
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
// Both tiled passes recompute s = q k^T and dp = g v^T.  In float32 they
// are one grid (attention_bwd_f32_kernel: its first blocks the dk/dv pass,
// the rest the dq pass), so that neither ends in a partial wave of its own.
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
// float32 (the f32 path, the default dtype): the same three passes, every
// product on the tensor cores as three tf32 wgmma of split operands, hi hi
// + hi lo + lo hi, f32-accurate at up to 165 TFLOP/s of f32 work on this
// card against the CUDA cores' 67.  What bounds it: the products (10 H D
// FLOPs per allowed pair, 14 with s and dp twice) on the tensor cores,
// where an m64n32k8 with both operands in shared memory runs at two thirds
// of the tf32 rate, held by shared memory's 128 bytes a cycle (an m64n64k8
// at the full rate: time_wgmma_tf32.py), and beside them, on the CUDA
// cores, the split of every stage and the softmax.  The design:
//   * a block owns 64 rows (keys in the dk/dv pass, queries in the dq
//     pass) as the products' M and streams the other side in 32-row
//     stages.  A producer warpgroup loads the own rows once and each stage
//     into one of two work slots with TMA (make_map_heads maps in 32-column
//     f32 boxes: zeros past D, and past T within the batch), one stage
//     ahead, and splits them in place: the tensor cores read the top 19
//     bits of an f32 operand, so v as TMA wrote it is its own hi half and
//     the split writes lo = tf32(v - trunc(v)) beside it.  tf32 wgmma reads
//     K-major operands only, so the split also writes the transposed copy
//     (hi and lo) of each operand that a product over the stage's rows
//     reads (q^T, g^T in the dk/dv pass, k^T in the dq pass): no transpose
//     in device memory.  It stages each query stage's lse and delta;
//   * two consumer warpgroups share each stage, one a role, so that one's
//     CUDA-core work runs while the other's products do: the s role
//     forms s^T = k q^T (dq pass: s = q k^T), p and, in the dk/dv pass, dv
//     += (p m)^T g; the dp role forms dp^T = v g^T (dp = g v^T), ds = p (dp
//     m - delta) and dk += ds^T q (dq += ds k).  p goes from the one to the
//     other through shared memory, a dropped element as -p, so that the s
//     role alone draws K15's Philox words (per stage in both passes, shared
//     across the lanes that hold their four keys: no workspace);
//   * s and dp are m64n32k8 products over the padded head's DP / 8 slices;
//     p and ds stay in registers, as tf32 halves, as the A operands of the
//     m64n64k8 products over the stage.  An f32 accumulator holds columns
//     2 (t % 4) + {0, 1} of each 8 where tf32's A fragment holds t % 4 and
//     t % 4 + 4, so the transposed copies lay each 8 rows in the order 0,
//     2, 4, 6, 1, 3, 5, 7 (hopper.cuh: wgmma_m64n64k8_tf32_rs);
//   * the products over a stage's rows start a partial (12 tf32 products)
//     that the CUDA cores add to the f32 sums once the stage is done: the
//     tensor cores' sums drop low bits over a long K (PERF.md), and
//     these products contract over Tq or Tk.  A product that starts an
//     accumulator takes it as an output only, and no instruction outside
//     the products defines an accumulator before the loop: either would
//     make ptxas serialize the products;
//   * p = 2^(s * scale log2(e) - lse log2(e)) by ex2.approx (relative error
//     ~2^-22, as in the bf16 body).
// Shared memory at DP = 64: the dk/dv pass k, v with their lo halves 64 KB
// and two slots of q, g, q^T, g^T, hi and lo, and p, 72 KB each (208 KB);
// the dq pass q, g 64 KB and two slots of k, v, k^T and p, 56 KB each
// (176 KB).  One block, three warpgroups, an SM.
//
// Head widths.  Both bodies are built for a padded width DP, 64 or 128.
// Other widths compute over DP columns whose part past D is zeros (the
// kernels read the slabs through 4-D tensor maps with the head as its own
// dimension, hopper.cuh's make_map_heads, so that TMA fills those columns
// with zeros instead of reading the next head), and store D columns; bf16
// D = 64 reads 3-D maps.  In bf16, at DP = 128 a 64-row operand tile is
// two 64-column boxes; the products over the head (s, dp) take eight k16
// slices; and a block holds 64 keys (dk/dv pass) or 64 queries (dq pass)
// instead of 128: both consumer warpgroups form the same s, dp, p and ds,
// and each accumulates dk, dv or dq for one 64-column half of the head, so
// that every accumulator stays at 32 registers a thread (two halves in one
// warpgroup would need 64 each, beyond the 240 that setmaxnreg gives).  In
// f32 at DP = 128 the own tiles double (128 KB), so one work slot (dk/dv
// 96 KB, dq 80 KB) and one consumer warpgroup with both roles, whose
// accumulators hold one 64-column half: two blocks share a tile, each
// forming s and dp.  The shared s and dp products are computed twice: a
// simple body that is right.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hw = smx::hopper;
using bf16 = __nv_bfloat16;

constexpr int BT = 64;    // tile edge, queries and keys
constexpr int NT = 256;   // threads of the delta kernel
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
// The f32 body (see the header): a block's 64 own rows are the products' M,
// the other side streams in 32-row stages, every product is three tf32
// wgmma of split operands.
constexpr int FR = 64;                 // a block's own rows
constexpr int SR = 32;                 // a stage's rows (queries or keys)
constexpr int ROW_BYTES = 128;         // a row of a 32-column f32 box

// The consumer warpgroups' roles: kRoleS forms s (and p) and, in the dk/dv
// pass, dv; kRoleDp forms dp, ds and dk or dq; one warpgroup with both
// roles does everything.
constexpr int kRoleS = 1, kRoleDp = 2, kRoleBoth = 3;

// DP: the padded head width; a block accumulates the 64 columns 64 half ..
// of the head's DP (NH blocks per tile); a row of a tile is NB boxes of 32
// columns.  Tiles, each a hi (tf32) and a lo half: OWN the block's own
// rows, NAT a stage's rows, TR the transposed 64 columns of a stage (64
// rows of SR).  At DP = 64 two consumer warpgroups, one a role, share each
// stage in one of two work slots (p handed over in PBUF bytes a slot); at
// DP = 128, whose own tiles leave room for one slot, one warpgroup takes
// both roles.
template <int DP>
struct F32 {
  static constexpr int NH = DP / 64;
  static constexpr int NB = DP / 32;
  static constexpr int OWN = FR * DP * 4;
  static constexpr int NAT = SR * DP * 4;
  static constexpr int TR = 64 * SR * 4;
  // the dk/dv pass's work slot: q, g (hi, lo), q^T, g^T (hi, lo)
  static constexpr int KV_WORK = 4 * NAT + 4 * TR;
  // the dq pass's work slot: k, v (hi, lo), k^T (hi, lo)
  static constexpr int Q_WORK = 4 * NAT + 2 * TR;
  static constexpr int CONS = DP == 64 ? 2 : 1;    // consumer warpgroups
  static constexpr int SLOTS = DP == 64 ? 2 : 1;   // work slots
  static constexpr int PBUF = CONS > 1 ? SR / 2 * WG * 4 : 0;
  static constexpr int THREADS = (CONS + 1) * WG;  // + a producer warpgroup
};

struct F32Args {
  // the block's own rows (64-row boxes) and the streamed side (32-row
  // boxes): k, v and q, g in the dk/dv pass, q, g and k, v in the dq pass;
  // make_map_heads maps in 32-column boxes (zeros past D)
  CUtensorMap own_a, own_b, st_a, st_b;
  const unsigned char* mask;
  const float* lse;
  const float* delta;
  float* out_a;  // dk or dq
  float* out_b;  // dv (dk/dv pass)
  int tq, tk, heads, d;
  float scale;
  int causal;
  smx::Dropout drop;
};

// lse * log2(e) and delta of a stage's queries (the dk/dv pass), 0 past Tq
struct F32Rows {
  float lse2[SR];
  float delta[SR];
};



// The barriers of the f32 passes: the own rows landed (TMA) and split (the
// producer warpgroup); per work slot its stage landed (TMA), split (the
// producer warpgroup), free again (every consumer warpgroup) and, with two
// consumer warpgroups, its p handed over (the s role).
struct F32Bars {
  uint64_t own_full, own_ready;
  uint64_t land[2], ready[2], empty[2], p_ready[2];
};

template <int DP>
__device__ __forceinline__ void init_f32_bars(F32Bars* bars) {
  using G = F32<DP>;
  if (threadIdx.x == 0) {
    hw::mbar_init(&bars->own_full, 1);
    hw::mbar_init(&bars->own_ready, WG);
    for (int s = 0; s < G::SLOTS; ++s) {
      hw::mbar_init(&bars->land[s], 1);
      hw::mbar_init(&bars->ready[s], WG);
      hw::mbar_init(&bars->empty[s], G::CONS * WG);
      hw::mbar_init(&bars->p_ready[s], WG);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();
}

// The slot and the parity of stage n's barriers: its slot's n / SLOTS-th
// use
template <int DP>
__device__ __forceinline__ int slot_of(int n) {
  return n % F32<DP>::SLOTS;
}
template <int DP>
__device__ __forceinline__ uint32_t parity_of(int n) {
  return (uint32_t)(n / F32<DP>::SLOTS) & 1u;
}

// The split, in place, of one streamed slab's stage as TMA wrote it at hi
// (SR rows of NB swizzled boxes): the lo half of each element at hi + NAT.
// With T the head's columns 64 half .. + 63 also go, hi and lo, to the
// transposed tile at t_hi (64 rows of SR, K-major for the products that
// contract over the stage's rows), stage row r at position 8 (r / 8) +
// pos(r % 8), pos = 0, 4, 1, 5, 2, 6, 3, 7: the order in which an
// accumulator's columns enter wgmma_m64n64k8_tf32_rs's A fragment.  Thread
// tid of the warpgroup takes row tid % SR and every fourth 16-byte word of
// it, so a warp's loads and its transposed stores meet no bank twice.
template <int DP, bool T>
__device__ __forceinline__ void split_stage(uint8_t* hi, uint8_t* t_hi,
                                            int half, int tid) {
  using G = F32<DP>;
  const int r = tid % SR;
  const int k = (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);
#pragma unroll
  for (int ch = tid / SR; ch < DP / 4; ch += WG / SR) {
    const int at = (ch / 8) * SR * ROW_BYTES + r * ROW_BYTES +
                   (((ch % 8) ^ (r % 8)) << 4);
    const float4 v = *reinterpret_cast<const float4*>(hi + at);
    const float h[4] = {v.x, v.y, v.z, v.w};
    const float l[4] = {hw::tf32_lo(v.x), hw::tf32_lo(v.y),
                        hw::tf32_lo(v.z), hw::tf32_lo(v.w)};
    *reinterpret_cast<float4*>(hi + G::NAT + at) =
        make_float4(l[0], l[1], l[2], l[3]);
    if constexpr (T) {
      const int n0 = 4 * ch - 64 * half;  // the chunk's first transposed row
      if (n0 >= 0 && n0 < 64) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = n0 + e;
          const int o =
              n * ROW_BYTES + (((k >> 2) ^ (n & 7)) << 4) + (k & 3) * 4;
          *reinterpret_cast<float*>(t_hi + o) = h[e];
          *reinterpret_cast<float*>(t_hi + G::TR + o) = l[e];
        }
      }
    }
  }
}

// x (64 x SR) = A B^T over the head's DP / 8 k8 slices: A the block's own
// 64 rows (hi tile at a, lo at a + OWN), B a stage's SR rows (hi at b, lo
// at b + NAT), both K-major in 32-column boxes; every slice, also past D
// (zeros there): a loop that stopped at D would put the products on a
// divergent path, which ptxas serializes.  The first product starts x
// afresh, x an output only: an input would keep x's registers live from
// the stage before, and ptxas serializes the products in flight when it
// must move them.
template <int DP>
__device__ __forceinline__ void product_head(float (&x)[SR / 2],
                                             const uint8_t* a,
                                             const uint8_t* b) {
  using G = F32<DP>;
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    const int ao = (kk / 4) * FR * ROW_BYTES + (kk % 4) * 32;
    const int bo = (kk / 4) * SR * ROW_BYTES + (kk % 4) * 32;
    const uint64_t ah = hw::desc_sw128(a + ao, 16, 1024);
    const uint64_t al = hw::desc_sw128(a + G::OWN + ao, 16, 1024);
    const uint64_t bh = hw::desc_sw128(b + bo, 16, 1024);
    const uint64_t bl = hw::desc_sw128(b + G::NAT + bo, 16, 1024);
    if (kk == 0) {
      hw::wgmma_m64n32k8_tf32_zero(x, al, bh);
    } else {
      hw::wgmma_m64n32k8_tf32(x, al, bh, 1);
    }
    hw::wgmma_m64n32k8_tf32(x, ah, bl, 1);
    hw::wgmma_m64n32k8_tf32(x, ah, bh, 1);
  }
}

// x (64 x 64) = X t: X in registers (to_fragments' tf32 halves of a 64 x
// SR accumulator), t a transposed tile (hi at t, lo at t + TR); x starts
// afresh as in product_head
__device__ __forceinline__ void product_rs(float (&x)[32],
                                           const uint32_t (&xh)[SR / 8][4],
                                           const uint32_t (&xl)[SR / 8][4],
                                           const uint8_t* t, int tr) {
#pragma unroll
  for (int j = 0; j < SR / 8; ++j) {
    const uint64_t bh = hw::desc_sw128(t + 32 * j, 16, 1024);
    const uint64_t bl = hw::desc_sw128(t + tr + 32 * j, 16, 1024);
    if (j == 0) {
      hw::wgmma_m64n64k8_tf32_rs_zero(x, xl[j], bh);
    } else {
      hw::wgmma_m64n64k8_tf32_rs(x, xl[j], bh, 1);
    }
    hw::wgmma_m64n64k8_tf32_rs(x, xh[j], bl, 1);
    hw::wgmma_m64n64k8_tf32_rs(x, xh[j], bh, 1);
  }
}

// one thread's 64 x 64 accumulator times `mult` into one head of a slab
// (`out` at its row 0, column 0): rows row + 8 i < tmax, columns col0 + 8 j
// + 2 (t % 4) + c < d
__device__ __forceinline__ void store_f32(float* __restrict__ out,
                                          const float (&acc)[32], int row,
                                          int tmax, long long stride,
                                          float mult, int lane, int col0,
                                          int d) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row + 8 * i >= tmax) continue;
    float* at = out + (row + 8 * i) * stride + col0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // D is a multiple of 8: a column group is wholly in or past it
      if (col0 + 8 * j >= d) continue;
      *reinterpret_cast<float2*>(at + 8 * j) = make_float2(
          acc[4 * j + 2 * i] * mult, acc[4 * j + 2 * i + 1] * mult);
    }
  }
}

__device__ __forceinline__ uint32_t keep_nibble(const uint4& w,
                                                uint32_t th) {
  return (uint32_t)(w.x >= th) | (uint32_t)(w.y >= th) << 1 |
         (uint32_t)(w.z >= th) << 2 | (uint32_t)(w.w >= th) << 3;
}

// The dk/dv pass's keep bits of a thread's SR / 2 elements of an s^T stage,
// bit 4 j + 2 i + c: key row + 8 i, query q0 + 8 j + 2 (lane % 4) + c.  A
// Philox call covers four keys of one query, held by the four lanes u =
// (lane / 4) % 4 of one column: each draws a quarter of the column's words
// and the four share the nibbles (drop_mask_t's scheme; kgroup: the 4-key
// group of the warp's first key).
__device__ __forceinline__ uint32_t keep_bits_t(const F32Args& p,
                                                long long bh, int q0,
                                                int kgroup, int lane) {
  const int t = lane & 3, u = (lane >> 2) & 3, a = lane >> 4;
  uint32_t nib = 0;
#pragma unroll
  for (int blk = 0; blk < SR / 16; ++blk)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = 4 * blk + u;  // this lane's column: 2 j + c
      const uint4 w =
          p.drop.bits4(bh * p.tq + q0 + 8 * (e >> 1) + 2 * t + (e & 1),
                       kgroup + 2 * i + a);
      nib |= keep_nibble(w, p.drop.threshold) << (4 * (2 * blk + i));
    }
  uint32_t nx[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    nx[x] = __shfl_sync(0xffffffffu, nib, (lane & ~12) | (x << 2)) >> u;
  }
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < SR / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 2 * j + c;
        bits |= ((nx[e & 3] >> (4 * (2 * (e >> 2) + i))) & 1u)
                << (4 * j + 2 * i + c);
      }
  return bits;
}

// The dq pass's keep bits of a thread's SR / 2 elements of an s stage, bit
// 4 j + 2 i + c: query qi[i], key k0 + 8 j + 2 t + c (t = lane % 4).  Lanes
// t and t ^ 1 hold the four keys of one Philox call: each draws the calls
// of every other j and hands the other its nibbles.
__device__ __forceinline__ uint32_t keep_bits_q(const F32Args& p,
                                                long long bh,
                                                const int (&qi)[2], int k0,
                                                int lane) {
  const int t = lane & 3, odd = t & 1;
  uint32_t bits = 0;
#pragma unroll
  for (int jj = 0; jj < SR / 16; ++jj)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int jm = 2 * jj + odd, jo = 2 * jj + (odd ^ 1);
      const uint4 w = p.drop.bits4(bh * p.tq + qi[i],
                                   (k0 + 8 * jm) / 4 + (t >> 1));
      const uint32_t mine = keep_nibble(w, p.drop.threshold);
      const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 1);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        bits |= ((mine >> (2 * odd + c)) & 1u) << (4 * jm + 2 * i + c);
        bits |= ((other >> (2 * odd + c)) & 1u) << (4 * jo + 2 * i + c);
      }
    }
  return bits;
}


// The producer warpgroup: its thread 0 loads the block's own rows of both
// slabs once (at own and own + 2 OWN) and stage n's SR rows of the other
// side into work slot n % SLOTS with TMA, each as soon as the consumers
// free the slot (one stage ahead with two slots); every thread splits the
// own rows once, then each landed stage in place (a, b and the transposed
// a; with TB the transposed b too) and, with ROWS, stages its lse and delta
// (the dk/dv pass).  With two slots the split of one stage runs while the
// consumers multiply the other.
template <int DP, bool ROWS, bool TB>
__device__ __forceinline__ void produce_f32(const F32Args& p, uint8_t* own,
                                            uint8_t* work, int work_bytes,
                                            F32Rows* rows, F32Bars* bars,
                                            int head, int r0, int b,
                                            int tiles, long long bh,
                                            int half) {
  using G = F32<DP>;
  constexpr int NAT = G::NAT, TR = G::TR;
  const int tid = threadIdx.x - G::CONS * WG;
  // stage n's rows of both slabs into its slot, once the slot is free
  auto load = [&](int n) {
    const int w = slot_of<DP>(n);
    uint8_t* wk = work + w * work_bytes;
    hw::mbar_wait(&bars->empty[w], parity_of<DP>(n) ^ 1);
    hw::mbar_expect_tx(&bars->land[w], 2 * NAT);
#pragma unroll
    for (int x = 0; x < G::NB; ++x) {
      hw::tma_load_head(wk + x * SR * ROW_BYTES, &p.st_a, &bars->land[w],
                        32 * x, head, n * SR, b);
      hw::tma_load_head(wk + 2 * NAT + x * SR * ROW_BYTES, &p.st_b,
                        &bars->land[w], 32 * x, head, n * SR, b);
    }
  };
  if (tid == 0) {
    hw::mbar_expect_tx(&bars->own_full, 2 * G::OWN);
#pragma unroll
    for (int x = 0; x < G::NB; ++x) {
      hw::tma_load_head(own + x * FR * ROW_BYTES, &p.own_a, &bars->own_full,
                        32 * x, head, r0, b);
      hw::tma_load_head(own + 2 * G::OWN + x * FR * ROW_BYTES, &p.own_b,
                        &bars->own_full, 32 * x, head, r0, b);
    }
    load(0);
  }
  hw::mbar_wait(&bars->own_full, 0);
  hw::split_lo(own, G::OWN, tid, WG);
  hw::split_lo(own + 2 * G::OWN, G::OWN, tid, WG);
  hw::fence_async_smem();
  hw::mbar_arrive(&bars->own_ready);
  for (int n = 0; n < tiles; ++n) {
    const int w = slot_of<DP>(n);
    uint8_t* wk = work + w * work_bytes;
    hw::mbar_wait(&bars->land[w], parity_of<DP>(n));
    split_stage<DP, true>(wk, wk + 4 * NAT, half, tid);
    split_stage<DP, TB>(wk + 2 * NAT, wk + 4 * NAT + 2 * TR, half, tid);
    if constexpr (ROWS) {
      if (tid < SR) {
        const int qi = n * SR + tid;
        const bool in = qi < p.tq;
        rows[w].lse2[tid] = in ? p.lse[bh * p.tq + qi] * kLog2e : 0.0f;
        rows[w].delta[tid] = in ? p.delta[bh * p.tq + qi] : 0.0f;
      }
    }
    hw::fence_async_smem();
    hw::mbar_arrive(&bars->ready[w]);
    if (tid == 0 && n + 1 < tiles) load(n + 1);
  }
}

// The s role's p of a thread's SR / 2 elements to the dp role's same
// thread, through the slot's hand-over tile: with DROP a dropped element
// goes as -p (p >= 0, and -0 keeps its sign), so that the mask is drawn
// once.
template <bool DROP>
__device__ __forceinline__ void hand_p(float* pb, const float (&x)[SR / 2],
                                       uint32_t keep, int tid,
                                       uint64_t* bar) {
#pragma unroll
  for (int e = 0; e < SR / 2; ++e) {
    pb[e * WG + tid] = DROP && !((keep >> e) & 1u) ? -x[e] : x[e];
  }
  hw::mbar_arrive(bar);
}

// The dp role's side of hand_p: p into x and, with DROP, the keep bits
template <bool DROP>
__device__ __forceinline__ void take_p(const float* pb, float (&x)[SR / 2],
                                       uint32_t& keep, int tid,
                                       uint64_t* bar, uint32_t parity) {
  hw::mbar_wait(bar, parity);
  keep = 0;
#pragma unroll
  for (int e = 0; e < SR / 2; ++e) {
    const float v = pb[e * WG + tid];
    if constexpr (DROP) keep |= (uint32_t)!signbit(v) << e;
    x[e] = fabsf(v);
  }
}

template <int DP>
constexpr size_t dkdv_f32_smem_bytes() {
  using G = F32<DP>;
  return 1024 + (size_t)4 * G::OWN + G::SLOTS * (G::KV_WORK + G::PBUF) +
         G::SLOTS * sizeof(F32Rows) + sizeof(F32Bars);
}

// A dk/dv pass consumer warpgroup with role ROLE: the slot's products and
// its part of p, ds and the sums, then its outputs.
template <int DP, bool DROP, int ROLE>
__device__ __forceinline__ void dkdv_consume(const F32Args& p,
                                             const uint8_t* own,
                                             const uint8_t* work,
                                             const F32Rows* rows,
                                             F32Bars* bars,
                                             int k0, int half, int head,
                                             int b, int qtiles) {
  using G = F32<DP>;
  constexpr bool S = ROLE & kRoleS, D = ROLE & kRoleDp;
  constexpr int OWN = G::OWN, NAT = G::NAT, TR = G::TR;
  const long long bh = (long long)b * p.heads + head;
  const int tid = threadIdx.x % WG, lane = tid % 32, t = lane % 4;
  const int row = 16 * (tid / 32) + lane / 4;
  const int key0 = k0 + row;  // this thread's keys key0 + 8 i
  bool key_in[2], key_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = key0 + 8 * i;
    key_in[i] = kj < p.tk;
    key_ok[i] = key_in[i] && p.mask[(long long)b * p.tk + kj];
  }
  const int kgroup = (k0 + row - lane / 4) / 4;
  const float inv_tk = 1.0f / (float)p.tk, sl2 = p.scale * kLog2e;
  // the partials, sa and dpa are written first by products that start
  // them afresh: no instruction before the loop defines them, which would
  // make ptxas serialize the products
  float dv_acc[32], dk_acc[32], dv_part[32], dk_part[32];
  float sa[SR / 2], dpa[SR / 2];  // s^T, then p; dp^T, then ds
  uint32_t ph[SR / 8][4], pl[SR / 8][4], dh[SR / 8][4], dl[SR / 8][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) dv_acc[i] = dk_acc[i] = 0.0f;
  hw::mbar_wait(&bars->own_ready, 0);

  for (int qt = 0; qt < qtiles; ++qt) {
    const int q0 = qt * SR, w = slot_of<DP>(qt);
    const uint32_t par = parity_of<DP>(qt);
    const uint8_t* wk = work + w * (G::KV_WORK + G::PBUF);
    const uint8_t* qt_hi = wk + 4 * NAT;    // q^T
    const uint8_t* gt_hi = qt_hi + 2 * TR;  // g^T
    float* pb = reinterpret_cast<float*>(const_cast<uint8_t*>(wk) +
                                         G::KV_WORK);
    const F32Rows& rw = rows[w];
    hw::mbar_wait(&bars->ready[w], par);
    hw::wgmma_fence();
    if constexpr (S) product_head<DP>(sa, own, wk);  // s^T = k q^T
    if constexpr (D) {
      product_head<DP>(dpa, own + 2 * OWN, wk + 2 * NAT);  // dp^T = v g^T
    }
    hw::wgmma_commit();
    // the mask's bits (the s role hands them to the dp role with p)
    uint32_t keep = DROP && S ? keep_bits_t(p, bh, q0, kgroup, lane) : 0u;
    hw::wgmma_wait<0>();
    if constexpr (S) hw::fence_regs(sa);
    if constexpr (D) hw::fence_regs(dpa);
    // p where the key is allowed for the query: exp(s * scale - lse) as
    // 2^(s * scale log2(e) - lse log2(e)), 1 / Tk on every key < Tk of a
    // row whose lse <= -1e29, else 0
    if constexpr (S) {
#pragma unroll
      for (int j = 0; j < SR / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + 2 * t + c, qi = q0 + col;
          const float l2 = rw.lse2[col];
          const bool uniform = l2 <= kAllMasked * kLog2e, q_in = qi < p.tq;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * j + 2 * i + c;
            const bool take =
                q_in && key_in[i] &&
                (uniform || (key_ok[i] && !(p.causal && key0 + 8 * i > qi)));
            sa[e] = !take ? 0.0f
                          : uniform ? inv_tk : ex2(fmaf(sa[e], sl2, -l2));
          }
        }
    }
    if constexpr (ROLE == kRoleS) {
      hand_p<DROP>(pb, sa, keep, tid, &bars->p_ready[w]);
    }
    if constexpr (ROLE == kRoleDp) {
      take_p<DROP>(pb, sa, keep, tid, &bars->p_ready[w], par);
    }
    // p m in the fragments of dv's A, ds = p (dp m - delta) in dk's
#pragma unroll
    for (int j = 0; j < SR / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float dl_q = rw.delta[8 * j + 2 * t + c];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 4 * j + 2 * i + c;
          const float m = DROP ? ((keep >> e) & 1u ? p.drop.scale : 0.0f)
                               : 1.0f;
          if constexpr (D) dpa[e] = sa[e] * (dpa[e] * m - dl_q);
          if constexpr (S) sa[e] *= m;
        }
      }
    if constexpr (S) hw::to_fragments(sa, ph, pl);
    if constexpr (D) hw::to_fragments(dpa, dh, dl);
    hw::wgmma_fence();
    if constexpr (S) product_rs(dv_part, ph, pl, gt_hi, TR);  // (p m)^T g
    if constexpr (D) product_rs(dk_part, dh, dl, qt_hi, TR);  // ds^T q
    hw::wgmma_commit();
    // the stage's partials into the sums; the slot is free of this role
    hw::wgmma_wait<0>();
    if constexpr (S) {
      hw::fence_regs(ph);
      hw::fence_regs(pl);
      hw::promote_acc(dv_acc, dv_part);
    }
    if constexpr (D) {
      hw::fence_regs(dh);
      hw::fence_regs(dl);
      hw::promote_acc(dk_acc, dk_part);
    }
    hw::mbar_arrive(&bars->empty[w]);
  }
  const long long stride = (long long)p.heads * p.d;
  const long long base = (long long)b * p.tk * stride + head * p.d;
  if constexpr (D) {
    store_f32(p.out_a + base, dk_acc, key0, p.tk, stride, p.scale, lane,
              64 * half, p.d);
  }
  if constexpr (S) {
    store_f32(p.out_b + base, dv_acc, key0, p.tk, stride, 1.0f, lane,
              64 * half, p.d);
  }
}

// The dk/dv pass: block bx holds 64 keys (k, v split once) and the head's
// columns 64 half .. + 63 of their dk, dv; the query stages stream.
template <int DP, bool DROP>
__device__ __forceinline__ void dkdv_f32_block(const F32Args& p, int bx,
                                               uint8_t* smem) {
  using G = F32<DP>;
  constexpr int SLOTS = G::SLOTS;
  uint8_t* own = smem;  // k hi, lo; v hi, lo
  // work slot s: q hi, lo; g hi, lo; q^T hi, lo; g^T hi, lo; p handed over
  uint8_t* work = own + 4 * G::OWN;
  F32Rows* rows =
      reinterpret_cast<F32Rows*>(work + SLOTS * (G::KV_WORK + G::PBUF));
  F32Bars* bars = reinterpret_cast<F32Bars*>(rows + SLOTS);

  const int half = bx % G::NH, k0 = bx / G::NH * FR;
  const int head = blockIdx.y, b = blockIdx.z;
  const int qtiles = (p.tq + SR - 1) / SR;
  const int c = threadIdx.x / WG;
  init_f32_bars<DP>(bars);
  if (c == G::CONS) {
    produce_f32<DP, true, true>(p, own, work, G::KV_WORK + G::PBUF, rows,
                                bars, head, k0, b, qtiles,
                                (long long)b * p.heads + head, half);
    return;
  }
  if constexpr (G::CONS == 1) {
    dkdv_consume<DP, DROP, kRoleBoth>(p, own, work, rows, bars, k0, half,
                                      head, b, qtiles);
    return;
  }
  if (c == 1) {
    dkdv_consume<DP, DROP, kRoleDp>(p, own, work, rows, bars, k0, half,
                                    head, b, qtiles);
    return;
  }
  dkdv_consume<DP, DROP, kRoleS>(p, own, work, rows, bars, k0, half, head,
                                 b, qtiles);
}

template <int DP>
constexpr size_t dq_f32_smem_bytes() {
  using G = F32<DP>;
  return 1024 + (size_t)4 * G::OWN + G::SLOTS * (G::Q_WORK + G::PBUF) +
         sizeof(F32Bars);
}

// A dq pass consumer warpgroup with role ROLE: the s role forms p, the dp
// role ds and dq.
template <int DP, bool DROP, int ROLE>
__device__ __forceinline__ void dq_consume(const F32Args& p,
                                           const uint8_t* own,
                                           const uint8_t* work,
                                           F32Bars* bars, int q0, int half,
                                           int head, int b, int ktiles) {
  using G = F32<DP>;
  constexpr bool S = ROLE & kRoleS, D = ROLE & kRoleDp;
  constexpr int OWN = G::OWN, NAT = G::NAT;
  const long long bh = (long long)b * p.heads + head;
  const int tid = threadIdx.x % WG, lane = tid % 32, t = lane % 4;
  const int row = 16 * (tid / 32) + lane / 4;
  int qi[2];
  bool q_in[2], uniform[2];
  float lse2[2], delta[2];  // lse * log2(e)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qi[i] = q0 + row + 8 * i;
    q_in[i] = qi[i] < p.tq;
    const float l = q_in[i] ? p.lse[bh * p.tq + qi[i]] : 0.0f;
    delta[i] = q_in[i] ? p.delta[bh * p.tq + qi[i]] : 0.0f;
    uniform[i] = l <= kAllMasked;
    lse2[i] = l * kLog2e;
  }
  const float inv_tk = 1.0f / (float)p.tk, sl2 = p.scale * kLog2e;
  const unsigned char* kmask = p.mask + (long long)b * p.tk;
  // the dk/dv pass's note on its partials
  float dq_acc[32], dq_part[32];
  float sa[SR / 2], dpa[SR / 2];  // s, then p; dp, then ds
  uint32_t dh[SR / 8][4], dl[SR / 8][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq_acc[i] = 0.0f;
  hw::mbar_wait(&bars->own_ready, 0);

  for (int kt = 0; kt < ktiles; ++kt) {
    const int k0 = kt * SR, w = slot_of<DP>(kt);
    const uint32_t par = parity_of<DP>(kt);
    const uint8_t* wk = work + w * (G::Q_WORK + G::PBUF);
    const uint8_t* kt_hi = wk + 4 * NAT;  // k^T
    float* pb = reinterpret_cast<float*>(const_cast<uint8_t*>(wk) +
                                         G::Q_WORK);
    hw::mbar_wait(&bars->ready[w], par);
    hw::wgmma_fence();
    if constexpr (S) product_head<DP>(sa, own, wk);  // s = q k^T
    if constexpr (D) {
      product_head<DP>(dpa, own + 2 * OWN, wk + 2 * NAT);  // dp = g v^T
    }
    hw::wgmma_commit();
    // while the products run: the keys' validity, the mask's bits
    uint32_t k_in = 0, k_ok = 0;  // bit 2 j + c: key k0 + 8 j + 2 t + c
    if constexpr (S) {
#pragma unroll
      for (int j = 0; j < SR / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kk = k0 + 8 * j + 2 * t + c;
          if (kk < p.tk) {
            k_in |= 1u << (2 * j + c);
            if (kmask[kk]) k_ok |= 1u << (2 * j + c);
          }
        }
    }
    // the mask's bits (the s role hands them to the dp role with p)
    uint32_t keep = DROP && S ? keep_bits_q(p, bh, qi, k0, lane) : 0u;
    hw::wgmma_wait<0>();
    if constexpr (S) {
      hw::fence_regs(sa);
#pragma unroll
      for (int j = 0; j < SR / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kk = k0 + 8 * j + 2 * t + c;
          const bool in = (k_in >> (2 * j + c)) & 1u;
          const bool ok = (k_ok >> (2 * j + c)) & 1u;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * j + 2 * i + c;
            const bool take =
                q_in[i] && in &&
                (uniform[i] || (ok && !(p.causal && kk > qi[i])));
            sa[e] = !take ? 0.0f
                          : uniform[i] ? inv_tk
                                       : ex2(fmaf(sa[e], sl2, -lse2[i]));
          }
        }
    }
    if constexpr (ROLE == kRoleS) {  // p to the dp role; the slot is done
      hand_p<DROP>(pb, sa, keep, tid, &bars->p_ready[w]);
      hw::mbar_arrive(&bars->empty[w]);
    }
    if constexpr (D) {
      hw::fence_regs(dpa);
      if constexpr (ROLE == kRoleDp) {
        take_p<DROP>(pb, sa, keep, tid, &bars->p_ready[w], par);
      }
      // ds = p (dp m - delta) in the fragments of dq's A
#pragma unroll
      for (int j = 0; j < SR / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * i + c;
            const float m = DROP ? ((keep >> e) & 1u ? p.drop.scale : 0.0f)
                                 : 1.0f;
            dpa[e] = sa[e] * (dpa[e] * m - delta[i]);
          }
      hw::to_fragments(dpa, dh, dl);
      hw::wgmma_fence();
      product_rs(dq_part, dh, dl, kt_hi, G::TR);  // dq += ds k
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs(dh);
      hw::fence_regs(dl);
      hw::promote_acc(dq_acc, dq_part);
      hw::mbar_arrive(&bars->empty[w]);
    }
  }
  if constexpr (D) {
    const long long stride = (long long)p.heads * p.d;
    store_f32(p.out_a + (long long)b * p.tq * stride + head * p.d, dq_acc,
              q0 + row, p.tq, stride, p.scale, lane, 64 * half, p.d);
  }
}

// The dq pass: block bx holds 64 queries (q, g split once) and the head's
// columns 64 half .. + 63 of their dq; the key stages stream.
template <int DP, bool DROP>
__device__ __forceinline__ void dq_f32_block(const F32Args& p, int bx,
                                             uint8_t* smem) {
  using G = F32<DP>;
  uint8_t* own = smem;  // q hi, lo; g hi, lo
  // work slot s: k hi, lo; v hi, lo; k^T hi, lo; p handed over
  uint8_t* work = own + 4 * G::OWN;
  F32Bars* bars =
      reinterpret_cast<F32Bars*>(work + G::SLOTS * (G::Q_WORK + G::PBUF));

  const int half = bx % G::NH, q0 = bx / G::NH * FR;
  const int head = blockIdx.y, b = blockIdx.z;
  const int ktiles = (p.tk + SR - 1) / SR;
  const int c = threadIdx.x / WG;
  init_f32_bars<DP>(bars);
  if (c == G::CONS) {
    produce_f32<DP, false, false>(p, own, work, G::Q_WORK + G::PBUF,
                                  nullptr, bars, head, q0, b, ktiles,
                                  (long long)b * p.heads + head, half);
    return;
  }
  if constexpr (G::CONS == 1) {
    dq_consume<DP, DROP, kRoleBoth>(p, own, work, bars, q0, half,
                                    head, b, ktiles);
    return;
  }
  if (c == 1) {
    dq_consume<DP, DROP, kRoleDp>(p, own, work, bars, q0, half, head,
                                  b, ktiles);
    return;
  }
  dq_consume<DP, DROP, kRoleS>(p, own, work, bars, q0, half, head, b,
                               ktiles);
}

// Both tiled passes in one grid: blocks x < kv_blocks of the dk/dv pass,
// the rest of the dq pass (independent of each other), so that neither
// pass ends in a partial wave of its own.
struct F32BwdArgs {
  F32Args kv, qa;
  int kv_blocks;
};

template <int DP>
constexpr size_t f32_smem_bytes() {
  return dkdv_f32_smem_bytes<DP>() > dq_f32_smem_bytes<DP>()
             ? dkdv_f32_smem_bytes<DP>()
             : dq_f32_smem_bytes<DP>();
}

template <int DP, bool DROP>
__global__ void __launch_bounds__(F32<DP>::THREADS, 1)
    attention_bwd_f32_kernel(const __grid_constant__ F32BwdArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hw::align1024(smem_raw);
  if (blockIdx.x < a.kv_blocks) {
    dkdv_f32_block<DP, DROP>(a.kv, blockIdx.x, smem);
  } else {
    dq_f32_block<DP, DROP>(a.qa, blockIdx.x - a.kv_blocks, smem);
  }
}

template <int DP, bool DROP>
int launch_f32(const void* q, const void* k, const void* v, const void* out,
               const void* g, const unsigned char* mask, const float* lse,
               float* delta, void* dq, void* dk, void* dv, int batch, int tq,
               int tk, int heads, int d, float scale, int causal,
               smx::Dropout drop, cudaStream_t stream) {
  F32BwdArgs a;
  F32Args& kv = a.kv;
  F32Args& qa = a.qa;
  const uint32_t f = sizeof(float);
  if (!hw::make_map_heads(&kv.own_a, k, batch, tk, heads, d, FR, f) ||
      !hw::make_map_heads(&kv.own_b, v, batch, tk, heads, d, FR, f) ||
      !hw::make_map_heads(&kv.st_a, q, batch, tq, heads, d, SR, f) ||
      !hw::make_map_heads(&kv.st_b, g, batch, tq, heads, d, SR, f) ||
      !hw::make_map_heads(&qa.own_a, q, batch, tq, heads, d, FR, f) ||
      !hw::make_map_heads(&qa.own_b, g, batch, tq, heads, d, FR, f) ||
      !hw::make_map_heads(&qa.st_a, k, batch, tk, heads, d, SR, f) ||
      !hw::make_map_heads(&qa.st_b, v, batch, tk, heads, d, SR, f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto common = [&](F32Args& a) {
    a.mask = mask;
    a.lse = lse;
    a.delta = delta;
    a.tq = tq;
    a.tk = tk;
    a.heads = heads;
    a.d = d;
    a.scale = scale;
    a.causal = causal;
    a.drop = drop;
  };
  common(kv);
  common(qa);
  kv.out_a = static_cast<float*>(dk);
  kv.out_b = static_cast<float*>(dv);
  qa.out_a = static_cast<float*>(dq);
  qa.out_b = nullptr;
  constexpr size_t smem = f32_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_f32_kernel<DP, DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = launch_delta<float>(g, out, delta, batch, tq, heads, d,
                                     stream);
  if (rc != 0) return rc;
  constexpr int nh = F32<DP>::NH;
  a.kv_blocks = (tk + FR - 1) / FR * nh;
  attention_bwd_f32_kernel<DP, DROP>
      <<<dim3(a.kv_blocks + (tq + FR - 1) / FR * nh, heads, batch),
         F32<DP>::THREADS, smem, stream>>>(a);
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
