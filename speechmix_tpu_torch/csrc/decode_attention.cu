// K4: decode_attention — single-query attention over a K/V buffer,
// out = softmax(q . k^T * scale [* k_scale] + mask) [* v_scale] . v per head.
//
// Replaces the TPU kernels speechmix_tpu/ops/pallas/decode_attention.py:
// decode_attention (_kernel, and _kernel_q8 for int8 K/V): every cached
// single-token decoder step, self-attention over the cache capacity and
// cross-attention over the precomputed encoder K/V.
//
// q, out: (bkv * kb, heads, D) float32 or bfloat16: kb queries share one
// K/V row (the beams of one input, contiguous); kb = 1 is the TPU contract.
// k, v: (bkv, t, heads, D) in q's type (float entry) or int8 codes (q8
// entry) with float32 scales ks, vs (bkv, t, heads).  D, the head width, is
// a multiple of 8 with 8 <= D <= 128.  mask: (bkv, t) bytes,
// non-zero = attend; a masked logit gets -1e9 added, as the plain path does.
//
// What bounds it on the H100: bytes, then latency.  Each K/V element is used
// once per query (2 FLOP per byte or less); at the decoder's shapes (16
// rows, 64 or 400 keys, 12 heads: 0.2 to 16 MB) a call is a few
// microseconds of memory time, so what counts is how many bytes are in
// flight at once and how many dependent steps a block takes.
//
// bf16 q (both entries), 128 < t <= 2048: the cluster body.  The keys of a
// (K/V row, head) up to the row's last attended one (its extent) are cut
// into `ranks` equal shares, one a 128 keys of t and at most 8 (the
// portable cluster size); the shares of one (row, head) form a thread-block
// cluster, and a block of 128 threads owns one share and up to 4 queries
// of its row (the beams; more take more clusters).  A block
//   1. loads at once a word of q and the row's mask, and finds the row's
//      extent and its share of it (no K or V byte past the extent is read;
//      a row that attends no key takes every key, which gives the plain
//      version's softmax over all the raw scores shifted by -1e9);
//   2. asks for its share of K with 16-byte cp.async copies, every thread
//      its part, into shared memory whose 16-byte chunks are permuted by
//      the key (the 128- and 64-byte swizzles), and the int8 scales;
//   3. computes a key's scores in f32 per thread (q read as a broadcast)
//      and, the moment the K tile is read, asks for the V tile in its place;
//   4. exchanges with the cluster its maximum and its sum of exp(s - max)
//      (st.async into every block's shared memory, counted on the
//      receiver's mbarrier: no cluster barrier); every block forms the
//      row's maximum m and sum, the shares' sums rescaled by exp(max - m)
//      and added in rank order;
//   5. normalises its probabilities exp(s - m) / sum, times the v scale,
//      rounds them to bf16 as the plain version does, forms its partial
//      P . v in f32 and sends it to rank 0, which adds the shares in rank
//      order and writes the output.
// No atomics and fixed orders throughout: two calls give the same bits.
// What the card showed (chip runs of the redesign, clock64 traces of the
// phases): the whole K and V of every block at once does not fit on chip
// together with the cluster's occupancy, so V follows K; TMA boxes cost
// the issuing warp more than the threads' own cp.async copies; int8 codes
// are widened with byte permutes, the I2F path being quarter rate; equal
// shares of the extent keep the cluster's blocks from waiting on the one
// that holds the most keys.
//
// f32 q, t <= 128 (one range: the self-attention cache) or t > 2048: the
// serial body (one block of 256 threads per (K/V row, head, group of up to
// 8 queries)): a scan of the mask row for its last attended key, then the
// scores 32 or 64 keys a pass, the softmax in shared memory, and the values
// in the same lane layout; each K and V word is loaded when its pass comes.
// At one range it is faster than the cluster body, which pays its exchanges
// for nothing there.  The `_serial` entries run it on bf16 at any t, so
// that the two bodies can be timed side by side.
//
// The TPU kernel's one-hot segment matmuls and its rows-per-program unroll
// answer Mosaic's lane rules and grid overhead and have no counterpart.
//
// Head widths.  Both bodies are built for a padded width DP, 64 or 128,
// and D = 64 runs the bodies it always ran.  Every other D runs the `GEN`
// instances: a lane or a copy owns a word of 8 head elements (16 bytes of
// bf16, 32 of f32, 8 of int8: D a multiple of 8 keeps each word of each
// head aligned), the words past D are zeros (in registers in the serial
// body; stored as zeros beside the cp.async copies in the cluster body's
// tiles, whose key rows are DP wide), and only D columns are written.  A
// padded word costs its share of the dot products: a simple body that is
// right.  At DP = 128 a cluster block holds 16 words of a key in registers
// for its scores, so four blocks, not eight, share an SM.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hw = smx::hopper;
using bf16 = __nv_bfloat16;

constexpr int NT = 256;      // threads per block of the serial body
constexpr int NW = NT / 32;  // its warps: at most NW queries per block
constexpr float kMasked = -1e9f;

// the values of one 16-byte word as floats
__device__ __forceinline__ void unpack(const uint4& raw, float* x, float) {
  const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = f[i];
}

__device__ __forceinline__ void unpack(const uint4& raw, float* x, bf16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& raw, float* x, int8_t) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = static_cast<float>(c[i]);
}

// 8 contiguous elements of a word (16 bytes of bf16, 32 of f32, 8 of int8)
// from an address aligned to the word's size (16 bytes at most), as floats
template <typename T>
__device__ __forceinline__ void load_word8(const T* p, float (&x)[8]);

// N contiguous elements from a 16-byte aligned address, as floats
template <int N, typename T>
__device__ __forceinline__ void load_elems(const T* p, float (&x)[N]) {
  constexpr int PER_WORD = 16 / sizeof(T);
  static_assert(N % PER_WORD == 0, "whole 16-byte words only");
#pragma unroll
  for (int w = 0; w < N / PER_WORD; ++w) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + w * PER_WORD);
    unpack(raw, x + w * PER_WORD, T());
  }
}

template <typename T>
__device__ __forceinline__ void load_word8(const T* p, float (&x)[8]) {
  if constexpr (sizeof(T) == 1) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = static_cast<float>(c[i]);
  } else {
    load_elems<8>(p, x);
  }
}

// a lane's EPL elements of a key or query: under GEN a word of 8 (zeros
// where the word lies past the head, `has` false)
template <bool GEN, int EPL, typename T>
__device__ __forceinline__ void lane_word(const T* src, bool has,
                                          float (&x)[EPL]) {
  if constexpr (GEN) {
    if (has) {
      load_word8(src, x);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) x[e] = 0.0f;
    }
  } else {
    load_elems<EPL>(src, x);
  }
}

// ------------------------------------------------------------ serial body
// QT: type of q and out; KT: type of k and v; KBT: queries per block; DP:
// the padded head width; GEN: any head width d (else d = DP = 64).  A lane
// owns EPL contiguous head elements of a key (one 16-byte word of bf16 or
// int8, two of f32; under GEN a word of 8 elements, zeros past d); LPK
// lanes cover a key, KPP keys go per pass.
template <typename QT, typename KT, int KBT, int DP, bool GEN>
__global__ void __launch_bounds__(NT)
    decode_attention_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                            const KT* __restrict__ v,
                            const uint8_t* __restrict__ mask,
                            const float* __restrict__ ks,
                            const float* __restrict__ vs, QT* __restrict__ out,
                            int kb, int t, int heads, int d, float scale) {
  constexpr int EPL = GEN ? 8 : sizeof(KT) == 1 ? 16 : 8;
  constexpr int LPK = DP / EPL;
  constexpr int KPP = NT / LPK;
  extern __shared__ __align__(16) float smem[];
  float* sc = smem;              // (KBT, n <= t) scores, then probabilities
  float* part = smem + KBT * t;  // (NW, KBT, DP) partial outputs
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = tid % LPK, grp = tid / LPK;
  const int b = blockIdx.x, h = blockIdx.y, q0 = blockIdx.z * KBT;
  const int dh = GEN ? d : DP;
  const bool has = !GEN || sub * EPL < dh;  // the lane's word is in the head
  const long long hd = (long long)heads * dh;
  const long long kv_base =
      (long long)b * t * hd + (long long)h * dh + sub * EPL;

  float qr[KBT][EPL];
#pragma unroll
  for (int j = 0; j < KBT; ++j) {
    if (q0 + j < kb) {
      lane_word<GEN>(q + ((long long)b * kb + q0 + j) * hd + h * dh + sub * EPL,
                     has, qr[j]);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[j][e] = 0.0f;
    }
  }

  // n: the keys read, one past the last attended key of the mask row
  const uint8_t* mrow = mask + (long long)b * t;
  __shared__ int t_attended;
  if (tid == 0) t_attended = 0;
  __syncthreads();
  int last = 0;
  for (int i = tid; i < t; i += NT)
    if (mrow[i]) last = i + 1;
  if (last > 0) atomicMax(&t_attended, last);
  __syncthreads();
  const int n = t_attended > 0 ? t_attended : t;

  // 1. scores
  // (every lane stays in the loop to the end: the shuffles need them all)
  for (int key0 = 0; key0 < n; key0 += KPP) {
    const int key = min(key0 + grp, n - 1);
    const bool live = key0 + grp < n;
    float kf[EPL];
    lane_word<GEN>(k + kv_base + (long long)key * hd, has, kf);
    float bias = 0.0f, ksc = scale;
    if (sub == 0 && live) {
      if (!mrow[key]) bias = kMasked;
      if (ks != nullptr)
        ksc = scale * ks[((long long)b * t + key) * heads + h];
    }
#pragma unroll
    for (int j = 0; j < KBT; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) s += qr[j][e] * kf[e];
#pragma unroll
      for (int off = 1; off < LPK; off <<= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (sub == 0 && live) sc[j * n + key] = s * ksc + bias;
    }
  }
  __syncthreads();

  // 2. softmax of query `warp`; probabilities rounded to q's type
  if (warp < KBT) {
    float* row = sc + warp * n;
    float m = -3.0e38f;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, row[i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.0f;
    for (int i = lane; i < n; i += 32) {
      const float e = expf(row[i] - m);
      row[i] = e;
      sum += e;
    }
    const float inv = 1.0f / smx::warp_sum(sum);
    for (int i = lane; i < n; i += 32) {
      float p = row[i] * inv;
      if (vs != nullptr) p *= vs[((long long)b * t + i) * heads + h];
      row[i] = smx::to_f32(smx::from_f32<QT>(p));
    }
  }
  __syncthreads();

  // 3. values
  float acc[KBT][EPL];
#pragma unroll
  for (int j = 0; j < KBT; ++j)
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[j][e] = 0.0f;
  for (int key = grp; key < n; key += KPP) {
    float vf[EPL];
    lane_word<GEN>(v + kv_base + (long long)key * hd, has, vf);
#pragma unroll
    for (int j = 0; j < KBT; ++j) {
      const float p = sc[j * n + key];
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[j][e] += p * vf[e];
    }
  }
#pragma unroll
  for (int j = 0; j < KBT; ++j)
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      float a = acc[j][e];
#pragma unroll
      for (int off = LPK; off < 32; off <<= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      if (lane < LPK) part[(warp * KBT + j) * DP + sub * EPL + e] = a;
    }
  __syncthreads();
  for (int i = tid; i < KBT * DP; i += NT) {
    const int j = i / DP, c = i % DP;
    if (q0 + j >= kb || (GEN && c >= dh)) continue;
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < NW; ++w) a += part[(w * KBT + j) * DP + c];
    out[((long long)b * kb + q0 + j) * hd + h * dh + c] = smx::from_f32<QT>(a);
  }
}

// ----------------------------------------------------------- cluster body
constexpr int RANGE = 128;      // keys of t a block: t / RANGE blocks
constexpr int MAX_RANKS = 8;    // blocks of a (row, head): portable cluster
constexpr int MAX_T = 2048;     // the longest key buffer it takes
constexpr int CT = 128;         // threads of a block
constexpr int CW = CT / 32;     // its warps
constexpr int KPT = MAX_T / MAX_RANKS / CT;  // keys of a thread, at most
constexpr int MPT = MAX_T / CT;              // mask bytes of a thread
constexpr int MAX_KBT = 4;      // queries of a block
constexpr int EPL = 8;          // head elements of a 16- or 8-byte word

struct ClusterArgs {
  const bf16* q;
  const void* k;
  const void* v;
  const uint8_t* mask;
  const float* ks;
  const float* vs;
  bf16* out;
  int kb, t, heads, d;
  int ranks;  // blocks of a cluster: shares of a (row, head)'s keys
  int len;    // keys a share may hold: ceil(t / ranks)
  float scale;
};

// the 8 elements of a word: 16 bytes of bf16, 8 bytes of int8
template <typename KT>
struct Word;
template <>
struct Word<bf16> {
  using T = uint4;
};
template <>
struct Word<int8_t> {
  using T = uint2;
};

// 4 int8 codes (one 32-bit word) as floats without the quarter-rate I2F:
// each byte, offset by 128, becomes the low mantissa bits of 2^23
__device__ __forceinline__ void codes4(uint32_t w, float* x) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i)) -
           8388736.0f;  // 2^23 + 128
}

// the cluster body's words as floats: bf16 as in `unpack`, int8 by codes4
__device__ __forceinline__ void widen(const uint4& raw, float* x, bf16) {
  unpack(raw, x, bf16());
}
__device__ __forceinline__ void widen(const uint4& raw, float* x, int8_t) {
  codes4(raw.x, x);
  codes4(raw.y, x + 4);
  codes4(raw.z, x + 8);
  codes4(raw.w, x + 12);
}
__device__ __forceinline__ void widen(const uint2& raw, float* x, int8_t) {
  codes4(raw.x, x);
  codes4(raw.y, x + 4);
}

// byte offsets of a block's shared memory over a share of `len` keys in a
// cluster of `ranks`; the buffers the cluster writes into lie at the same
// offsets in every block.  Each region after the scores starts on a 16-byte
// boundary: (KBT, len) f32 scores end on a 4-byte one when KBT * len is
// odd (T = 500: four shares of 125 keys), and the mbarriers need 8 bytes.
__host__ __device__ constexpr size_t align16(size_t o) {
  return (o + 15) & ~static_cast<size_t>(15);
}

template <typename KT, int KBT, int DP>
struct Layout {
  static constexpr size_t ROW = DP * sizeof(KT);  // a key's bytes
  static constexpr size_t PART = (size_t)CW * KBT * DP * sizeof(float);
  size_t tile, qs, sc, xpart, xmax, xsum, red, row, msk, bar, total;
  __host__ __device__ Layout(int len, int ranks) {
    size_t o = 0;
    tile = o;  // the K tile, then the V tile, then (CW, KBT, DP) the warps'
    o += len * ROW > PART ? len * ROW : PART;  // partial P . v
    qs = o;  // (KBT, DP) the queries in f32
    o += (size_t)KBT * DP * sizeof(float);
    sc = o;  // (KBT, len) scores, then exp(s - m), then probabilities
    o += (size_t)KBT * len * sizeof(float);
    o = align16(o);
    xpart = o;  // (ranks, KBT, DP) the shares' partials, in rank 0
    o += (size_t)ranks * KBT * DP * sizeof(float);
    xmax = o;  // (MAX_RANKS, KBT) the shares' maxima
    o += (size_t)MAX_RANKS * KBT * sizeof(float);
    xsum = o;  // (MAX_RANKS, KBT) the shares' sums of exp(s - max)
    o += (size_t)MAX_RANKS * KBT * sizeof(float);
    red = o;  // (2, CW, KBT) the warps' maxima and sums
    o += (size_t)2 * CW * KBT * sizeof(float);
    row = o;  // (2, KBT) the row's maximum and sum
    o += (size_t)2 * KBT * sizeof(float);
    msk = o;  // the row's mask bytes
    o += MAX_T;
    o = align16(o);
    bar = o;  // mbarriers of the exchanges: the statistics, the partials
    o += 2 * sizeof(uint64_t);  // (rank 0)
    total = o;
  }
};

// Byte offset in a tile of 16-byte chunk c of key `key`, the chunks of a
// key's row permuted by the key (rows of 64 bytes, int8 at DP = 64: chunk
// c ^ (key / 2) % 4; else chunk c ^ key % 8: the 64- and 128-byte
// swizzles, the latter within each 128 bytes of a 256-byte bf16 row at
// DP = 128), so that threads reading the same chunk of consecutive keys,
// or consecutive chunks of one key, never share a bank
template <typename KT, int DP>
__device__ __forceinline__ int chunk_at(int key, int c) {
  constexpr int RB = DP * sizeof(KT);
  if constexpr (RB == 64) return key * 64 + ((c ^ ((key >> 1) & 3)) << 4);
  return key * RB + ((c ^ (key & 7)) << 4);
}

// the same for 8-element word w (16 bytes of bf16, 8 of int8)
template <typename KT, int DP>
__device__ __forceinline__ int word_at(int key, int w) {
  if constexpr (sizeof(KT) == 1)
    return chunk_at<KT, DP>(key, w >> 1) + ((w & 1) << 3);
  return chunk_at<KT, DP>(key, w);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   hw::smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                   hw::smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// keys 0 .. n - 1 of a (row, head)'s K or V, `hd` elements apart from
// `src`, into `tile` in chunk_at's order: every thread its 16-byte copies,
// one group.  GEN: a head of d elements, copied in 8-element words (16
// bytes of bf16, 8 of int8), the words of a DP-wide row past d stored as
// zeros.
template <typename KT, int DP, bool GEN>
__device__ __forceinline__ void load_keys(uint8_t* tile, const KT* src, int n,
                                          long long hd, int d) {
  if constexpr (GEN) {
    constexpr int WPR = DP / EPL;  // words of a tile row
    const int words = d / EPL;     // of them in the head
    for (int i = threadIdx.x; i < n * WPR; i += CT) {
      const int key = i / WPR, w = i % WPR;
      uint8_t* dst = tile + word_at<KT, DP>(key, w);
      if (w >= words) {
        if constexpr (sizeof(KT) == 1) {
          *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
        } else {
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        }
      } else if constexpr (sizeof(KT) == 1) {
        cp_async8(dst, src + key * hd + w * EPL);
      } else {
        cp_async16(dst, src + key * hd + w * EPL);
      }
    }
  } else {
    constexpr int CPK = DP * sizeof(KT) / 16;  // chunks of a key
    for (int i = threadIdx.x; i < n * CPK; i += CT) {
      const int key = i / CPK, c = i % CPK;
      cp_async16(tile + chunk_at<KT, DP>(key, c),
                 reinterpret_cast<const uint8_t*>(src + key * hd) + c * 16);
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Threads 0 .. KBT * ranks - 1 send the share's maximum and sum of query
// j = tid / ranks (stat(j, &max, &sum)) to slot `slot0 + j` of `xmax` and
// `xsum` in block tid % ranks; then every block waits for the 2 KBT ranks
// values it receives
template <int KBT, typename Stat>
__device__ __forceinline__ void exchange(float* xmax, float* xsum, int slot0,
                                         uint64_t* bar, int ranks, Stat stat) {
  const int tid = threadIdx.x;
  if (tid < KBT * ranks) {
    float m, l;
    stat(tid / ranks, &m, &l);
    hw::st_async(xmax + slot0 + tid / ranks, tid % ranks, m, bar);
    hw::st_async(xsum + slot0 + tid / ranks, tid % ranks, l, bar);
  }
  if (tid == 0) hw::mbar_expect_tx(bar, KBT * ranks * 8);
  hw::mbar_wait_cluster(bar, 0);
}

// grid (ranks * bkv, heads, ceil(kb / KBT)), clusters of (ranks, 1, 1):
// block x of the grid has rank x % ranks in its cluster and owns share
// `rank` of the extent of K/V row x / ranks, head y, and queries KBT z ..
// KBT z + KBT - 1 of that row.  Thread i holds keys i and i + CT of its
// share through the scores and the softmax.
template <typename KT, int KBT, int DP, bool GEN>
__global__ void __launch_bounds__(CT, DP == 128 ? 4 : KBT <= 2 ? 8 : 6)
    decode_cluster_kernel(const __grid_constant__ ClusterArgs a) {
  using L = Layout<KT, KBT, DP>;
  constexpr int WPK = DP / EPL;    // words of a key
  constexpr int KPP = CT / WPK;    // keys per pass of the value product
  using W = typename Word<KT>::T;
  constexpr bool Q8 = sizeof(KT) == 1;
  constexpr int CE = 16 / sizeof(KT);  // elements of a 16-byte chunk
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const L lay(a.len, a.ranks);
  uint8_t* tile = smem_raw + lay.tile;
  float* qs = reinterpret_cast<float*>(smem_raw + lay.qs);
  float* sc = reinterpret_cast<float*>(smem_raw + lay.sc);
  float* xpart = reinterpret_cast<float*>(smem_raw + lay.xpart);
  float* xmax = reinterpret_cast<float*>(smem_raw + lay.xmax);
  float* xsum = reinterpret_cast<float*>(smem_raw + lay.xsum);
  float* red = reinterpret_cast<float*>(smem_raw + lay.red);
  float* row_stat = reinterpret_cast<float*>(smem_raw + lay.row);
  uint8_t* msk = smem_raw + lay.msk;
  uint64_t* stat_bar = reinterpret_cast<uint64_t*>(smem_raw + lay.bar);
  uint64_t* part_bar = stat_bar + 1;
  __shared__ int warp_last[CW];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ranks = a.ranks, rank = blockIdx.x % ranks;
  const int b = blockIdx.x / ranks, h = blockIdx.y, q0 = blockIdx.z * KBT;
  const int len = a.len;
  const int dh = GEN ? a.d : DP;
  const long long hd = (long long)a.heads * dh;
  // the exchanges' barriers; every block of the cluster has started and
  // initialised them before any writes to another's shared memory (the
  // wait comes before the first such write)
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) hw::mbar_init(stat_bar + i, 1);
    hw::mbar_fence_init();
  }
  hw::cluster_arrive_relaxed();
  // 1. every global load at once: a word of q and the row's mask (bytes
  // tid, tid + CT, ...: a line a warp)
  const int qj = tid / WPK, qw = tid % WPK;  // word qw of query qj
  const bool has_q =
      tid < KBT * WPK && q0 + qj < a.kb && (!GEN || qw * EPL < dh);
  uint4 qraw = {};
  if (has_q)
    qraw = *reinterpret_cast<const uint4*>(
        a.q + ((long long)b * a.kb + q0 + qj) * hd + h * dh + qw * EPL);
  const uint8_t* mrow = a.mask + (long long)b * a.t;
  uint8_t mb[MPT];
#pragma unroll
  for (int i = 0; i < MPT; ++i)
    mb[i] = tid + i * CT < a.t ? mrow[tid + i * CT] : 0;
  if (tid < KBT * WPK) {
    float x[EPL] = {};
    if (has_q) unpack(qraw, x, bf16());
#pragma unroll
    for (int e = 0; e < EPL; ++e) qs[qj * DP + qw * EPL + e] = x[e];
  }
  int last = 0;
#pragma unroll
  for (int i = 0; i < MPT; ++i) {
    msk[tid + i * CT] = mb[i];
    if (mb[i]) last = tid + i * CT + 1;
  }
  last = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0) warp_last[warp] = last;
  __syncthreads();
  // the row's extent: one past its last attended key, or every key when it
  // attends none (the softmax then takes all the raw scores, shifted by
  // -1e9); this block's share of it: keys start .. start + n - 1
  int extent = 0;
#pragma unroll
  for (int w = 0; w < CW; ++w) extent = max(extent, warp_last[w]);
  if (extent == 0) extent = a.t;
  const int share = (extent + ranks - 1) / ranks;
  const int start = min(rank * share, extent);
  const int n = min(share, extent - start);
  const long long key0 = (long long)b * a.t + start;  // (row, key) index
  const KT* kg = static_cast<const KT*>(a.k) + key0 * hd + h * dh;
  const KT* vg = static_cast<const KT*>(a.v) + key0 * hd + h * dh;

  // 2. the K tile, every thread its copies, and the thread's keys' scales
  load_keys<KT, DP, GEN>(tile, kg, n, hd, dh);
  float kscale[KPT] = {}, vscale[KPT] = {};
  if constexpr (Q8) {
    if (n > 0) {
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const long long at = (key0 + min(tid + i * CT, n - 1)) * a.heads + h;
        kscale[i] = a.ks[at];
        vscale[i] = a.vs[at];
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 3. the scores of the thread's keys: s * scale [* k scale] + bias;
  // every thread reads the same chunk of q at a time (a broadcast)
  float mloc[KBT];
#pragma unroll
  for (int j = 0; j < KBT; ++j) mloc[j] = -INFINITY;
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int key = tid + i * CT;
    if (key >= n) break;
    uint4 kw[DP / CE];
#pragma unroll
    for (int c = 0; c < DP / CE; ++c)
      kw[c] = *reinterpret_cast<const uint4*>(tile + chunk_at<KT, DP>(key, c));
    float s[KBT][4];  // four partial sums a query
#pragma unroll
    for (int j = 0; j < KBT; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) s[j][u] = 0.0f;
#pragma unroll
    for (int c = 0; c < DP / CE; ++c) {
      float kf[CE];
      widen(kw[c], kf, KT());
#pragma unroll
      for (int j = 0; j < KBT; ++j) {
#pragma unroll
        for (int e = 0; e < CE; e += 4) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qs + j * DP + c * CE + e);
          s[j][0] += qv.x * kf[e];
          s[j][1] += qv.y * kf[e + 1];
          s[j][2] += qv.z * kf[e + 2];
          s[j][3] += qv.w * kf[e + 3];
        }
      }
    }
    const float bias = msk[start + key] ? 0.0f : kMasked;
#pragma unroll
    for (int j = 0; j < KBT; ++j) {
      float l = ((s[j][0] + s[j][1]) + (s[j][2] + s[j][3])) * a.scale;
      if constexpr (Q8) l *= kscale[i];
      l += bias;
      sc[j * len + key] = l;
      mloc[j] = fmaxf(mloc[j], l);
    }
  }
#pragma unroll
  for (int j = 0; j < KBT; ++j) {
    const float m = warp_max(mloc[j]);
    if (lane == 0) red[warp * KBT + j] = m;
  }
  __syncthreads();
  // the V tile into the K tile's place: it arrives while the cluster
  // exchanges the statistics
  load_keys<KT, DP, GEN>(tile, vg, n, hd, dh);
  // the share's maxima (-inf without keys) and its sums of exp(s - max)
  float* red_sum = red + CW * KBT;
#pragma unroll
  for (int j = 0; j < KBT; ++j) {
    float m = red[j];
#pragma unroll
    for (int w = 1; w < CW; ++w) m = fmaxf(m, red[w * KBT + j]);
    float l = 0.0f;
#pragma unroll
    for (int i = 0; i < KPT; ++i)
      if (tid + i * CT < n) l += expf(sc[j * len + tid + i * CT] - m);
    l = smx::warp_sum(l);
    if (lane == 0) red_sum[warp * KBT + j] = l;
  }
  __syncthreads();
  hw::cluster_wait();
  exchange<KBT>(xmax, xsum, rank * KBT, stat_bar, ranks,
                [&](int j, float* m, float* l) {
                  *m = red[j];
                  *l = red_sum[j];
#pragma unroll
                  for (int w = 1; w < CW; ++w) {
                    *m = fmaxf(*m, red[w * KBT + j]);
                    *l += red_sum[w * KBT + j];
                  }
                });

  // the row's maximum m and its sum of exp(s - m): the shares' sums
  // rescaled from their maxima, added in rank order (thread j for query j)
  if (tid < KBT) {
    float mr[MAX_RANKS], m = -INFINITY, sum = 0.0f;
#pragma unroll
    for (int r = 0; r < MAX_RANKS; ++r) {
      mr[r] = r < ranks ? xmax[r * KBT + tid] : -INFINITY;
      m = fmaxf(m, mr[r]);
    }
#pragma unroll
    for (int r = 0; r < MAX_RANKS; ++r)
      if (mr[r] > -INFINITY) sum += xsum[r * KBT + tid] * expf(mr[r] - m);
    row_stat[tid] = m;
    row_stat[KBT + tid] = sum;
  }
  __syncthreads();
  float m[KBT], sum[KBT];
#pragma unroll
  for (int j = 0; j < KBT; ++j) {
    m[j] = row_stat[j];
    sum[j] = row_stat[KBT + j];
  }
  // 4. probabilities exp(s - m) / sum, times the v scale, rounded to bf16
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int key = tid + i * CT;
    if (key >= n) break;
#pragma unroll
    for (int j = 0; j < KBT; ++j) {
      float p = expf(sc[j * len + key] - m[j]) / sum[j];
      if constexpr (Q8) p *= vscale[i];
      sc[j * len + key] = __bfloat162float(__float2bfloat16(p));
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the share's P . v: word `sub` of keys grp, grp + KPP, ..., then the
  // warp's key groups, then the warps in order
  const int sub = tid % WPK, grp = tid / WPK;
  float acc[KBT][EPL];
#pragma unroll
  for (int j = 0; j < KBT; ++j)
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[j][e] = 0.0f;
  for (int key = grp; key < n; key += KPP) {
    float vf[EPL];
    widen(*reinterpret_cast<const W*>(tile + word_at<KT, DP>(key, sub)), vf,
          KT());
#pragma unroll
    for (int j = 0; j < KBT; ++j) {
      const float p = sc[j * len + key];
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[j][e] += p * vf[e];
    }
  }
  __syncthreads();  // the V tile is read: the partials take its place
  float* part = reinterpret_cast<float*>(tile);
#pragma unroll
  for (int j = 0; j < KBT; ++j)
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      float s = acc[j][e];
#pragma unroll
      for (int off = WPK; off < 32; off <<= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane < WPK) part[(warp * KBT + j) * DP + sub * EPL + e] = s;
    }
  __syncthreads();
  // 5. the share's partial into slot `rank` of rank 0, which adds the
  // shares in rank order
  for (int i = tid; i < KBT * DP; i += CT) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < CW; ++w) s += part[w * KBT * DP + i];
    hw::st_async(xpart + rank * KBT * DP + i, 0, s, part_bar);
  }
  // nothing writes to this block's shared memory any more unless it is
  // rank 0, which waits for every share's partial
  if (rank != 0) return;
  if (tid == 0) hw::mbar_expect_tx(part_bar, ranks * KBT * DP * 4);
  hw::mbar_wait_cluster(part_bar, 0);
  for (int i = tid; i < KBT * DP; i += CT) {
    const int j = i / DP, c = i % DP;
    if (q0 + j >= a.kb || (GEN && c >= dh)) continue;
    float s = 0.0f;
    for (int r = 0; r < ranks; ++r) s += xpart[r * KBT * DP + i];
    a.out[((long long)b * a.kb + q0 + j) * hd + h * dh + c] =
        __float2bfloat16(s);
  }
}

constexpr size_t kMaxSmem = 232448;  // shared memory a block can use

template <typename KT, int KBT, int DP, bool GEN>
int launch_cluster(const ClusterArgs& a, int bkv, cudaStream_t stream) {
  const size_t smem = Layout<KT, KBT, DP>(a.len, a.ranks).total;
  const void* kernel =
      reinterpret_cast<const void*>(decode_cluster_kernel<KT, KBT, DP, GEN>);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.ranks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.ranks * bkv, a.heads, (a.kb + KBT - 1) / KBT);
  cfg.blockDim = dim3(CT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  void* args[] = {const_cast<ClusterArgs*>(&a)};
  cudaError_t err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT, int KBT, int DP, bool GEN>
int launch_kbt(const void* q, const void* k, const void* v, const void* mask,
               const float* ks, const float* vs, void* out, int bkv, int kb,
               int t, int heads, int d, float scale, cudaStream_t stream) {
  const size_t smem =
      ((size_t)KBT * t + (size_t)NW * KBT * DP) * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = decode_attention_kernel<QT, KT, KBT, DP, GEN>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(bkv, heads, (kb + KBT - 1) / KBT);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const uint8_t*>(mask), ks, vs,
      static_cast<QT*>(out), kb, t, heads, d, scale);
  return static_cast<int>(cudaGetLastError());
}

// the serial body at one padded width
template <typename QT, typename KT, int DP, bool GEN>
int launch_serial_dp(const void* q, const void* k, const void* v,
                     const void* mask, const float* ks, const float* vs,
                     void* out, int bkv, int kb, int t, int heads, int d,
                     float scale, cudaStream_t s) {
  if (kb == 1)
    return launch_kbt<QT, KT, 1, DP, GEN>(q, k, v, mask, ks, vs, out, bkv, kb,
                                          t, heads, d, scale, s);
  if (kb == 2)
    return launch_kbt<QT, KT, 2, DP, GEN>(q, k, v, mask, ks, vs, out, bkv, kb,
                                          t, heads, d, scale, s);
  if (kb <= 4)
    return launch_kbt<QT, KT, 4, DP, GEN>(q, k, v, mask, ks, vs, out, bkv, kb,
                                          t, heads, d, scale, s);
  return launch_kbt<QT, KT, 8, DP, GEN>(q, k, v, mask, ks, vs, out, bkv, kb,
                                        t, heads, d, scale, s);
}

// the serial body: D = 64 the body it always ran, other widths the GEN
// instances at DP = 64 or 128
template <typename QT, typename KT>
int launch_serial(const void* q, const void* k, const void* v,
                  const void* mask, const float* ks, const float* vs,
                  void* out, int bkv, int kb, int t, int heads, int d,
                  float scale, cudaStream_t s) {
  if (d == 64)
    return launch_serial_dp<QT, KT, 64, false>(q, k, v, mask, ks, vs, out, bkv,
                                               kb, t, heads, d, scale, s);
  if (d < 64)
    return launch_serial_dp<QT, KT, 64, true>(q, k, v, mask, ks, vs, out, bkv,
                                              kb, t, heads, d, scale, s);
  return launch_serial_dp<QT, KT, 128, true>(q, k, v, mask, ks, vs, out, bkv,
                                             kb, t, heads, d, scale, s);
}

template <typename KT, int DP, bool GEN>
int launch_cluster_kb(const ClusterArgs& a, int bkv, cudaStream_t s) {
  if (a.kb == 1) return launch_cluster<KT, 1, DP, GEN>(a, bkv, s);
  if (a.kb == 2) return launch_cluster<KT, 2, DP, GEN>(a, bkv, s);
  return launch_cluster<KT, MAX_KBT, DP, GEN>(a, bkv, s);
}

// bf16 q: the cluster body for RANGE < t <= MAX_T (ranks: one a RANGE
// keys of t, at most MAX_RANKS, as few as keep a share within 2 RANGE),
// else the serial body
template <typename KT>
int launch_bf16(const void* q, const void* k, const void* v, const void* mask,
                const float* ks, const float* vs, void* out, int bkv, int kb,
                int t, int heads, int d, float scale, cudaStream_t s) {
  const int tiles = (t + RANGE - 1) / RANGE;
  const int per_block = (tiles + MAX_RANKS - 1) / MAX_RANKS;
  if (tiles == 1 || t > MAX_T ||
      (long long)bkv * MAX_RANKS > 0x7fffffffLL ||
      (kb + MAX_KBT - 1) / MAX_KBT > 65535)
    return launch_serial<bf16, KT>(q, k, v, mask, ks, vs, out, bkv, kb, t,
                                   heads, d, scale, s);
  ClusterArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = k;
  a.v = v;
  a.mask = static_cast<const uint8_t*>(mask);
  a.ks = ks;
  a.vs = vs;
  a.out = static_cast<bf16*>(out);
  a.kb = kb;
  a.t = t;
  a.heads = heads;
  a.d = d;
  a.ranks = (tiles + per_block - 1) / per_block;
  a.len = (t + a.ranks - 1) / a.ranks;
  a.scale = scale;
  if (d == 64) return launch_cluster_kb<KT, 64, false>(a, bkv, s);
  if (d < 64) return launch_cluster_kb<KT, 64, true>(a, bkv, s);
  return launch_cluster_kb<KT, 128, true>(a, bkv, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int check(const void* q, const void* k, const void* v, const void* out,
          int bkv, int kb, int t, int heads, int head_dim, int device) {
  if (bkv <= 0 || kb <= 0 || t <= 0 || heads <= 0 || head_dim < 8 ||
      head_dim > 128 || head_dim % 8 ||
      heads > 65535 || (kb + NW - 1) / NW > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  return static_cast<int>(cudaSetDevice(device));
}

int check_q8(const void* q, const void* k, const void* v, const float* ks,
             const float* vs, const void* out, int bkv, int kb, int t,
             int heads, int head_dim, int device) {
  if (ks == nullptr || vs == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return check(q, k, v, out, bkv, kb, t, heads, head_dim, device);
}

}  // namespace

// k, v in q's type
extern "C" int smx_decode_attention(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, int bkv,
                                    int kb, int t, int heads, int head_dim,
                                    float scale, int dtype, int device,
                                    void* stream) {
  const int err = check(q, k, v, out, bkv, kb, t, heads, head_dim, device);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == smx::kBF16)
    return launch_bf16<bf16>(q, k, v, mask, nullptr, nullptr, out, bkv, kb, t,
                             heads, head_dim, scale, s);
  return launch_serial<float, float>(q, k, v, mask, nullptr, nullptr, out, bkv,
                                     kb, t, heads, head_dim, scale, s);
}

// k, v int8 codes with per-(token, head) float32 scales
extern "C" int smx_decode_attention_q8(const void* q, const void* k,
                                       const void* v, const void* mask,
                                       const float* ks, const float* vs,
                                       void* out, int bkv, int kb, int t,
                                       int heads, int head_dim, float scale,
                                       int dtype, int device, void* stream) {
  const int err =
      check_q8(q, k, v, ks, vs, out, bkv, kb, t, heads, head_dim, device);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == smx::kBF16)
    return launch_bf16<int8_t>(q, k, v, mask, ks, vs, out, bkv, kb, t, heads,
                               head_dim, scale, s);
  return launch_serial<float, int8_t>(q, k, v, mask, ks, vs, out, bkv, kb, t,
                                      heads, head_dim, scale, s);
}

// The same two functions through the serial body in either dtype, for
// timing the two bodies side by side
extern "C" int smx_decode_attention_serial(const void* q, const void* k,
                                           const void* v, const void* mask,
                                           void* out, int bkv, int kb, int t,
                                           int heads, int head_dim,
                                           float scale, int dtype, int device,
                                           void* stream) {
  const int err = check(q, k, v, out, bkv, kb, t, heads, head_dim, device);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == smx::kBF16)
    return launch_serial<bf16, bf16>(q, k, v, mask, nullptr, nullptr, out, bkv,
                                     kb, t, heads, head_dim, scale, s);
  return launch_serial<float, float>(q, k, v, mask, nullptr, nullptr, out, bkv,
                                     kb, t, heads, head_dim, scale, s);
}

extern "C" int smx_decode_attention_q8_serial(
    const void* q, const void* k, const void* v, const void* mask,
    const float* ks, const float* vs, void* out, int bkv, int kb, int t,
    int heads, int head_dim, float scale, int dtype, int device,
    void* stream) {
  const int err =
      check_q8(q, k, v, ks, vs, out, bkv, kb, t, heads, head_dim, device);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == smx::kBF16)
    return launch_serial<bf16, int8_t>(q, k, v, mask, ks, vs, out, bkv, kb, t,
                                       heads, head_dim, scale, s);
  return launch_serial<float, int8_t>(q, k, v, mask, ks, vs, out, bkv, kb, t,
                                      heads, head_dim, scale, s);
}
