// K1: attention_fwd — masked multi-head attention forward,
//   out = softmax(q k^T * scale + mask) v,  per (batch, head),
// on the (B, T, H*D) projection slabs, D = 64 (entry smx_attention_fwd), and
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
// hold the same four keys of rows qr0 and qr1, each draw one row's four words
// and swap the halves the other needs: one Philox call per four
// probabilities.  There is no length limit (the TPU kernels hold whole rows
// and stop at T = 1024).
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
// masked row gives a finite average, never NaN.
// lse: optional (B, H, Tq) float32 output, the row log-sum-exp of the masked,
// scaled logits (max + log denominator), which attention_bwd.cu reads to
// recompute the probabilities; null skips it.
//
// What bounds it on the H100: at the flagship speech shape (B = 16,
// T = 800, H = 12) the two products are 4*B*H*T*T*D ~ 31 GFLOP against
// ~60 MB of q/k/v/out traffic, so the tensor cores are the limit
// (~0.03 ms).  The bf16 kernel uses them (mma.sync); its online-softmax
// arithmetic on the CUDA cores and the per-tile k/v staging keep it ~10x
// above that bound (PERF.md).  Each dtype has one kernel: float32 inputs
// (the f32 reference runs) take an f32-FMA kernel, bound by those FMAs.
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
// bfloat16 kernel, on the tensor cores, in the FlashAttention-2 layout: one
// block of 4 warps per (64-query tile, head, batch); each warp owns 16 query
// rows and keeps their q fragments in registers.  Per 64-key tile (k and v
// staged in shared memory as bf16, rows padded so fragment loads hit
// distinct banks), a warp computes its 16 x 64 scores with mma.sync
// m16n8k16 (bf16 in, f32 accumulate), runs the online softmax on the
// accumulator registers (the four lanes of a row reduce with shuffles), and
// feeds the probabilities, rounded to bf16, straight back as the A operand
// of P . v into its 16 x 64 f32 output accumulator, also in registers.  The
// denominator sums the f32 probabilities.

#include <math.h>

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int D = 64;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int LD = 68;  // padded row of the transposed tiles (float4-aligned)
constexpr float kNegInf = -1e30f;
constexpr size_t kSmem = (size_t)(D * LD + D * LD + BK * D) * sizeof(float);

template <bool DROP>
__global__ void __launch_bounds__(NT)
    attention_fwd_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const unsigned char* __restrict__ mask,
                         float* __restrict__ out, float* __restrict__ lse,
                         int tq, int tk, int heads, float scale, int causal,
                         smx::Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;           // (D, LD): qs[d * LD + query]
  float* ks = qs + D * LD;    // (D, LD): ks[d * LD + key]; then P (BK, LD)
  float* vs = ks + D * LD;    // (BK, D): vs[key * D + d]
  const int tid = threadIdx.x;
  const int tx = tid & 15;    // keys tx*4 .. +3 of the score tile; dims of out
  const int ty = tid >> 4;    // queries ty*4 .. +3
  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const long long row = (long long)heads * D;  // slab row stride
  const float* qb = q + (long long)b * tq * row + head * D;
  const float* kb = k + (long long)b * tk * row + head * D;
  const float* vb = v + (long long)b * tk * row + head * D;
  const unsigned char* mb = mask + (long long)b * tk;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D;
    const int t = q0 + r;
    qs[d * LD + r] = t < tq ? qb[t * row + d] : 0.0f;
  }

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < tk; k0 += BK) {
    __syncthreads();  // previous tile's readers of ks / vs are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, d = i % D;
      const int t = k0 + r;
      const bool in = t < tk;
      ks[d * LD + r] = in ? kb[t * row + d] : 0.0f;
      vs[r * D + d] = in ? vb[t * row + d] : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qs + d * LD + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(ks + d * LD + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
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
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
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
      const float4 c = *reinterpret_cast<const float4*>(vs + kk * D + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * cv[j];
    }
  }

  float* ob = out + (long long)b * tq * row + head * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= tq) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ob[t * row + tx * 4 + j] = acc[i][j] * inv;
    }
    if (lse != nullptr && tx == 0) {
      lse[((long long)b * heads + head) * tq + t] = m[i] + logf(l[i]);
    }
  }
}

template <bool DROP>
int launch_f32(const void* q, const void* k, const void* v,
               const unsigned char* mask, void* out, float* lse, int batch,
               int tq, int tk, int heads, float scale, int causal,
               smx::Dropout drop, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel<DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((tq + BQ - 1) / BQ, heads, batch);
  attention_fwd_kernel<DROP><<<grid, NT, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), mask, static_cast<float*>(out), lse, tq,
      tk, heads, scale, causal, drop);
  return static_cast<int>(cudaGetLastError());
}


using bf16 = __nv_bfloat16;

constexpr int TC_NT = 128;   // 4 warps x 16 query rows = BQ
constexpr int LDB = D + 8;   // bf16 row of the k / v tiles (conflict-free)

// d = a(16x16, row) . b(16x8, col) + d, bf16 in, f32 accumulate.  Fragment
// layouts (PTX ISA, mma.m16n8k16): with g = lane / 4 and t = lane % 4,
// a[0]: (g, 2t..2t+1), a[1]: (g+8, 2t..), a[2]: (g, 2t+8..), a[3]: (g+8, 2t+8..);
// b[0]: (k = 2t..2t+1, n = g), b[1]: (k = 2t+8.., n = g);
// d[0..1]: (g, 2t..2t+1), d[2..3]: (g+8, 2t..2t+1).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

template <bool DROP>
__global__ void __launch_bounds__(TC_NT)
    attention_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const unsigned char* __restrict__ mask,
                            bf16* __restrict__ out, float* __restrict__ lse,
                            int tq, int tk, int heads, float scale, int causal,
                            smx::Dropout drop) {
  __shared__ __align__(16) bf16 ks[BK * LDB];
  __shared__ __align__(16) bf16 vs[BK * LDB];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * BQ, head = blockIdx.y, b = blockIdx.z;
  const long long row = (long long)heads * D;
  const bf16* kb = k + (long long)b * tk * row + head * D;
  const bf16* vb = v + (long long)b * tk * row + head * D;
  const unsigned char* mb = mask + (long long)b * tk;
  // this thread's two query rows
  const int qr0 = q0 + warp * 16 + g, qr1 = qr0 + 8;

  // q fragments of the warp's 16 rows, straight from the slab (rows past tq
  // are zero)
  uint32_t qa[D / 16][4];
  {
    const bf16* qb = q + (long long)b * tq * row + head * D;
    const uint32_t* r0p = reinterpret_cast<const uint32_t*>(qb + qr0 * row);
    const uint32_t* r1p = reinterpret_cast<const uint32_t*>(qb + qr1 * row);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = (kk * 16 + 2 * t4) / 2;  // in 32-bit words
      qa[kk][0] = qr0 < tq ? r0p[c] : 0u;
      qa[kk][1] = qr1 < tq ? r1p[c] : 0u;
      qa[kk][2] = qr0 < tq ? r0p[c + 4] : 0u;
      qa[kk][3] = qr1 < tq ? r1p[c + 4] : 0u;
    }
  }
  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nt][i] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  for (int k0 = 0; k0 < tk; k0 += BK) {
    __syncthreads();  // every warp is done with the previous k / v tiles
    for (int i = threadIdx.x; i < BK * (D / 8); i += TC_NT) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < tk) {
        kv = *reinterpret_cast<const uint4*>(kb + (k0 + r) * row + c);
        vv = *reinterpret_cast<const uint4*>(vb + (k0 + r) * row + c);
      }
      *reinterpret_cast<uint4*>(ks + r * LDB + c) = kv;
      *reinterpret_cast<uint4*>(vs + r * LDB + c) = vv;
    }
    __syncthreads();

    // scores of this warp's 16 rows x 64 keys: 8 tiles of 8 keys
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.0f;
      const uint32_t* kr =
          reinterpret_cast<const uint32_t*>(ks + (nt * 8 + g) * LDB);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = (kk * 16 + 2 * t4) / 2;
        mma16816(s[nt], qa[kk], kr[c], kr[c + 4]);
      }
    }
    // mask and scale; the online-softmax update of both rows
    float rmax0 = -INFINITY, rmax1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kj = k0 + nt * 8 + 2 * t4 + (i & 1);
        const int qi = i < 2 ? qr0 : qr1;
        float x;
        if (kj >= tk) {
          x = -INFINITY;  // past the end: no weight at all
        } else if (!mb[kj] || (causal && kj > qi)) {
          x = kNegInf;
        } else {
          x = s[nt][i] * scale;
        }
        s[nt][i] = x;
        if (i < 2) rmax0 = fmaxf(rmax0, x); else rmax1 = fmaxf(rmax1, x);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      rmax0 = fmaxf(rmax0, __shfl_xor_sync(0xffffffffu, rmax0, off));
      rmax1 = fmaxf(rmax1, __shfl_xor_sync(0xffffffffu, rmax1, off));
    }
    // the tile holds key k0 < tk, so each row max >= kNegInf is finite
    const float mn0 = fmaxf(m0, rmax0), mn1 = fmaxf(m1, rmax1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);  // 0 at first
    float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - mn0);
      s[nt][1] = expf(s[nt][1] - mn0);
      s[nt][2] = expf(s[nt][2] - mn1);
      s[nt][3] = expf(s[nt][3] - mn1);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      o[nt][0] *= al0;
      o[nt][1] *= al0;
      o[nt][2] *= al1;
      o[nt][3] *= al1;
    }
    if constexpr (DROP) {
      // lanes t4 and t4 ^ 1 hold keys 4 j .. 4 j + 3 of rows qr0 and qr1:
      // the even lane draws row qr0's words, the odd lane row qr1's, and
      // each sends the other the two words of its keys
      const bool odd = t4 & 1;
      const long long row =
          ((long long)b * heads + head) * tq + (odd ? qr1 : qr0);
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const uint4 r = drop.bits4(row, (k0 + nt * 8) / 4 + (t4 >> 1));
        const uint32_t got0 = __shfl_xor_sync(0xffffffffu, odd ? r.x : r.z, 1);
        const uint32_t got1 = __shfl_xor_sync(0xffffffffu, odd ? r.y : r.w, 1);
        // words of keys 2 t4, 2 t4 + 1: even lanes own r.x, r.y of qr0;
        // odd lanes own r.z, r.w of qr1
        s[nt][0] *= drop.keep(odd ? got0 : r.x);
        s[nt][1] *= drop.keep(odd ? got1 : r.y);
        s[nt][2] *= drop.keep(odd ? r.z : got0);
        s[nt][3] *= drop.keep(odd ? r.w : got1);
      }
    }
    // o += P . v: the score accumulators of key tiles 2kk, 2kk+1 are the
    // A fragment of keys 16kk .. 16kk+15
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const bf16* v0 = vs + (kk * 16 + 2 * t4) * LDB + g;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        const bf16* vp = v0 + nt * 8;
        mma16816(o[nt], pa, pack_bf16(vp[0], vp[LDB]),
                 pack_bf16(vp[8 * LDB], vp[9 * LDB]));
      }
    }
  }

  bf16* ob = out + (long long)b * tq * row + head * D + 2 * t4;
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f), inv1 = 1.0f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    if (qr0 < tq) {
      *reinterpret_cast<uint32_t*>(ob + qr0 * row + nt * 8) =
          pack_bf16(o[nt][0] * inv0, o[nt][1] * inv0);
    }
    if (qr1 < tq) {
      *reinterpret_cast<uint32_t*>(ob + qr1 * row + nt * 8) =
          pack_bf16(o[nt][2] * inv1, o[nt][3] * inv1);
    }
  }
  if (lse != nullptr && t4 == 0) {
    float* lb = lse + ((long long)b * heads + head) * tq;
    if (qr0 < tq) lb[qr0] = m0 + logf(l0);
    if (qr1 < tq) lb[qr1] = m1 + logf(l1);
  }
}

template <bool DROP>
int launch_tc(const void* q, const void* k, const void* v,
              const unsigned char* mask, void* out, float* lse, int batch,
              int tq, int tk, int heads, float scale, int causal,
              smx::Dropout drop, cudaStream_t stream) {
  dim3 grid((tq + BQ - 1) / BQ, heads, batch);
  attention_fwd_tc_kernel<DROP><<<grid, TC_NT, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), mask, static_cast<bf16*>(out), lse, tq, tk,
      heads, scale, causal, drop);
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
  if (head_dim != D || batch <= 0 || tq <= 0 || tk <= 0 || heads <= 0 ||
      heads > 65535 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == smx::kBF16) {
    // the tensor-core kernel reads q / k / v rows as 16-byte words
    if (!aligned16(q) || !aligned16(k) || !aligned16(v)) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    return launch_tc<DROP>(q, k, v, mask, out, lse, batch, tq, tk, heads,
                           scale, causal, drop, s);
  }
  return launch_f32<DROP>(q, k, v, mask, out, lse, batch, tq, tk, heads, scale,
                          causal, drop, s);
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
