// K7: attention_bwd — backward of masked multi-head attention,
//   out = softmax(q k^T * scale + mask) v,  per (batch, head),
// on the (B, T, H*D) projection slabs, D = 64: given g = d(out) it writes dq,
// dk and dv with the probabilities recomputed on chip (entry
// smx_attention_bwd).  K15: attention_dropout_bwd — the same for K14's
// out = (p * m) v (entry smx_attention_dropout_bwd), with the mask m
// regenerated per tile in both tiled passes from dropout.cuh (the forward's
// key, stream 0, row (b * H + h) * Tq + q, column k):
//   dv_j = sum_i round(p_ij m_ij) g_i      dp_ij = (g_i . v_j) m_ij
//   ds_ij = round(p_ij (dp_ij - delta_i))
// delta_i = g_i . out_i stays right, as out is the dropped output:
// sum_j p_ij dp_ij = sum_j p_ij m_ij (g_i . v_j) = g_i . out_i.  K15
// replaces the TPU kernels of flash_attention_kernel.py: _dropout_bwd
// (_attn_bwd_dropout_fused_kernel, _attn_bwd_dropout_kernel), which regenerate
// the mask from (seed, program_id) and stop at T = 1024.
//
// Replaces the TPU kernels of
// speechmix_tpu/ops/pallas/flash_attention_kernel.py:
// _flash_bwd_fused_layout (_attn_bwd_fused_kernel, heads as 64-lane columns
// of the (B, T, H*D) slabs) and _trainable_bwd (_attn_bwd_kernel, heads
// transposed to (B*H, T, D)).  Reading heads by stride covers both layouts.
// The TPU kernels hold a whole (Tq, Tk) f32 score matrix per head and stop at
// T = 1024; this one tiles both axes and takes any length.
//
// q, out, g, dq: (B, Tq, H*D); k, v, dk, dv: (B, Tk, H*D), float32 or
// bfloat16, 16-byte aligned; mask: (B, Tk) bool (1 = key valid); lse:
// (B, H, Tq) float32, the row log-sum-exp attention_fwd.cu wrote; delta:
// (B, H, Tq) float32 workspace.  With p = exp(s - lse):
//   delta_i = sum_d g_id out_id           (= sum_j p_ij dp_ij)
//   dv_j = sum_i round(p_ij) g_i          dp_ij = g_i . v_j
//   ds_ij = round(p_ij (dp_ij - delta_i))
//   dq_i = scale sum_j ds_ij k_j          dk_j = scale sum_i ds_ij q_i
// where round() is to the tensors' dtype (the TPU kernel's roundings) and all
// sums are f32.  Excluded logits are -1e30 as in the forward kernel.  A row
// whose every logit is excluded has lse = -1e30, in which log(Tk) is lost;
// its probabilities are 1 / Tk on every key, as the softmax of a constant row
// is, and the kernel takes that branch when lse <= -1e29.
//
// Three passes, no atomics, so the result does not depend on scheduling:
//   delta:   one warp per (batch, query, head);
//   dk, dv:  one block per (64-key tile, head, batch) loops over the query
//            tiles and accumulates p^T g and ds^T q;
//   dq:      one block per (64-query tile, head, batch) loops over the key
//            tiles and accumulates ds k.
// Both tiled passes recompute s = q k^T and dp = g v^T per 64 x 64 tile.  The
// five products per tile pair run as 64 x 64 x 64 block products: on the
// tensor cores for bfloat16 (WMMA, bf16 in, f32 accumulate; s and dp staged
// in shared memory as f32, p and ds as bf16), as f32 FMAs for float32 (each
// thread a 4 x 4 patch).  Tiles are not skipped under `causal`: a row that is
// excluded everywhere attends every key (above), so a tile above the diagonal
// is not always empty.
//
// What bounds it on the H100: 10 * H * D * Tq * sum(valid keys) FLOPs for the
// five products (this kernel computes s and dp twice: 14) against the seven
// slabs' traffic; at the flagship speech shape the tensor cores are the limit.
// The kernel stages every operand through shared memory without overlap of
// loads and math, so it stays well above that bound (PERF.md).

#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int D = 64;
constexpr int BT = 64;    // tile edge, queries and keys
constexpr int NT = 256;   // 8 warps
constexpr int LDF = 68;   // f32 staging row (s, dp, and the output tiles)
constexpr float kNegInf = -1e30f;
constexpr float kAllMasked = -1e29f;

// 64 x 64 x 64 block products by the 256 threads of a block.  A(m, k) is
// A[m * lda + k], or A[k * lda + m] with TA; B(k, n) is B[k * ldb + n], or
// B[n * ldb + k] with TB.
template <typename T>
struct Tiles;

template <>
struct Tiles<float> {
  static constexpr int LD = 68;  // operand tile row (float4-aligned)
  struct Acc {
    float v[4][4];  // rows ty * 4 .., columns tx * 4 ..
  };
  static __device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc.v[i][j] = 0.0f;
  }
  template <bool TA, bool TB>
  static __device__ __forceinline__ void mma(Acc& acc, const float* A, int lda,
                                             const float* B, int ldb) {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
    for (int k = 0; k < BT; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = TA ? A[k * lda + ty * 4 + i] : A[(ty * 4 + i) * lda + k];
        b[i] = TB ? B[(tx * 4 + i) * ldb + k] : B[k * ldb + tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc.v[i][j] += a[i] * b[j];
    }
  }
  static __device__ __forceinline__ void store(Acc& acc, float* C, int ldc,
                                               float mult) {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        C[(ty * 4 + i) * ldc + tx * 4 + j] = acc.v[i][j] * mult;
  }
};

template <>
struct Tiles<bf16> {
  static constexpr int LD = 72;  // bf16 operand tile row (16-byte aligned)
  // warp w owns the 16-row tile w / 2 and the two 16-column tiles
  // (w % 2) * 2 + {0, 1}
  struct Acc {
    wm::fragment<wm::accumulator, 16, 16, 16, float> f[2];
  };
  static __device__ __forceinline__ void zero(Acc& acc) {
    wm::fill_fragment(acc.f[0], 0.0f);
    wm::fill_fragment(acc.f[1], 0.0f);
  }
  template <bool TA, bool TB>
  static __device__ __forceinline__ void mma(Acc& acc, const bf16* A, int lda,
                                             const bf16* B, int ldb) {
    const int warp = threadIdx.x >> 5;
    const int rt = warp >> 1, ct0 = (warp & 1) * 2;
    using LayA = typename std::conditional<TA, wm::col_major, wm::row_major>::type;
    using LayB = typename std::conditional<TB, wm::col_major, wm::row_major>::type;
#pragma unroll
    for (int k = 0; k < BT; k += 16) {
      wm::fragment<wm::matrix_a, 16, 16, 16, bf16, LayA> a;
      wm::load_matrix_sync(a, TA ? A + k * lda + rt * 16 : A + rt * 16 * lda + k,
                           lda);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int ct = ct0 + c;
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, LayB> b;
        wm::load_matrix_sync(b, TB ? B + ct * 16 * ldb + k : B + k * ldb + ct * 16,
                             ldb);
        wm::mma_sync(acc.f[c], a, b, acc.f[c]);
      }
    }
  }
  static __device__ __forceinline__ void store(Acc& acc, float* C, int ldc,
                                               float mult) {
    const int warp = threadIdx.x >> 5;
    const int rt = warp >> 1, ct0 = (warp & 1) * 2;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int i = 0; i < acc.f[c].num_elements; ++i) acc.f[c].x[i] *= mult;
      wm::store_matrix_sync(C + rt * 16 * ldc + (ct0 + c) * 16, acc.f[c], ldc,
                            wm::mem_row_major);
    }
  }
};

// rows t0 .. t0 + 63 (zero past tmax) of one head of a slab into a tile, in
// 16-byte words
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          long long row, int t0, int tmax) {
  constexpr int LD = Tiles<T>::LD;
  constexpr int VEC = 16 / sizeof(T);
  for (int i = threadIdx.x; i < BT * (D / VEC); i += NT) {
    const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < tmax) {
      val = *reinterpret_cast<const uint4*>(src + (t0 + r) * row + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// rows t0 .. of an f32 staged tile into one head of a slab
template <typename T>
__device__ __forceinline__ void write_tile(T* __restrict__ dst, const float* src,
                                           long long row, int t0, int tmax) {
  for (int i = threadIdx.x; i < BT * D; i += NT) {
    const int r = i / D, c = i % D;
    if (t0 + r < tmax) dst[(t0 + r) * row + c] = smx::from_f32<T>(src[r * LDF + c]);
  }
}

template <typename T>
constexpr size_t tile_bytes() {
  return (size_t)BT * Tiles<T>::LD * sizeof(T);
}
constexpr size_t kStageBytes = (size_t)BT * LDF * sizeof(float);

// four operand tiles, two f32 staging tiles, two tiles of p and ds
template <typename T>
constexpr size_t smem_bytes() {
  return 6 * tile_bytes<T>() + 2 * kStageBytes;
}

// p and ds of one 64 x 64 tile from the staged s and dp.  ps may be null.
template <typename T>
__device__ __forceinline__ void probs_and_ds(
    const float* sf, const float* dpf, T* ps, T* dss, const float* lse_s,
    const float* delta_s, const unsigned char* kmask_s, int q0, int k0, int tq,
    int tk, float scale, int causal) {
  constexpr int LD = Tiles<T>::LD;
  const float inv_tk = 1.0f / (float)tk;
  for (int i = threadIdx.x; i < BT * BT; i += NT) {
    const int r = i / BT, c = i % BT;
    const int qi = q0 + r, kj = k0 + c;
    float p = 0.0f;
    if (qi < tq && kj < tk) {
      const float l = lse_s[r];
      if (l <= kAllMasked) {
        p = inv_tk;
      } else {
        const float x = (!kmask_s[c] || (causal && kj > qi))
                            ? kNegInf : sf[r * LDF + c] * scale;
        p = expf(x - l);
      }
    }
    if (ps != nullptr) ps[r * LD + c] = smx::from_f32<T>(p);
    dss[r * LD + c] = smx::from_f32<T>(p * (dpf[r * LDF + c] - delta_s[r]));
  }
}

// probs_and_ds with the dropout mask: ps = round(p * m), dss = round(p *
// (dp * m - delta)); one Philox call per four columns of a row.
template <typename T>
__device__ __forceinline__ void probs_and_ds_drop(
    const float* sf, const float* dpf, T* ps, T* dss, const float* lse_s,
    const float* delta_s, const unsigned char* kmask_s, int q0, int k0, int tq,
    int tk, float scale, int causal, const smx::Dropout& drop,
    long long row0) {
  constexpr int LD = Tiles<T>::LD;
  const float inv_tk = 1.0f / (float)tk;
  for (int i = threadIdx.x; i < BT * (BT / 4); i += NT) {
    const int r = i / (BT / 4), c4 = (i % (BT / 4)) * 4;
    const int qi = q0 + r;
    const uint4 bits = drop.bits4(row0 + qi, (k0 + c4) / 4);
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
                              ? kNegInf : sf[r * LDF + c] * scale;
          p = expf(x - l);
        }
      }
      const float m = drop.keep(smx::word(bits, j));
      if (ps != nullptr) ps[r * LD + c] = smx::from_f32<T>(p * m);
      dss[r * LD + c] = smx::from_f32<T>(p * (dpf[r * LDF + c] * m - delta_s[r]));
    }
  }
}

// delta[b, h, i] = sum_d g[b, i, h, d] * out[b, i, h, d]: one warp each
template <typename T>
__global__ void __launch_bounds__(NT)
    attention_bwd_delta_kernel(const T* __restrict__ g, const T* __restrict__ o,
                               float* __restrict__ delta, int tq, int heads,
                               long long total) {
  const long long w = (long long)blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  if (w >= total) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int h = (int)(w % heads);
  const long long bi = w / heads;  // b * tq + i
  const T* gp = g + w * D;
  const T* op = o + w * D;
  float s = smx::to_f32(gp[lane]) * smx::to_f32(op[lane]) +
            smx::to_f32(gp[lane + 32]) * smx::to_f32(op[lane + 32]);
  s = smx::warp_sum(s);
  if (lane == 0) {
    const long long b = bi / tq, i = bi % tq;
    delta[(b * heads + h) * tq + i] = s;
  }
}

template <typename T, bool DROP>
__global__ void __launch_bounds__(NT)
    attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ g,
                              const unsigned char* __restrict__ mask,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              T* __restrict__ dk, T* __restrict__ dv, int tq,
                              int tk, int heads, float scale, int causal,
                              smx::Dropout drop) {
  using TL = Tiles<T>;
  constexpr int LD = TL::LD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + BT * LD;
  T* qs = vs + BT * LD;
  T* gs = qs + BT * LD;
  T* ps = gs + BT * LD;
  T* dss = ps + BT * LD;
  float* sf = reinterpret_cast<float*>(dss + BT * LD);
  float* dpf = sf + BT * LDF;
  __shared__ float lse_s[BT], delta_s[BT];
  __shared__ unsigned char kmask_s[BT];
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BT, head = blockIdx.y, b = blockIdx.z;
  const long long row = (long long)heads * D;
  const T* qb = q + (long long)b * tq * row + head * D;
  const T* gb = g + (long long)b * tq * row + head * D;
  const T* kb = k + (long long)b * tk * row + head * D;
  const T* vb = v + (long long)b * tk * row + head * D;
  const float* lb = lse + ((long long)b * heads + head) * tq;
  const float* db = delta + ((long long)b * heads + head) * tq;

  load_tile<T>(ks, kb, row, k0, tk);
  load_tile<T>(vs, vb, row, k0, tk);
  if (tid < BT) {
    kmask_s[tid] = k0 + tid < tk ? mask[(long long)b * tk + k0 + tid] : 0;
  }
  typename TL::Acc dk_acc, dv_acc;
  TL::zero(dk_acc);
  TL::zero(dv_acc);

  for (int q0 = 0; q0 < tq; q0 += BT) {
    __syncthreads();  // the last tile's readers of qs, gs, ps, dss are done
    load_tile<T>(qs, qb, row, q0, tq);
    load_tile<T>(gs, gb, row, q0, tq);
    if (tid < BT) {
      const bool in = q0 + tid < tq;
      lse_s[tid] = in ? lb[q0 + tid] : 0.0f;
      delta_s[tid] = in ? db[q0 + tid] : 0.0f;
    }
    __syncthreads();
    {
      typename TL::Acc s_acc, dp_acc;
      TL::zero(s_acc);
      TL::template mma<false, true>(s_acc, qs, LD, ks, LD);   // q k^T
      TL::store(s_acc, sf, LDF, 1.0f);
      TL::zero(dp_acc);
      TL::template mma<false, true>(dp_acc, gs, LD, vs, LD);  // g v^T
      TL::store(dp_acc, dpf, LDF, 1.0f);
    }
    __syncthreads();
    if constexpr (DROP) {
      probs_and_ds_drop<T>(sf, dpf, ps, dss, lse_s, delta_s, kmask_s, q0, k0,
                           tq, tk, scale, causal, drop,
                           ((long long)b * heads + head) * tq);
    } else {
      probs_and_ds<T>(sf, dpf, ps, dss, lse_s, delta_s, kmask_s, q0, k0, tq, tk,
                      scale, causal);
    }
    __syncthreads();
    TL::template mma<true, false>(dv_acc, ps, LD, gs, LD);    // p^T g
    TL::template mma<true, false>(dk_acc, dss, LD, qs, LD);   // ds^T q
  }
  __syncthreads();
  TL::store(dv_acc, sf, LDF, 1.0f);
  TL::store(dk_acc, dpf, LDF, scale);
  __syncthreads();
  write_tile<T>(dv + (long long)b * tk * row + head * D, sf, row, k0, tk);
  write_tile<T>(dk + (long long)b * tk * row + head * D, dpf, row, k0, tk);
}

template <typename T, bool DROP>
__global__ void __launch_bounds__(NT)
    attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ g,
                            const unsigned char* __restrict__ mask,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            T* __restrict__ dq, int tq, int tk, int heads,
                            float scale, int causal, smx::Dropout drop) {
  using TL = Tiles<T>;
  constexpr int LD = TL::LD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + BT * LD;
  T* qs = vs + BT * LD;
  T* gs = qs + BT * LD;
  T* dss = gs + BT * LD;
  float* sf = reinterpret_cast<float*>(dss + 2 * BT * LD);
  float* dpf = sf + BT * LDF;
  __shared__ float lse_s[BT], delta_s[BT];
  __shared__ unsigned char kmask_s[BT];
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BT, head = blockIdx.y, b = blockIdx.z;
  const long long row = (long long)heads * D;
  const T* kb = k + (long long)b * tk * row + head * D;
  const T* vb = v + (long long)b * tk * row + head * D;

  load_tile<T>(qs, q + (long long)b * tq * row + head * D, row, q0, tq);
  load_tile<T>(gs, g + (long long)b * tq * row + head * D, row, q0, tq);
  if (tid < BT) {
    const bool in = q0 + tid < tq;
    const long long at = ((long long)b * heads + head) * tq + q0 + tid;
    lse_s[tid] = in ? lse[at] : 0.0f;
    delta_s[tid] = in ? delta[at] : 0.0f;
  }
  typename TL::Acc dq_acc;
  TL::zero(dq_acc);

  for (int k0 = 0; k0 < tk; k0 += BT) {
    __syncthreads();  // the last tile's readers of ks, vs, dss are done
    load_tile<T>(ks, kb, row, k0, tk);
    load_tile<T>(vs, vb, row, k0, tk);
    if (tid < BT) {
      kmask_s[tid] = k0 + tid < tk ? mask[(long long)b * tk + k0 + tid] : 0;
    }
    __syncthreads();
    {
      typename TL::Acc s_acc, dp_acc;
      TL::zero(s_acc);
      TL::template mma<false, true>(s_acc, qs, LD, ks, LD);
      TL::store(s_acc, sf, LDF, 1.0f);
      TL::zero(dp_acc);
      TL::template mma<false, true>(dp_acc, gs, LD, vs, LD);
      TL::store(dp_acc, dpf, LDF, 1.0f);
    }
    __syncthreads();
    if constexpr (DROP) {
      probs_and_ds_drop<T>(sf, dpf, static_cast<T*>(nullptr), dss, lse_s,
                           delta_s, kmask_s, q0, k0, tq, tk, scale, causal,
                           drop, ((long long)b * heads + head) * tq);
    } else {
      probs_and_ds<T>(sf, dpf, static_cast<T*>(nullptr), dss, lse_s, delta_s,
                      kmask_s, q0, k0, tq, tk, scale, causal);
    }
    __syncthreads();
    TL::template mma<false, false>(dq_acc, dss, LD, ks, LD);  // ds k
  }
  __syncthreads();
  TL::store(dq_acc, sf, LDF, scale);
  __syncthreads();
  write_tile<T>(dq + (long long)b * tq * row + head * D, sf, row, q0, tq);
}

template <typename T, bool DROP>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* g, const unsigned char* mask, const float* lse,
           float* delta, void* dq, void* dk, void* dv, int batch, int tq,
           int tk, int heads, float scale, int causal, smx::Dropout drop,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dkdv_kernel<T, DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attention_bwd_dq_kernel<T, DROP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(g);
  const long long warps = (long long)batch * tq * heads;
  attention_bwd_delta_kernel<T>
      <<<(unsigned)((warps + NT / 32 - 1) / (NT / 32)), NT, 0, stream>>>(
          gp, static_cast<const T*>(out), delta, tq, heads, warps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dkdv_kernel<T, DROP>
      <<<dim3((tk + BT - 1) / BT, heads, batch), NT, smem, stream>>>(
          qp, kp, vp, gp, mask, lse, delta, static_cast<T*>(dk),
          static_cast<T*>(dv), tq, tk, heads, scale, causal, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_dq_kernel<T, DROP>
      <<<dim3((tq + BT - 1) / BT, heads, batch), NT, smem, stream>>>(
          qp, kp, vp, gp, mask, lse, delta, static_cast<T*>(dq), tq, tk, heads,
          scale, causal, drop);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <bool DROP>
int entry(const void* q, const void* k, const void* v, const void* out,
          const void* g, const unsigned char* mask, const float* lse,
          float* delta, void* dq, void* dk, void* dv, int batch, int tq, int tk,
          int heads, int head_dim, float scale, int causal, smx::Dropout drop,
          int dtype, int device, void* stream) {
  if (head_dim != D || batch <= 0 || tq <= 0 || tk <= 0 || heads <= 0 ||
      heads > 65535 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // every slab is read and written in 16-byte words
  const void* slabs[] = {q, k, v, out, g, dq, dk, dv};
  for (const void* p : slabs) {
    if (!aligned16(p)) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == smx::kBF16) {
    return launch<bf16, DROP>(q, k, v, out, g, mask, lse, delta, dq, dk, dv,
                              batch, tq, tk, heads, scale, causal, drop, s);
  }
  return launch<float, DROP>(q, k, v, out, g, mask, lse, delta, dq, dk, dv,
                             batch, tq, tk, heads, scale, causal, drop, s);
}

}  // namespace

extern "C" int smx_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* out, const void* g,
                                 const unsigned char* mask, const float* lse,
                                 float* delta, void* dq, void* dk, void* dv,
                                 int batch, int tq, int tk, int heads,
                                 int head_dim, float scale, int causal,
                                 int dtype, int device, void* stream) {
  return entry<false>(q, k, v, out, g, mask, lse, delta, dq, dk, dv, batch, tq,
                      tk, heads, head_dim, scale, causal, smx::Dropout{}, dtype,
                      device, stream);
}

// K15: the forward's key (k0, k1) and the probability mask's threshold and
// scale, from the host; `out` is K14's (dropped) output.
extern "C" int smx_attention_dropout_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* g, const unsigned char* mask, const float* lse, float* delta,
    void* dq, void* dk, void* dv, int batch, int tq, int tk, int heads,
    int head_dim, float scale, int causal, uint32_t k0, uint32_t k1,
    uint32_t threshold, float drop_scale, int dtype, int device,
    void* stream) {
  return entry<true>(
      q, k, v, out, g, mask, lse, delta, dq, dk, dv, batch, tq, tk, heads,
      head_dim, scale, causal,
      smx::make_dropout(k0, k1, smx::kStreamAct, threshold, drop_scale), dtype,
      device, stream);
}
