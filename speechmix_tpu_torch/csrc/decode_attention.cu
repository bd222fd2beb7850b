// K4: decode_attention — single-query attention over a K/V buffer,
// out = softmax(q . k^T * scale [* k_scale] + mask) [* v_scale] . v per head.
//
// Replaces the TPU kernels speechmix_tpu/ops/pallas/decode_attention.py:
// decode_attention (_kernel, and _kernel_q8 for int8 K/V): every cached
// single-token decoder step, self-attention over the cache capacity and
// cross-attention over the precomputed encoder K/V.
//
// q, out: (bkv * kb, heads, 64) float32 or bfloat16: kb queries share one
// K/V row (the beams of one input, contiguous); kb = 1 is the TPU contract.
// k, v: (bkv, t, heads, 64) in q's type (float entry) or int8 codes (q8
// entry) with float32 scales ks, vs (bkv, t, heads).  mask: (bkv, t) bytes,
// non-zero = attend; a masked logit gets -1e9 added, as the plain path does.
//
// What bounds it on the H100: bytes.  Each K/V element is used once per
// query (2 FLOP per byte or less), and at the decoder's shapes (16 rows,
// 64..400 keys, 12 heads: 1..20 MB) the whole call is a few microseconds of
// memory time, so launch latency and the short per-block loop dominate.  One
// block of 256 threads owns a (K/V row, head, group of up to 8 queries):
//   1. scores: a few lanes per key, each loading contiguous head elements
//      in 16-byte words (8 lanes of 8 elements for bf16 and f32, 4 lanes of
//      16 codes for int8), 32 or 64 keys per pass, dot products reduced with
//      shuffles; K is read once for all queries of the group;
//   2. softmax: warp j normalises query j's scores in shared memory and
//      rounds the probabilities (times the v scale) to q's type, as the
//      plain version does before its value product;
//   3. values: the same lane layout accumulates p . v in f32 registers,
//      reduced over the warp with shuffles and over warps in shared memory.
// int8 codes are converted in registers; the scales multiply the scores (k)
// and the probabilities (v), so no dequantised copy exists in memory.
// Keys after the last attended one of a mask row (cache slots not yet
// written, encoder padding) are not read: their probabilities are exactly 0.
// A mask row that attends nothing keeps the plain version's result, a softmax
// over all the raw scores shifted by -1e9.
// The TPU kernel's one-hot segment matmuls and its rows-per-program unroll
// answer Mosaic's lane rules and grid overhead and have no counterpart.

#include <stdint.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int D = 64;        // head dim
constexpr int NT = 256;      // threads per block
constexpr int NW = NT / 32;  // warps: at most NW queries per block
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

// QT: type of q and out; KT: type of k and v; KBT: queries per block.
// A lane owns EPL contiguous head elements of a key (one 16-byte word of
// bf16 or int8, two of f32); LPK lanes cover a key, KPP keys go per pass.
template <typename QT, typename KT, int KBT>
__global__ void __launch_bounds__(NT)
    decode_attention_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                            const KT* __restrict__ v,
                            const uint8_t* __restrict__ mask,
                            const float* __restrict__ ks,
                            const float* __restrict__ vs, QT* __restrict__ out,
                            int kb, int t, int heads, float scale) {
  constexpr int EPL = sizeof(KT) == 1 ? 16 : 8;
  constexpr int LPK = D / EPL;
  constexpr int KPP = NT / LPK;
  extern __shared__ __align__(16) float smem[];
  float* sc = smem;              // (KBT, n <= t) scores, then probabilities
  float* part = smem + KBT * t;  // (NW, KBT, D) partial outputs
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = tid % LPK, grp = tid / LPK;
  const int b = blockIdx.x, h = blockIdx.y, q0 = blockIdx.z * KBT;
  const long long hd = (long long)heads * D;
  const long long kv_base =
      (long long)b * t * hd + (long long)h * D + sub * EPL;

  float qr[KBT][EPL];
#pragma unroll
  for (int j = 0; j < KBT; ++j) {
    if (q0 + j < kb) {
      load_elems<EPL>(q + ((long long)b * kb + q0 + j) * hd + h * D + sub * EPL,
                      qr[j]);
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
    load_elems<EPL>(k + kv_base + (long long)key * hd, kf);
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
    load_elems<EPL>(v + kv_base + (long long)key * hd, vf);
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
      if (lane < LPK) part[(warp * KBT + j) * D + sub * EPL + e] = a;
    }
  __syncthreads();
  for (int i = tid; i < KBT * D; i += NT) {
    const int j = i / D, d = i % D;
    if (q0 + j >= kb) continue;
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < NW; ++w) a += part[(w * KBT + j) * D + d];
    out[((long long)b * kb + q0 + j) * hd + h * D + d] = smx::from_f32<QT>(a);
  }
}

constexpr size_t kMaxSmem = 232448;  // shared memory a block can use

template <typename QT, typename KT, int KBT>
int launch_kbt(const void* q, const void* k, const void* v, const void* mask,
               const float* ks, const float* vs, void* out, int bkv, int kb,
               int t, int heads, float scale, cudaStream_t stream) {
  const size_t smem = ((size_t)KBT * t + (size_t)NW * KBT * D) * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = decode_attention_kernel<QT, KT, KBT>;
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
      static_cast<QT*>(out), kb, t, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const float* ks, const float* vs, void* out, int bkv, int kb, int t,
           int heads, float scale, cudaStream_t s) {
  if (kb == 1)
    return launch_kbt<QT, KT, 1>(q, k, v, mask, ks, vs, out, bkv, kb, t, heads,
                                 scale, s);
  if (kb == 2)
    return launch_kbt<QT, KT, 2>(q, k, v, mask, ks, vs, out, bkv, kb, t, heads,
                                 scale, s);
  if (kb <= 4)
    return launch_kbt<QT, KT, 4>(q, k, v, mask, ks, vs, out, bkv, kb, t, heads,
                                 scale, s);
  return launch_kbt<QT, KT, 8>(q, k, v, mask, ks, vs, out, bkv, kb, t, heads,
                               scale, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int check(const void* q, const void* k, const void* v, const void* out,
          int bkv, int kb, int t, int heads, int head_dim, int device) {
  if (bkv <= 0 || kb <= 0 || t <= 0 || heads <= 0 || head_dim != D ||
      heads > 65535 || (kb + NW - 1) / NW > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  return static_cast<int>(cudaSetDevice(device));
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
    return launch<bf16, bf16>(q, k, v, mask, nullptr, nullptr, out, bkv, kb, t,
                              heads, scale, s);
  return launch<float, float>(q, k, v, mask, nullptr, nullptr, out, bkv, kb, t,
                              heads, scale, s);
}

// k, v int8 codes with per-(token, head) float32 scales
extern "C" int smx_decode_attention_q8(const void* q, const void* k,
                                       const void* v, const void* mask,
                                       const float* ks, const float* vs,
                                       void* out, int bkv, int kb, int t,
                                       int heads, int head_dim, float scale,
                                       int dtype, int device, void* stream) {
  const int err = check(q, k, v, out, bkv, kb, t, heads, head_dim, device);
  if (err != 0) return err;
  if (ks == nullptr || vs == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == smx::kBF16)
    return launch<bf16, int8_t>(q, k, v, mask, ks, vs, out, bkv, kb, t, heads,
                                scale, s);
  return launch<float, int8_t>(q, k, v, mask, ks, vs, out, bkv, kb, t, heads,
                               scale, s);
}
