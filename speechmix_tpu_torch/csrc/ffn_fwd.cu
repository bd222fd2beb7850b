// The FFN blocks' forward in bfloat16 on Hopper: K9 ffn_fused, K3
// ffn_res_ln and their dropout twins K13 ffn_dropout and K12
// ffn_dropout_res_ln, each as two or three launches of the passes below.
//
// K9 replaces the TPU kernel speechmix_tpu/ops/pallas/ffn_kernel.py:
// ffn_fused (_kernel), K3 ffn_fused_res_ln (_kernel_res_ln), K13
// ffn_dropout_trainable (_kernel_dropout) and K12
// ffn_dropout_res_ln_trainable (_kernel_dropout_res_ln).  With
// a = x @ w1 + b1 in f32 and round() to bfloat16:
//   up pass (smx_ffn_up, smx_ffn_dropout_up):
//     h = round(act(a) * m_a)                                   (n, f) bf16
//   down pass (smx_ffn_down):       out = round(h @ w2 + b2)     (n, h) bf16
//   down pass (smx_ffn_down_res, smx_ffn_dropout_down_res):
//     z = (h @ w2 + b2) * m_o + res                            (n, h) f32
//   row pass (smx_res_ln_rows):
//     out = round(LayerNorm(z) * g + beta), the mean and then the variance
//     of the centred values of each f32 row                    (n, h) bf16
// K9 is up + down, K13 dropout up + down, K3 up + down_res + rows, K12
// dropout up + dropout down_res + rows.  m_a and m_o are the activation mask
// (stream 0, at (row, f column)) and the output mask (stream 1, at (row, h
// column)) of dropout.cuh; a mask whose threshold is 0 draws no bits.  z is
// kept in f32: a rounding there would change K3's function.  h and z live
// only inside the wrapper's call.
//
// x, res: (n, h); w1: (h, f); w2: (f, h), row-major bfloat16; b1: (f,),
// b2, g, beta: (h,) float32.  Any n >= 1; h and f multiples of 128 (what
// the TPU package's gate admits); operands 16-byte aligned (TMA).  act: 0
// gelu (erf), 1 gelu_new (tanh), 2 relu, 3 silu.  The launchers refuse
// anything else.
//
// What bounds it on the H100: 4 n h f FLOPs (121 GFLOP at n = 12800,
// h = 768, f = 3072: 0.122 ms at the bf16 peak) against ~0.1-0.15 GB of
// traffic with h and z, so the tensor cores.  Both products are one
// TMA + wgmma GEMM kernel (128 x 128 output tiles, 64-deep stages, one
// producer warp, two consumer warpgroups): A (x or h) is read K-major, B
// (w1 or w2) MN-major through the descriptors, never transposed by a copy.
// The up pass's main loop is only h / 64 stages long (12 at h = 768), so its
// activation epilogue is a large share of a block's time: two blocks share
// an SM, with 3-stage rings, and one block's epilogue overlaps the other's
// products.  The down pass loops over f / 64 stages (48) and keeps one
// block per SM with a 4-stage ring (PERF.md has both measured).  The
// epilogues work in the accumulator layout; the row pass is a warp per row.
// Nothing is atomic: two calls give the same bits.

#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hw = smx::hopper;
using bf16 = __nv_bfloat16;
using hw::BK;
using hw::BOX;
using hw::CONSUMERS;
using hw::HALF;
using hw::MN_LBO;
using hw::SBO;
using hw::TILE;
using hw::WG_THREADS;

enum Epilogue {
  kUp = 0,       // round(act(acc + bias) * m) to bf16
  kDown = 1,     // round(acc + bias) to bf16
  kDownRes = 2,  // (acc + bias) * m + res in f32
};

// two consumer warpgroups and one producer warp
constexpr int PASS_THREADS = CONSUMERS + 32;
// stages of 2 tiles (32 KB) in flight, and blocks per SM, by pass
template <int EPI>
constexpr int STAGES = EPI == kUp ? 3 : 4;
template <int EPI>
constexpr int BLOCKS_PER_SM = EPI == kUp ? 2 : 1;

struct PassArgs {
  CUtensorMap a;       // (n, k) in (128, 64) boxes: K-major A
  CUtensorMap b;       // (k, cols) in (64, 64) boxes: MN-major B
  const float* bias;   // (cols,)
  const bf16* res;     // (n, cols): kDownRes
  void* out;           // (n, cols): bf16, or f32 for kDownRes
  int n, k, cols;
  smx::Dropout drop;
};

template <int EPI>
constexpr size_t pass_smem_bytes() {
  return 1024 + (size_t)STAGES<EPI> * 2 * BOX +
         2 * STAGES<EPI> * sizeof(uint64_t);
}

// One consumer thread's 2 x 32 elements of the block's tile: rows
// wrow + 8 i, columns n0 + 8 j + 2 (lane % 4) + c.
template <int EPI, int ACT, bool DROP>
__device__ __forceinline__ void pass_epilogue(const PassArgs& p,
                                              float (&acc)[64], int wrow,
                                              int n0, int lane) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    // cols is a multiple of 128: every column of the tile exists
    const int col = n0 + 8 * j + 2 * (lane % 4);
    const float2 bias = *reinterpret_cast<const float2*>(p.bias + col);
    float m[2][2] = {{1.0f, 1.0f}, {1.0f, 1.0f}};
    if constexpr (DROP) smx::accum_mask(p.drop, wrow, col, lane, m);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = wrow + 8 * i;
      float v0 = acc[4 * j + 2 * i] + bias.x;
      float v1 = acc[4 * j + 2 * i + 1] + bias.y;
      if constexpr (EPI == kUp) {
        v0 = smx::activate(ACT, v0);
        v1 = smx::activate(ACT, v1);
      }
      if constexpr (DROP) {
        v0 *= m[i][0];
        v1 *= m[i][1];
      }
      if (row >= p.n) continue;
      const size_t at = (size_t)row * p.cols + col;
      if constexpr (EPI == kDownRes) {
        const __nv_bfloat162 r =
            *reinterpret_cast<const __nv_bfloat162*>(p.res + at);
        *reinterpret_cast<float2*>(static_cast<float*>(p.out) + at) =
            make_float2(v0 + __low2float(r), v1 + __high2float(r));
      } else {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out) + at) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// out tile (m0, n0) of A (n, k) @ B (k, cols), then the epilogue
template <int EPI, bool DROP>
__global__ void __launch_bounds__(PASS_THREADS, BLOCKS_PER_SM<EPI>)
    ffn_pass_kernel(const __grid_constant__ PassArgs p, int act) {
  constexpr int S = STAGES<EPI>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* as = hw::align1024(smem_raw);  // S x BOX
  uint8_t* bs = as + S * BOX;             // S x BOX
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + S * BOX);
  uint64_t* empty = full + S;

  const int ctiles = p.cols / TILE;
  const int m0 = blockIdx.x / ctiles * TILE, n0 = blockIdx.x % ctiles * TILE;
  const int ksteps = p.k / BK;
  const int wg = threadIdx.x / WG_THREADS;
  hw::init_ring<S>(full, empty);

  if (wg == 2) {  // producer
    if (threadIdx.x == CONSUMERS) {
      hw::Ring<S> ring;
      for (int kb = 0; kb < ksteps; ++kb) {
        const int k = kb * BK, s = ring.s;
        ring.acquire(full, empty, 2 * BOX);
        hw::tma_load(as + s * BOX, &p.a, &full[s], k, m0);
        hw::tma_load(bs + s * BOX, &p.b, &full[s], n0, k);
        hw::tma_load(bs + s * BOX + HALF, &p.b, &full[s], n0 + 64, k);
        ring.advance();
      }
    }
    return;
  }
  // consumers: rows m0 + 64 wg .. + 63
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  hw::fence_regs(acc);
  hw::consume<S>(full, empty, ksteps, [&](int s) {
    const uint8_t* a = as + s * BOX + wg * HALF;
    const uint8_t* b = bs + s * BOX;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      hw::wgmma_m64n128k16<0, 1>(acc, hw::desc_sw128(a + kk * 32, 16, SBO),
                                 hw::desc_sw128(b + kk * 2048, MN_LBO, SBO));
    }
  });
  hw::fence_regs(acc);
  const int t = threadIdx.x % WG_THREADS, warp = t / 32, lane = t % 32;
  const int wrow = m0 + wg * 64 + warp * 16 + lane / 4;
  if constexpr (EPI == kUp) {
    switch (act) {
      case smx::kGelu:
        pass_epilogue<EPI, smx::kGelu, DROP>(p, acc, wrow, n0, lane);
        break;
      case smx::kGeluTanh:
        pass_epilogue<EPI, smx::kGeluTanh, DROP>(p, acc, wrow, n0, lane);
        break;
      case smx::kRelu:
        pass_epilogue<EPI, smx::kRelu, DROP>(p, acc, wrow, n0, lane);
        break;
      default:
        pass_epilogue<EPI, smx::kSilu, DROP>(p, acc, wrow, n0, lane);
    }
  } else {
    pass_epilogue<EPI, smx::kGelu, DROP>(p, acc, wrow, n0, lane);
  }
}

// ------------------------------------------------------------- row pass
constexpr int LN_WARPS = 8;  // rows per block

// out[row] = round((z[row] - mean) * rsqrt(var + eps) * g + beta), one warp
// per row, the row read once for the mean, again for the variance of the
// centred values (as the TPU kernels' epilogue takes it) and again for the
// output (L1 hits)
__global__ void __launch_bounds__(LN_WARPS * 32)
    res_ln_rows_kernel(const float* __restrict__ z,
                       const float* __restrict__ g,
                       const float* __restrict__ beta, bf16* __restrict__ out,
                       int n, int h, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp
  const int quads = h / 4;
  const float4* zr = reinterpret_cast<const float4*>(z + row * h);
  const float inv_h = 1.0f / (float)h;
  float s = 0.0f;
  for (int c = lane; c < quads; c += 32) {
    const float4 v = zr[c];
    s += (v.x + v.y) + (v.z + v.w);
  }
  const float mean = smx::warp_sum(s) * inv_h;
  float ss = 0.0f;
  for (int c = lane; c < quads; c += 32) {
    const float4 v = zr[c];
    const float d0 = v.x - mean, d1 = v.y - mean, d2 = v.z - mean,
                d3 = v.w - mean;
    ss += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
  }
  const float inv = rsqrtf(smx::warp_sum(ss) * inv_h + eps);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  const float4* b4 = reinterpret_cast<const float4*>(beta);
  uint2* o = reinterpret_cast<uint2*>(out + row * h);
  for (int c = lane; c < quads; c += 32) {
    const float4 v = zr[c], gg = g4[c], bb = b4[c];
    const __nv_bfloat162 lo = __floats2bfloat162_rn(
        (v.x - mean) * inv * gg.x + bb.x, (v.y - mean) * inv * gg.y + bb.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(
        (v.z - mean) * inv * gg.z + bb.z, (v.w - mean) * inv * gg.w + bb.w);
    o[c] = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                      *reinterpret_cast<const uint32_t*>(&hi));
  }
}

// ------------------------------------------------------------------ host
bool aligned(const void* p, uintptr_t bytes) {
  return p != nullptr && (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

bool bad_shape(int n, int h, int f) {
  return n <= 0 || h <= 0 || f <= 0 || h % TILE != 0 || f % TILE != 0;
}

// A (n, k) @ B (k, cols) through the epilogue EPI
template <int EPI, bool DROP>
int pass(const void* a, const void* b, const float* bias, const void* res,
         void* out, int n, int k, int cols, int act, smx::Dropout drop,
         int device, void* stream) {
  if (!aligned(a, 16) || !aligned(b, 16) || !aligned(bias, 8) ||
      !aligned(out, 16) || (EPI == kDownRes && !aligned(res, 16)) ||
      act < 0 || act > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  PassArgs p;
  if (!hw::make_map(&p.a, a, n, k, TILE, BK) ||
      !hw::make_map(&p.b, b, k, cols, BK, BK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.bias = bias;
  p.res = static_cast<const bf16*>(res);
  p.out = out;
  p.n = n;
  p.k = k;
  p.cols = cols;
  p.drop = drop;
  const size_t smem = pass_smem_bytes<EPI>();
  err = cudaFuncSetAttribute(ffn_pass_kernel<EPI, DROP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      (long long)((n + TILE - 1) / TILE) * (cols / TILE);
  ffn_pass_kernel<EPI, DROP><<<(unsigned)blocks, PASS_THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(p, act);
  return static_cast<int>(cudaGetLastError());
}

template <bool DROP>
int up(const void* x, const void* w1, const float* b1, void* hid, int n,
       int h, int f, int act, smx::Dropout drop, int device, void* stream) {
  if (bad_shape(n, h, f)) return static_cast<int>(cudaErrorInvalidValue);
  return pass<kUp, DROP>(x, w1, b1, nullptr, hid, n, h, f, act, drop, device,
                         stream);
}

template <int EPI, bool DROP>
int down(const void* hid, const void* w2, const float* b2, const void* res,
         void* out, int n, int h, int f, smx::Dropout drop, int device,
         void* stream) {
  if (bad_shape(n, h, f)) return static_cast<int>(cudaErrorInvalidValue);
  return pass<EPI, DROP>(hid, w2, b2, res, out, n, f, h, 0, drop, device,
                         stream);
}

}  // namespace

// up pass: hid (n, f) bf16
extern "C" int smx_ffn_up(const void* x, const void* w1, const float* b1,
                          void* hid, int n, int h, int f, int act, int device,
                          void* stream) {
  return up<false>(x, w1, b1, hid, n, h, f, act, smx::Dropout{}, device,
                   stream);
}

// the up pass with the activation mask: k0, k1 the site's key, threshold
// and scale of stream 0, from the host
extern "C" int smx_ffn_dropout_up(const void* x, const void* w1,
                                  const float* b1, void* hid, int n, int h,
                                  int f, int act, uint32_t k0, uint32_t k1,
                                  uint32_t threshold, float scale, int device,
                                  void* stream) {
  return up<true>(x, w1, b1, hid, n, h, f, act,
                  smx::make_dropout(k0, k1, smx::kStreamAct, threshold,
                                    scale),
                  device, stream);
}

// down pass: out (n, h) bf16 = round(hid @ w2 + b2)
extern "C" int smx_ffn_down(const void* hid, const void* w2, const float* b2,
                            void* out, int n, int h, int f, int device,
                            void* stream) {
  return down<kDown, false>(hid, w2, b2, nullptr, out, n, h, f,
                            smx::Dropout{}, device, stream);
}

// down pass before the LayerNorm: z (n, h) f32 = hid @ w2 + b2 + res
extern "C" int smx_ffn_down_res(const void* hid, const void* w2,
                                const float* b2, const void* res, float* z,
                                int n, int h, int f, int device,
                                void* stream) {
  return down<kDownRes, false>(hid, w2, b2, res, z, n, h, f, smx::Dropout{},
                               device, stream);
}

// the same with the output mask of stream 1: z = (hid @ w2 + b2) * m_o + res
extern "C" int smx_ffn_dropout_down_res(const void* hid, const void* w2,
                                        const float* b2, const void* res,
                                        float* z, int n, int h, int f,
                                        uint32_t k0, uint32_t k1,
                                        uint32_t threshold, float scale,
                                        int device, void* stream) {
  return down<kDownRes, true>(
      hid, w2, b2, res, z, n, h, f,
      smx::make_dropout(k0, k1, smx::kStreamOut, threshold, scale), device,
      stream);
}

// row pass: out (n, h) bf16 = round(LayerNorm(z) * g + beta)
extern "C" int smx_res_ln_rows(const float* z, const float* g,
                               const float* beta, void* out, int n, int h,
                               float eps, int device, void* stream) {
  if (n <= 0 || h <= 0 || h % 4 != 0 || !aligned(z, 16) || !aligned(g, 16) ||
      !aligned(beta, 16) || !aligned(out, 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  res_ln_rows_kernel<<<(n + LN_WARPS - 1) / LN_WARPS, LN_WARPS * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      z, g, beta, static_cast<bf16*>(out), n, h, eps);
  return static_cast<int>(cudaGetLastError());
}
