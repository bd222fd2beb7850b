// The FFN blocks' forward on Hopper: K9 ffn_fused, K3 ffn_res_ln and their
// dropout twins K13 ffn_dropout and K12 ffn_dropout_res_ln, each as two or
// three launches of the passes below, in bfloat16 and in float32; and K2
// dense_res_ln and its twin K11 dense_dropout_res_ln in float32, the down
// pass to z and the row pass behind one entry each.
//
// K9 replaces the TPU kernel speechmix_tpu/ops/pallas/ffn_kernel.py:
// ffn_fused (_kernel), K3 ffn_fused_res_ln (_kernel_res_ln), K13
// ffn_dropout_trainable (_kernel_dropout), K12
// ffn_dropout_res_ln_trainable (_kernel_dropout_res_ln), K2 dense_res_ln
// (_kernel_dense_res_ln) and K11 dense_dropout_res_ln_trainable
// (_kernel_dense_dropout_res_ln).  With a = x @ w1 + b1 in f32 and round()
// to the operands' dtype (in float32 none: h stays f32, unrounded, as the
// TPU kernel's h.astype(x.dtype) is a no-op there):
//   up pass (smx_ffn_up, smx_ffn_dropout_up; _f32 entries):
//     h = round(act(a) * m_a)                                        (n, f)
//   down pass (smx_ffn_down; smx_ffn_down_f32):
//     out = round(h @ w2 + b2)                                       (n, h)
//   down pass (smx_ffn_down_res, smx_ffn_dropout_down_res; _f32 entries):
//     z = (h @ w2 + b2) * m_o + res                              (n, h) f32
//   row pass (smx_res_ln_rows; smx_res_ln_rows_f32):
//     out = round(LayerNorm(z) * g + beta), the mean and then the variance
//     of the centred values of each f32 row                          (n, h)
// K9 is up + down, K13 dropout up + down, K3 up + down_res + rows, K12
// dropout up + dropout down_res + rows; in float32 K2 (smx_dense_res_ln_f32)
// is down_res on x and w, then rows, and K11 (smx_dense_dropout_res_ln_f32)
// the same with the output mask (bfloat16 K2 / K11 are dense_res_ln.cu's
// cluster kernel).  m_a and m_o are the activation mask (stream 0, at (row,
// f column)) and the output mask (stream 1, at (row, h column)) of
// dropout.cuh; a mask whose threshold is 0 draws no bits.  z is kept in
// f32: a rounding there would change K3's function.  h and z live only
// inside the wrapper's call.
//
// bfloat16: x, res: (n, h); w1: (h, f); w2: (f, h), row-major; b1: (f,),
// b2, g, beta: (h,) float32.  Any n >= 1; h and f multiples of 128 (what
// the TPU package's gate admits); operands 16-byte aligned (TMA).
// float32: the same, but the weights come transposed, w1^T (f, h) and
// w2^T (h, f) (for K2 w^T (h, din)): tf32 wgmma reads K-major operands
// only.  The wrapper lays them out per call, about 38 MB of copies at the
// flagship's h = 768, f = 3072 (11 us at 3.35 TB/s beside a K3 call of
// ~2 ms), and pads h, f (din) to multiples of 4 (16-byte TMA strides) with
// zero columns: act(0) = 0 for every activation, so padded columns of h
// and z are zeros, and the row pass takes the true h beside the row
// stride.  Any n >= 1.  act: 0 gelu (erf), 1 gelu_new (tanh), 2 relu,
// 3 silu.  The launchers refuse anything else.
//
// What bounds it on the H100: 4 n h f FLOPs (121 GFLOP at n = 12800,
// h = 768, f = 3072: 0.122 ms at the bf16 peak, 0.732 ms at the 165
// TFLOP/s that three tf32 products make of f32 work) against ~0.1-0.3 GB
// of traffic with h and z, so the tensor cores.  Both products are one
// TMA + wgmma GEMM kernel, ffn_pass_kernel<dtype, epilogue, mask, BN>
// (128 x BN output tiles, two consumer warpgroups of 64 rows).
//   bfloat16 (BN = 128): 64-deep stages, one producer warp; A (x or h) is
//   read K-major, B (w1 or w2) MN-major through the descriptors, never
//   transposed by a copy.  The up pass's main loop is only h / 64 stages
//   long (12 at h = 768), so its activation epilogue is a large share of a
//   block's time: two blocks share an SM, with 3-stage rings, and one
//   block's epilogue overlaps the other's products.  The down pass loops
//   over f / 64 stages (48) and keeps one block per SM with a 4-stage ring
//   (PERF.md has both measured).
//   float32: K8's f32 products (ffn_bwd.cu) on these passes: 32-deep
//   stages of (128, 32) and (BN, 32) f32 boxes, both K-major; once a stage
//   lands the consumers split it in shared memory into tf32 hi / lo halves
//   (hopper.cuh: consume_split, split_tf32), each 8-deep slice is three
//   tf32 wgmma (lo hi, hi lo, hi hi) into a partial that each stage starts
//   afresh, and the partial is added to the f32 accumulator on the CUDA
//   cores.  The split doubles a stage's shared memory: 64 KB at BN = 128
//   (A and B hi and lo, 16 KB each), so three stages and one block per SM
//   (192 KB of the 227); the consumers take 232 registers each from a
//   producer warpgroup held at 40 (acc and the partial are 128 floats).
//   BN = 64 (48 KB a stage, four stages) where its grid still fits the
//   card in one wave, as at the decoder's 1024 rows: K3's down pass and K2
//   at h = 768 make 48 tiles of 128 columns for 132 SMs, 96 of 64, and
//   take 0.1195 / 0.0343 ms at BN = 64 against 0.1759 / 0.0525 at 128 (an
//   H100 80GB HBM3 at 700 W, time_ffn_forward.py --f32-tiles); where the
//   64-column grid needs a second wave (h = 1280 at 1024 rows: 160 tiles)
//   or more, 128 was as fast or faster at every shape measured.
// The epilogues work in the accumulator layout; the row pass is a warp per
// row.  Nothing is atomic: two calls give the same bits.

#include <stdint.h>

#include <type_traits>

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
  kUp = 0,       // round(act(acc + bias) * m)
  kDown = 1,     // round(acc + bias)
  kDownRes = 2,  // (acc + bias) * m + res in f32
};

template <typename T>
constexpr bool kIsF32 = std::is_same_v<T, float>;

constexpr int FBK = 32;  // f32 elements in a 128-byte row: an f32 stage

// The shape of a pass: stages in flight, blocks per SM, threads, the ring's
// bytes.  bfloat16: stages of 2 tiles (32 KB), one producer warp; float32:
// stages of the hi tiles A | B and their lo halves, a producer warpgroup.
template <typename T, int EPI, int BN>
struct PassShape {
  static constexpr int STAGES = EPI == kUp ? 3 : 4;
  static constexpr int BLOCKS_PER_SM = EPI == kUp ? 2 : 1;
  static constexpr int THREADS = CONSUMERS + 32;
  static constexpr int DEPTH = BK;
  static constexpr int RING = STAGES * 2 * BOX;
};
template <int EPI, int BN>
struct PassShape<float, EPI, BN> {
  static constexpr int HI = BOX + BN * FBK * 4;  // A (128 rows), B (BN rows)
  static constexpr int STAGES = BN == TILE ? 3 : 4;
  static constexpr int BLOCKS_PER_SM = 1;
  static constexpr int THREADS = CONSUMERS + WG_THREADS;
  static constexpr int DEPTH = FBK;
  static constexpr int RING = STAGES * 2 * HI;
};

template <typename T, int EPI, int BN>
constexpr size_t pass_smem_bytes() {
  using S = PassShape<T, EPI, BN>;
  return 1024 + (size_t)S::RING + 2 * S::STAGES * sizeof(uint64_t);
}

struct PassArgs {
  CUtensorMap a;       // (n, k): bf16 (128, 64) boxes, f32 (128, 32)
  CUtensorMap b;       // bf16 (k, cols) in (64, 64) boxes, MN-major;
                       // f32 B^T (cols, k) in (BN, 32) boxes, K-major
  const float* bias;   // (cols,)
  const void* res;     // (n, cols) of the dtype: kDownRes
  void* out;           // (n, cols): the dtype, or f32 for kDownRes
  int n, k, cols;
  smx::Dropout drop;
};

// One consumer thread's 2 x BN / 4 elements of the block's tile: rows
// wrow + 8 i, columns n0 + 8 j + 2 (lane % 4) + c.
template <typename T, int EPI, int ACT, bool DROP, int BN>
__device__ __forceinline__ void pass_epilogue(const PassArgs& p,
                                              float (&acc)[BN / 2], int wrow,
                                              int n0, int lane) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    // bfloat16: cols is a multiple of 128, every column of the tile
    // exists; float32 (cols a multiple of 4): a group of 8 columns is
    // skipped by the whole warp (accum_mask), a pair by its lane
    bool col_ok = true;
    if constexpr (kIsF32<T>) {
      if (n0 + 8 * j >= p.cols) continue;
      col_ok = col < p.cols;  // then col + 1 < cols
    }
    float2 bias = make_float2(0.0f, 0.0f);
    if (col_ok) bias = *reinterpret_cast<const float2*>(p.bias + col);
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
      if (row >= p.n || !col_ok) continue;
      const size_t at = (size_t)row * p.cols + col;
      if constexpr (EPI == kDownRes && kIsF32<T>) {
        const float2 r =
            *reinterpret_cast<const float2*>(static_cast<const float*>(p.res) + at);
        *reinterpret_cast<float2*>(static_cast<float*>(p.out) + at) =
            make_float2(v0 + r.x, v1 + r.y);
      } else if constexpr (EPI == kDownRes) {
        const __nv_bfloat162 r =
            *reinterpret_cast<const __nv_bfloat162*>(static_cast<const bf16*>(p.res) + at);
        *reinterpret_cast<float2*>(static_cast<float*>(p.out) + at) =
            make_float2(v0 + __low2float(r), v1 + __high2float(r));
      } else if constexpr (kIsF32<T>) {
        *reinterpret_cast<float2*>(static_cast<float*>(p.out) + at) =
            make_float2(v0, v1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out) + at) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// out tile (m0, n0) of A (n, k) @ B (k, cols), then the epilogue
template <typename T, int EPI, bool DROP, int BN>
__global__ void __launch_bounds__(PassShape<T, EPI, BN>::THREADS,
                                  PassShape<T, EPI, BN>::BLOCKS_PER_SM)
    ffn_pass_kernel(const __grid_constant__ PassArgs p, int act) {
  using S = PassShape<T, EPI, BN>;
  constexpr int ST = S::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring_base = hw::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_base + S::RING);
  uint64_t* empty = full + ST;

  const int ctiles = (p.cols + BN - 1) / BN;
  const int m0 = blockIdx.x / ctiles * TILE, n0 = blockIdx.x % ctiles * BN;
  const int ksteps = (p.k + S::DEPTH - 1) / S::DEPTH;
  const int wg = threadIdx.x / WG_THREADS;
  hw::init_ring<ST>(full, empty);

  float acc[BN / 2];
  if constexpr (!kIsF32<T>) {
    uint8_t* as = ring_base;        // ST x BOX
    uint8_t* bs = as + ST * BOX;    // ST x BOX
    if (wg == 2) {  // producer
      if (threadIdx.x == CONSUMERS) {
        hw::Ring<ST> ring;
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
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    hw::fence_regs(acc);
    hw::consume<ST>(full, empty, ksteps, [&](int s) {
      const uint8_t* a = as + s * BOX + wg * HALF;
      const uint8_t* b = bs + s * BOX;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        hw::wgmma_m64n128k16<0, 1>(acc, hw::desc_sw128(a + kk * 32, 16, SBO),
                                   hw::desc_sw128(b + kk * 2048, MN_LBO, SBO));
      }
    });
    hw::fence_regs(acc);
  } else {
    // stage s: hi tiles A | B, then their lo halves
    if (wg == 2) {  // producer
      hw::setmaxnreg_dec<40>();
      if (threadIdx.x == CONSUMERS) {
        hw::Ring<ST> ring;
        for (int kb = 0; kb < ksteps; ++kb) {
          const int k = kb * FBK, s = ring.s;
          uint8_t* st = ring_base + s * 2 * S::HI;
          ring.acquire(full, empty, S::HI);
          hw::tma_load(st, &p.a, &full[s], k, m0);
          hw::tma_load(st + BOX, &p.b, &full[s], k, n0);
          ring.advance();
        }
      }
      return;
    }
    hw::setmaxnreg_inc<232>();
    float part[BN / 2];  // each stage's products
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.0f;
    hw::consume_split<ST>(
        full, empty, ksteps,
        [&](int s) {
          uint8_t* st = ring_base + s * 2 * S::HI;
          hw::split_tf32(st, st + S::HI, S::HI, threadIdx.x, CONSUMERS);
        },
        [&](int s) {
          const uint8_t* hi = ring_base + s * 2 * S::HI;
          const uint8_t* lo = hi + S::HI;
          const int a = wg * HALF;
#pragma unroll
          for (int kk = 0; kk < FBK / 8; ++kk) {
            const int o = kk * 32;
            hw::wgmma_tf32x3<BN>(part, hi + a + o, lo + a + o, hi + BOX + o,
                                 lo + BOX + o, kk == 0);
          }
        },
        [&]() { hw::promote_acc(acc, part); });
  }
  const int t = threadIdx.x % WG_THREADS, warp = t / 32, lane = t % 32;
  const int wrow = m0 + wg * 64 + warp * 16 + lane / 4;
  if constexpr (EPI == kUp) {
    switch (act) {
      case smx::kGelu:
        pass_epilogue<T, EPI, smx::kGelu, DROP, BN>(p, acc, wrow, n0, lane);
        break;
      case smx::kGeluTanh:
        pass_epilogue<T, EPI, smx::kGeluTanh, DROP, BN>(p, acc, wrow, n0,
                                                        lane);
        break;
      case smx::kRelu:
        pass_epilogue<T, EPI, smx::kRelu, DROP, BN>(p, acc, wrow, n0, lane);
        break;
      default:
        pass_epilogue<T, EPI, smx::kSilu, DROP, BN>(p, acc, wrow, n0, lane);
    }
  } else {
    pass_epilogue<T, EPI, smx::kGelu, DROP, BN>(p, acc, wrow, n0, lane);
  }
}

// ------------------------------------------------------------- row pass
constexpr int LN_WARPS = 8;  // rows per block

// out[row] = round((z[row] - mean) * rsqrt(var + eps) * g + beta), one warp
// per row, the row read once for the mean, again for the variance of the
// centred values (as the TPU kernels' epilogue takes it) and again for the
// output (L1 hits).  Rows lie `ld` apart; h <= ld columns are the row's
// (float32: columns h .. ld - 1 are the wrapper's zero padding, outside the
// variance; bfloat16: ld == h).
template <typename T>
__global__ void __launch_bounds__(LN_WARPS * 32)
    res_ln_rows_kernel(const float* __restrict__ z,
                       const float* __restrict__ g,
                       const float* __restrict__ beta, T* __restrict__ out,
                       int n, int h, int ld, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp
  const int quads = ld / 4;
  const float4* zr = reinterpret_cast<const float4*>(z + row * ld);
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
    float d0 = v.x - mean, d1 = v.y - mean, d2 = v.z - mean, d3 = v.w - mean;
    if constexpr (kIsF32<T>) {
      if (4 * c + 3 >= h) {  // the quad that holds padding
        d0 = 4 * c < h ? d0 : 0.0f;
        d1 = 4 * c + 1 < h ? d1 : 0.0f;
        d2 = 4 * c + 2 < h ? d2 : 0.0f;
        d3 = 0.0f;
      }
    }
    ss += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
  }
  const float inv = rsqrtf(smx::warp_sum(ss) * inv_h + eps);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  const float4* b4 = reinterpret_cast<const float4*>(beta);
  for (int c = lane; c < quads; c += 32) {
    const float4 v = zr[c], gg = g4[c], bb = b4[c];
    const float o0 = (v.x - mean) * inv * gg.x + bb.x;
    const float o1 = (v.y - mean) * inv * gg.y + bb.y;
    const float o2 = (v.z - mean) * inv * gg.z + bb.z;
    const float o3 = (v.w - mean) * inv * gg.w + bb.w;
    if constexpr (kIsF32<T>) {
      reinterpret_cast<float4*>(out + row * ld)[c] =
          make_float4(o0, o1, o2, o3);
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(o0, o1);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(o2, o3);
      reinterpret_cast<uint2*>(out + row * ld)[c] =
          make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                     *reinterpret_cast<const uint32_t*>(&hi));
    }
  }
}

// ------------------------------------------------------------------ host
bool aligned(const void* p, uintptr_t bytes) {
  return p != nullptr && (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

bool bad_shape(int n, int h, int f) {
  return n <= 0 || h <= 0 || f <= 0 || h % TILE != 0 || f % TILE != 0;
}

// float32: widths multiples of 4 (16-byte TMA strides; the wrapper pads)
bool bad_f32_shape(int n, int h, int f) {
  return n <= 0 || h <= 0 || f <= 0 || h % 4 != 0 || f % 4 != 0;
}

int sm_count(int device) {
  static int known[16];
  if (device >= 0 && device < 16 && known[device] > 0) return known[device];
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess) {
    return 0;
  }
  if (device >= 0 && device < 16) known[device] = sms;
  return sms;
}

// A (n, k) @ B through the epilogue EPI, in (128, BN) tiles; b is B (k,
// cols) in bf16, B^T (cols, k) in f32
template <typename T, int EPI, bool DROP, int BN>
int launch_pass(const void* a, const void* b, const float* bias,
                const void* res, void* out, int n, int k, int cols, int act,
                smx::Dropout drop, cudaStream_t stream) {
  PassArgs p;
  if constexpr (kIsF32<T>) {
    if (!hw::make_map_f32(&p.a, a, n, k, k, TILE) ||
        !hw::make_map_f32(&p.b, b, cols, k, k, BN)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    if (!hw::make_map(&p.a, a, n, k, TILE, BK) ||
        !hw::make_map(&p.b, b, k, cols, BK, BK)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  p.bias = bias;
  p.res = res;
  p.out = out;
  p.n = n;
  p.k = k;
  p.cols = cols;
  p.drop = drop;
  const size_t smem = pass_smem_bytes<T, EPI, BN>();
  cudaError_t err = cudaFuncSetAttribute(
      ffn_pass_kernel<T, EPI, DROP, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      (long long)((n + TILE - 1) / TILE) * ((cols + BN - 1) / BN);
  ffn_pass_kernel<T, EPI, DROP, BN>
      <<<(unsigned)blocks, PassShape<T, EPI, BN>::THREADS, smem, stream>>>(
          p, act);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int EPI, bool DROP>
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (kIsF32<T>) {
    // 64-column tiles where their grid still fits the card in one wave
    const long long wide = (long long)((n + TILE - 1) / TILE) *
                           ((cols + TILE - 1) / TILE);
    if (2 * wide <= sm_count(device)) {
      return launch_pass<T, EPI, DROP, 64>(a, b, bias, res, out, n, k, cols,
                                           act, drop, s);
    }
  }
  return launch_pass<T, EPI, DROP, TILE>(a, b, bias, res, out, n, k, cols,
                                         act, drop, s);
}

template <typename T, bool DROP>
int up(const void* x, const void* w1, const float* b1, void* hid, int n,
       int h, int f, int act, smx::Dropout drop, int device, void* stream) {
  if (kIsF32<T> ? bad_f32_shape(n, h, f) : bad_shape(n, h, f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return pass<T, kUp, DROP>(x, w1, b1, nullptr, hid, n, h, f, act, drop,
                            device, stream);
}

template <typename T, int EPI, bool DROP>
int down(const void* hid, const void* w2, const float* b2, const void* res,
         void* out, int n, int h, int f, smx::Dropout drop, int device,
         void* stream) {
  if (kIsF32<T> ? bad_f32_shape(n, h, f) : bad_shape(n, h, f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return pass<T, EPI, DROP>(hid, w2, b2, res, out, n, f, h, 0, drop, device,
                            stream);
}

template <typename T>
int rows(const float* z, const float* g, const float* beta, void* out, int n,
         int h, int ld, float eps, int device, void* stream) {
  if (n <= 0 || h <= 0 || ld % 4 != 0 || h > ld || h <= ld - 4 ||
      !aligned(z, 16) || !aligned(g, 16) || !aligned(beta, 16) ||
      !aligned(out, kIsF32<T> ? 16 : 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  res_ln_rows_kernel<T><<<(n + LN_WARPS - 1) / LN_WARPS, LN_WARPS * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      z, g, beta, static_cast<T*>(out), n, h, ld, eps);
  return static_cast<int>(cudaGetLastError());
}

// K2 / K11 in float32: z = (x @ w + b) * m_o + res (n, ld), then the rows
template <bool DROP>
int dense_f32(const void* x, const void* wt, const float* b, const void* res,
              const float* g, const float* beta, float* z, void* out, int n,
              int din, int h, int ld, float eps, smx::Dropout drop,
              int device, void* stream) {
  if (bad_f32_shape(n, ld, din) || h > ld || h <= ld - 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rc = pass<float, kDownRes, DROP>(x, wt, b, res, z, n, din, ld, 0,
                                             drop, device, stream);
  if (rc != 0) return rc;
  return rows<float>(z, g, beta, out, n, h, ld, eps, device, stream);
}

}  // namespace

// ---------------------------------------------------------- bfloat16 entries
// up pass: hid (n, f) bf16
extern "C" int smx_ffn_up(const void* x, const void* w1, const float* b1,
                          void* hid, int n, int h, int f, int act, int device,
                          void* stream) {
  return up<bf16, false>(x, w1, b1, hid, n, h, f, act, smx::Dropout{}, device,
                         stream);
}

// the up pass with the activation mask: k0, k1 the site's key, threshold
// and scale of stream 0, from the host
extern "C" int smx_ffn_dropout_up(const void* x, const void* w1,
                                  const float* b1, void* hid, int n, int h,
                                  int f, int act, uint32_t k0, uint32_t k1,
                                  uint32_t threshold, float scale, int device,
                                  void* stream) {
  return up<bf16, true>(x, w1, b1, hid, n, h, f, act,
                        smx::make_dropout(k0, k1, smx::kStreamAct, threshold,
                                          scale),
                        device, stream);
}

// down pass: out (n, h) bf16 = round(hid @ w2 + b2)
extern "C" int smx_ffn_down(const void* hid, const void* w2, const float* b2,
                            void* out, int n, int h, int f, int device,
                            void* stream) {
  return down<bf16, kDown, false>(hid, w2, b2, nullptr, out, n, h, f,
                                  smx::Dropout{}, device, stream);
}

// down pass before the LayerNorm: z (n, h) f32 = hid @ w2 + b2 + res
extern "C" int smx_ffn_down_res(const void* hid, const void* w2,
                                const float* b2, const void* res, float* z,
                                int n, int h, int f, int device,
                                void* stream) {
  return down<bf16, kDownRes, false>(hid, w2, b2, res, z, n, h, f,
                                     smx::Dropout{}, device, stream);
}

// the same with the output mask of stream 1: z = (hid @ w2 + b2) * m_o + res
extern "C" int smx_ffn_dropout_down_res(const void* hid, const void* w2,
                                        const float* b2, const void* res,
                                        float* z, int n, int h, int f,
                                        uint32_t k0, uint32_t k1,
                                        uint32_t threshold, float scale,
                                        int device, void* stream) {
  return down<bf16, kDownRes, true>(
      hid, w2, b2, res, z, n, h, f,
      smx::make_dropout(k0, k1, smx::kStreamOut, threshold, scale), device,
      stream);
}

// row pass: out (n, h) bf16 = round(LayerNorm(z) * g + beta)
extern "C" int smx_res_ln_rows(const float* z, const float* g,
                               const float* beta, void* out, int n, int h,
                               float eps, int device, void* stream) {
  return rows<bf16>(z, g, beta, out, n, h, h, eps, device, stream);
}

// ----------------------------------------------------------- float32 entries
// The same passes on f32 operands, the weights transposed: w1t = w1^T
// (f, h), w2t = w2^T (h, f); h and f multiples of 4.
extern "C" int smx_ffn_up_f32(const void* x, const void* w1t, const float* b1,
                              void* hid, int n, int h, int f, int act,
                              int device, void* stream) {
  return up<float, false>(x, w1t, b1, hid, n, h, f, act, smx::Dropout{},
                          device, stream);
}

extern "C" int smx_ffn_dropout_up_f32(const void* x, const void* w1t,
                                      const float* b1, void* hid, int n,
                                      int h, int f, int act, uint32_t k0,
                                      uint32_t k1, uint32_t threshold,
                                      float scale, int device, void* stream) {
  return up<float, true>(x, w1t, b1, hid, n, h, f, act,
                         smx::make_dropout(k0, k1, smx::kStreamAct, threshold,
                                           scale),
                         device, stream);
}

extern "C" int smx_ffn_down_f32(const void* hid, const void* w2t,
                                const float* b2, void* out, int n, int h,
                                int f, int device, void* stream) {
  return down<float, kDown, false>(hid, w2t, b2, nullptr, out, n, h, f,
                                   smx::Dropout{}, device, stream);
}

extern "C" int smx_ffn_down_res_f32(const void* hid, const void* w2t,
                                    const float* b2, const void* res,
                                    float* z, int n, int h, int f, int device,
                                    void* stream) {
  return down<float, kDownRes, false>(hid, w2t, b2, res, z, n, h, f,
                                      smx::Dropout{}, device, stream);
}

extern "C" int smx_ffn_dropout_down_res_f32(const void* hid, const void* w2t,
                                            const float* b2, const void* res,
                                            float* z, int n, int h, int f,
                                            uint32_t k0, uint32_t k1,
                                            uint32_t threshold, float scale,
                                            int device, void* stream) {
  return down<float, kDownRes, true>(
      hid, w2t, b2, res, z, n, h, f,
      smx::make_dropout(k0, k1, smx::kStreamOut, threshold, scale), device,
      stream);
}

// row pass: out (n, ld) f32 = LayerNorm(z[:, :h]) * g + beta, z's rows ld
// apart (ld a multiple of 4, h > ld - 4; padded columns of z, g and beta
// zeros, which give zeros)
extern "C" int smx_res_ln_rows_f32(const float* z, const float* g,
                                   const float* beta, float* out, int n,
                                   int h, int ld, float eps, int device,
                                   void* stream) {
  return rows<float>(z, g, beta, out, n, h, ld, eps, device, stream);
}

// K2: out (n, ld) = LayerNorm(res + x @ w + b) * g + beta over the first h
// columns; x (n, din), wt = w^T (ld, din), res (n, ld), b, g, beta (ld,),
// z an (n, ld) f32 workspace; din and ld multiples of 4, h > ld - 4
extern "C" int smx_dense_res_ln_f32(const void* x, const void* wt,
                                    const float* b, const void* res,
                                    const float* g, const float* beta,
                                    float* z, void* out, int n, int din,
                                    int h, int ld, float eps, int device,
                                    void* stream) {
  return dense_f32<false>(x, wt, b, res, g, beta, z, out, n, din, h, ld, eps,
                          smx::Dropout{}, device, stream);
}

// K11: the output mask of stream 1 on x @ w + b before the residual
extern "C" int smx_dense_dropout_res_ln_f32(
    const void* x, const void* wt, const float* b, const void* res,
    const float* g, const float* beta, float* z, void* out, int n, int din,
    int h, int ld, float eps, uint32_t k0, uint32_t k1, uint32_t threshold,
    float scale, int device, void* stream) {
  return dense_f32<true>(
      x, wt, b, res, g, beta, z, out, n, din, h, ld, eps,
      smx::make_dropout(k0, k1, smx::kStreamOut, threshold, scale), device,
      stream);
}
