// K8: ffn_bwd — backward of y = act(x @ w1 + b1) @ w2 + b2 given g = dy, with
// the (n, f) intermediate and its gradient recomputed on chip, never stored.
//
// Replaces the two TPU kernels of speechmix_tpu/ops/pallas/ffn_kernel.py:
// ffn_fused_bwd: _kernel_bwd_dx (entry smx_ffn_bwd_dx) and _kernel_bwd_dw
// (entry smx_ffn_bwd_dw).  With a = x @ w1 + b1 (f32), h = round(act(a)),
// dh = g @ w2^T (f32) and da = round(dh * act'(a)), round() to x's dtype:
//   dx  = da @ w1^T          (n, h), x's dtype          smx_ffn_bwd_dx
//   dw1 = x^T @ da           (h, f) float32             smx_ffn_bwd_dw
//   dw2 = h^T @ g            (f, h) float32
//   db1 = sum_rows da        (f,)   float32
// db2 = sum_rows g stays with the caller, as in the TPU package.
//
// The dropout entries smx_ffn_dropout_bwd_dx and smx_ffn_dropout_bwd_dw are
// the backward of y = drop_a(act(x @ w1 + b1)) @ w2 + b2, the FFN of K12 and
// K13 (ffn_res_ln.cu): they regenerate the activation mask m (dropout.cuh,
// stream 0, at (row, f column)) in the kernel and take h = round(act(a) * m)
// and da = round(dh * act'(a) * m), as the TPU package's _ffn_bwd_hand does
// with the regenerated mask (ffn_kernel.py, called from _fdrl_bwd and
// _fdt_bwd, which run it in XLA: the TPU package has no kernel there).  No
// (n, f) mask or intermediate is kept between forward and backward.
//
// x, g, dx: (n, h); w1: (h, f); w2: (f, h), row-major, in float32 or bfloat16;
// b1: (f,) float32.  float32: h <= 1024, f % 16 == 0.  bfloat16: h in
// {768, 1024}, f % 64 == 0, x, g, w1, w2 32-byte aligned.  act: 0 gelu (erf),
// 1 gelu_new (tanh), 2 relu, 3 silu.  The launchers refuse anything else.
//
// smx_ffn_bwd_dx: a block owns a row tile and all h output columns and loops
// over chunks of f: it recomputes the chunk's a and dh, forms da in shared
// memory and accumulates da @ w1[:, chunk]^T.
//
// smx_ffn_bwd_dw: a block owns a chunk of f columns and one of `splits` row
// ranges; per row tile it recomputes a, h, dh and da for its chunk and
// accumulates x^T da, h^T g and the column sums of da in registers.  The TPU
// grid over f chunks alone would leave most of the 132 SMs idle, so the rows
// are split over blocks too: with splits > 1 each block writes its partial
// sums to a float32 workspace (splits, 2 * h * f + f) and a second kernel
// adds the partials in split order.  No atomics: the result does not depend
// on scheduling.
//
// What bounds it on the H100: 6 * n * h * f (dx) and 8 * n * h * f (dw) FLOPs
// against a few tens of MB, so the tensor cores are the limit.  The bfloat16
// kernels use them through WMMA but read every weight tile from L2 without
// staging or pipelining, and the dw kernel re-reads its x and g rows once per
// f chunk, which keeps both well above that bound (PERF.md).  float32 takes
// f32-FMA kernels, bound by the CUDA cores.

#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int MAXC = 4;  // h <= MAXC * NT

// ---------------------------------------------------------------- float32 dx
constexpr int BM = 16;
constexpr int FC = NT;  // f columns per chunk: one per thread

template <bool DROP>
__global__ void __launch_bounds__(NT)
    ffn_bwd_dx_kernel(const float* __restrict__ x, const float* __restrict__ g,
                      const float* __restrict__ w1, const float* __restrict__ b1,
                      const float* __restrict__ w2, float* __restrict__ dx, int n,
                      int h, int f, int act, smx::Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;            // (h, BM): xs[k * BM + r]
  float* gs = xs + h * BM;     // (h, BM)
  float* das = gs + h * BM;    // (FC, BM): das[c * BM + r]
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * BM;

  for (int i = tid; i < h * BM; i += NT) {
    const int r = i / h, k = i % h;
    const int row = r0 + r;
    xs[k * BM + r] = row < n ? x[(long long)row * h + k] : 0.0f;
    gs[k * BM + r] = row < n ? g[(long long)row * h + k] : 0.0f;
  }
  float acc[BM][MAXC];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int j = 0; j < MAXC; ++j) acc[r][j] = 0.0f;
  __syncthreads();

  for (int c0 = 0; c0 < f; c0 += FC) {
    const int col = c0 + tid;
    float av[BM], dv[BM];
#pragma unroll
    for (int r = 0; r < BM; ++r) av[r] = dv[r] = 0.0f;
    if (col < f) {
      const float* w2r = w2 + (long long)col * h;
      for (int k = 0; k < h; ++k) {
        const float wv = w1[(long long)k * f + col];
        const float uv = w2r[k];
        const float4* xr = reinterpret_cast<const float4*>(xs + k * BM);
        const float4* gr = reinterpret_cast<const float4*>(gs + k * BM);
#pragma unroll
        for (int q = 0; q < BM / 4; ++q) {
          const float4 xv = xr[q], gv = gr[q];
          av[4 * q + 0] += xv.x * wv;
          av[4 * q + 1] += xv.y * wv;
          av[4 * q + 2] += xv.z * wv;
          av[4 * q + 3] += xv.w * wv;
          dv[4 * q + 0] += gv.x * uv;
          dv[4 * q + 1] += gv.y * uv;
          dv[4 * q + 2] += gv.z * uv;
          dv[4 * q + 3] += gv.w * uv;
        }
      }
      const float bias = b1[col];
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        dv[r] *= smx::dactivate(act, av[r] + bias);
        if constexpr (DROP) dv[r] *= drop.at(r0 + r, col);
      }
    }
    float4* dw = reinterpret_cast<float4*>(das + tid * BM);
#pragma unroll
    for (int q = 0; q < BM / 4; ++q) {
      dw[q] = make_float4(dv[4 * q], dv[4 * q + 1], dv[4 * q + 2], dv[4 * q + 3]);
    }
    __syncthreads();

    const int cend = min(FC, f - c0);
    for (int cc = 0; cc < cend; ++cc) {
      float wv[MAXC];
#pragma unroll
      for (int j = 0; j < MAXC; ++j) {
        const int c = tid + j * NT;
        wv[j] = c < h ? w1[(long long)c * f + c0 + cc] : 0.0f;
      }
      const float4* dr = reinterpret_cast<const float4*>(das + cc * BM);
#pragma unroll
      for (int q = 0; q < BM / 4; ++q) {
        const float4 d4 = dr[q];
#pragma unroll
        for (int j = 0; j < MAXC; ++j) {
          acc[4 * q + 0][j] += d4.x * wv[j];
          acc[4 * q + 1][j] += d4.y * wv[j];
          acc[4 * q + 2][j] += d4.z * wv[j];
          acc[4 * q + 3][j] += d4.w * wv[j];
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    const int row = r0 + r;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {
      const int c = tid + j * NT;
      if (c < h) dx[(long long)row * h + c] = acc[r][j];
    }
  }
}

// ---------------------------------------------------------------- float32 dw
constexpr int WFC = 16;  // f columns per block

template <bool DROP>
__global__ void __launch_bounds__(NT)
    ffn_bwd_dw_kernel(const float* __restrict__ x, const float* __restrict__ g,
                      const float* __restrict__ w1, const float* __restrict__ b1,
                      const float* __restrict__ w2, float* __restrict__ out,
                      int n, int h, int f, int act, int rows_per_split,
                      smx::Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;              // (BM, h)
  float* gs = xs + BM * h;       // (BM, h)
  float* hs = gs + BM * h;       // (BM, WFC)
  float* das = hs + BM * WFC;    // (BM, WFC)
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * WFC;
  const int row_begin = blockIdx.y * rows_per_split;
  const int row_end = min(n, row_begin + rows_per_split);
  const long long part = 2LL * h * f + f;
  float* dw1 = out + blockIdx.y * part;
  float* dw2 = dw1 + (long long)h * f;
  float* db1 = dw2 + (long long)h * f;

  float a1[MAXC][WFC], a2[WFC][MAXC], bsum = 0.0f;
#pragma unroll
  for (int j = 0; j < MAXC; ++j)
#pragma unroll
    for (int c = 0; c < WFC; ++c) a1[j][c] = a2[c][j] = 0.0f;
  const int pr = tid / WFC, pc = tid % WFC;  // this thread's (row, column)
  const float bias = b1[c0 + pc];
  const float* w2r = w2 + (long long)(c0 + pc) * h;

  for (int r0 = row_begin; r0 < row_end; r0 += BM) {
    __syncthreads();  // the last tile's readers are done
    for (int i = tid; i < BM * h; i += NT) {
      const int row = r0 + i / h;
      xs[i] = row < row_end ? x[(long long)row * h + i % h] : 0.0f;
      gs[i] = row < row_end ? g[(long long)row * h + i % h] : 0.0f;
    }
    __syncthreads();
    float a = 0.0f, dh = 0.0f;
    for (int k = 0; k < h; ++k) {
      a += xs[pr * h + k] * w1[(long long)k * f + c0 + pc];
      dh += gs[pr * h + k] * w2r[k];
    }
    a += bias;
    const float m = DROP ? drop.at(r0 + pr, c0 + pc) : 1.0f;
    hs[pr * WFC + pc] = smx::activate(act, a) * m;
    das[pr * WFC + pc] = dh * smx::dactivate(act, a) * m;
    __syncthreads();
    if (tid < WFC) {
#pragma unroll
      for (int r = 0; r < BM; ++r) bsum += das[r * WFC + tid];
    }
#pragma unroll 2
    for (int r = 0; r < BM; ++r) {
      float xv[MAXC], gv[MAXC];
#pragma unroll
      for (int j = 0; j < MAXC; ++j) {
        const int c = tid + j * NT;
        xv[j] = c < h ? xs[r * h + c] : 0.0f;
        gv[j] = c < h ? gs[r * h + c] : 0.0f;
      }
#pragma unroll
      for (int c = 0; c < WFC; ++c) {
        const float dav = das[r * WFC + c], hv = hs[r * WFC + c];
#pragma unroll
        for (int j = 0; j < MAXC; ++j) {
          a1[j][c] += xv[j] * dav;
          a2[c][j] += hv * gv[j];
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < MAXC; ++j) {
    const int hc = tid + j * NT;
    if (hc >= h) continue;
#pragma unroll
    for (int c = 0; c < WFC; ++c) {
      dw1[(long long)hc * f + c0 + c] = a1[j][c];
      dw2[(long long)(c0 + c) * h + hc] = a2[c][j];
    }
  }
  if (tid < WFC) db1[c0 + tid] = bsum;
}

// out[i] = sum over splits, in split order, of ws[s * size + i]
__global__ void __launch_bounds__(NT)
    ffn_bwd_reduce_kernel(const float* __restrict__ ws, float* __restrict__ out,
                          long long size, int splits) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  if (i >= size) return;
  float s = ws[i];
  for (int p = 1; p < splits; ++p) s += ws[p * size + i];
  out[i] = s;
}

// ------------------------------------------------------------------ bfloat16
namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int TC_BM = 32;           // rows per tile: two 16-row tiles
constexpr int DX_FC = 64;           // dx: f columns per chunk
constexpr int DX_LDF = DX_FC + 4;   // f32 chunk row
constexpr int DX_LDB = DX_FC + 8;   // bf16 chunk row

template <int NJ>
constexpr size_t dx_smem_bytes() {
  return (size_t)2 * TC_BM * (128 * NJ + 8) * sizeof(bf16) +
         (size_t)2 * TC_BM * DX_LDF * sizeof(float) +
         (size_t)TC_BM * DX_LDB * sizeof(bf16);
}

// h = 128 * NJ; 8 warps; warp w owns output column tiles w + 8 * j, j < NJ
template <int NJ, bool DROP>
__global__ void __launch_bounds__(NT)
    ffn_bwd_dx_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                         const bf16* __restrict__ w1, const float* __restrict__ b1,
                         const bf16* __restrict__ w2, bf16* __restrict__ dx, int n,
                         int f, int act, smx::Dropout drop) {
  constexpr int H = 128 * NJ;
  constexpr int LDX = H + 8;
  constexpr int LDY = H + 4;  // f32 staged output row, over xs and gs
  static_assert((size_t)TC_BM * LDY * sizeof(float) <=
                (size_t)2 * TC_BM * LDX * sizeof(bf16), "staging fits");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);            // (TC_BM, LDX)
  bf16* gs = xs + TC_BM * LDX;                             // (TC_BM, LDX)
  float* af = reinterpret_cast<float*>(gs + TC_BM * LDX);  // (TC_BM, DX_LDF)
  float* dhf = af + TC_BM * DX_LDF;                        // (TC_BM, DX_LDF)
  bf16* dab = reinterpret_cast<bf16*>(dhf + TC_BM * DX_LDF);  // (TC_BM, DX_LDB)
  float* ys = reinterpret_cast<float*>(smem_raw);          // after the loop
  const int tid = threadIdx.x, warp = tid >> 5;
  const int r0 = blockIdx.x * TC_BM;

  for (int i = tid; i < TC_BM * (H / 8); i += NT) {
    const int r = i / (H / 8), c = (i % (H / 8)) * 8;
    const int row = r0 + r;
    uint4 xv = make_uint4(0u, 0u, 0u, 0u), gv = xv;
    if (row < n) {
      xv = *reinterpret_cast<const uint4*>(x + (long long)row * H + c);
      gv = *reinterpret_cast<const uint4*>(g + (long long)row * H + c);
    }
    *reinterpret_cast<uint4*>(xs + r * LDX + c) = xv;
    *reinterpret_cast<uint4*>(gs + r * LDX + c) = gv;
  }
  wm::fragment<wm::accumulator, 16, 16, 16, float> acc[2][NJ];
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int j = 0; j < NJ; ++j) wm::fill_fragment(acc[rt][j], 0.0f);
  __syncthreads();

  const int rt1 = warp >> 2, ct1 = warp & 3;  // this warp's tile of a chunk
  for (int c0 = 0; c0 < f; c0 += DX_FC) {
    wm::fragment<wm::accumulator, 16, 16, 16, float> aacc, dacc;
    wm::fill_fragment(aacc, 0.0f);
    wm::fill_fragment(dacc, 0.0f);
    const bf16* w2t = w2 + (long long)(c0 + ct1 * 16) * H;
    for (int k = 0; k < H; k += 16) {
      wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a;
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> b;
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> bt;
      wm::load_matrix_sync(a, xs + rt1 * 16 * LDX + k, LDX);
      wm::load_matrix_sync(b, w1 + (long long)k * f + c0 + ct1 * 16, f);
      wm::mma_sync(aacc, a, b, aacc);
      wm::load_matrix_sync(a, gs + rt1 * 16 * LDX + k, LDX);
      wm::load_matrix_sync(bt, w2t + k, H);  // (k, n) = w2[c0 + n][k]
      wm::mma_sync(dacc, a, bt, dacc);
    }
    wm::store_matrix_sync(af + rt1 * 16 * DX_LDF + ct1 * 16, aacc, DX_LDF,
                          wm::mem_row_major);
    wm::store_matrix_sync(dhf + rt1 * 16 * DX_LDF + ct1 * 16, dacc, DX_LDF,
                          wm::mem_row_major);
    __syncthreads();  // also: every warp is done reading dab of the last chunk
    if constexpr (DROP) {
      // one Philox call per four f columns of a row
      for (int i = tid; i < TC_BM * (DX_FC / 4); i += NT) {
        const int r = i / (DX_FC / 4), c = (i % (DX_FC / 4)) * 4;
        const uint4 bits = drop.bits4(r0 + r, (c0 + c) / 4);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dab[r * DX_LDB + c + j] = __float2bfloat16(
              dhf[r * DX_LDF + c + j] *
              smx::dactivate(act, af[r * DX_LDF + c + j] + b1[c0 + c + j]) *
              drop.keep(smx::word(bits, j)));
        }
      }
    } else {
      for (int i = tid; i < TC_BM * DX_FC; i += NT) {
        const int r = i / DX_FC, c = i % DX_FC;
        dab[r * DX_LDB + c] = __float2bfloat16(
            dhf[r * DX_LDF + c] *
            smx::dactivate(act, af[r * DX_LDF + c] + b1[c0 + c]));
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < DX_FC; ks += 16) {
      wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a0, a1;
      wm::load_matrix_sync(a0, dab + ks, DX_LDB);
      wm::load_matrix_sync(a1, dab + 16 * DX_LDB + ks, DX_LDB);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        // (k, n) = w1[(warp + 8 j) * 16 + n][c0 + ks + k]
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> b;
        wm::load_matrix_sync(
            b, w1 + (long long)(warp + 8 * j) * 16 * f + c0 + ks, f);
        wm::mma_sync(acc[0][j], a0, b, acc[0][j]);
        wm::mma_sync(acc[1][j], a1, b, acc[1][j]);
      }
    }
  }
  __syncthreads();  // every warp is done with xs and gs
#pragma unroll
  for (int rt = 0; rt < 2; ++rt)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      wm::store_matrix_sync(ys + rt * 16 * LDY + (warp + 8 * j) * 16, acc[rt][j],
                            LDY, wm::mem_row_major);
  __syncthreads();
  for (int i = tid; i < TC_BM * H; i += NT) {
    const int r = i / H, c = i % H;
    if (r0 + r < n) {
      dx[(long long)(r0 + r) * H + c] = __float2bfloat16(ys[r * LDY + c]);
    }
  }
}

constexpr int DW_NT = 512;          // 16 warps
constexpr int DW_FC = 32;           // dw: f columns per block
constexpr int DW_LDF = DW_FC + 4;
constexpr int DW_LDB = DW_FC + 8;

template <int NJ>
constexpr size_t dw_smem_bytes() {
  return (size_t)2 * TC_BM * (128 * NJ + 8) * sizeof(bf16) +
         (size_t)4 * TC_BM * DW_LDF * sizeof(float) +
         (size_t)2 * TC_BM * DW_LDB * sizeof(bf16);
}

// h = 128 * NJ.  Recompute: warp w computes one 16 x 16 tile of a (w % 8 < 4)
// or dh over half of the h contraction (w / 8).  Weight gradients: warps 0-7
// hold x^T da (row tiles w + 8 j of h, both column tiles), warps 8-15 hold
// h^T g (both row tiles, column tiles w - 8 + 8 j of h).
// One block per SM, stated: with the thread count alone ptxas keeps this
// kernel to 64 registers and spills its accumulators (2 to 4 KB a thread).
template <int NJ, bool DROP>
__global__ void __launch_bounds__(DW_NT, 1)
    ffn_bwd_dw_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                         const bf16* __restrict__ w1, const float* __restrict__ b1,
                         const bf16* __restrict__ w2, float* __restrict__ out,
                         int n, int f, int act, int rows_per_split,
                         smx::Dropout drop) {
  constexpr int H = 128 * NJ;
  constexpr int LDX = H + 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);            // (TC_BM, LDX)
  bf16* gs = xs + TC_BM * LDX;
  float* af = reinterpret_cast<float*>(gs + TC_BM * LDX);  // 2 x (TC_BM, DW_LDF)
  float* dhf = af + 2 * TC_BM * DW_LDF;                    // 2 x (TC_BM, DW_LDF)
  bf16* hb = reinterpret_cast<bf16*>(dhf + 2 * TC_BM * DW_LDF);  // (TC_BM, DW_LDB)
  bf16* dab = hb + TC_BM * DW_LDB;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int c0 = blockIdx.x * DW_FC;
  const int row_begin = blockIdx.y * rows_per_split;
  const int row_end = min(n, row_begin + rows_per_split);
  const long long part = 2LL * H * f + f;
  float* dw1 = out + blockIdx.y * part;
  float* dw2 = dw1 + (long long)H * f;
  float* db1 = dw2 + (long long)H * f;

  wm::fragment<wm::accumulator, 16, 16, 16, float> acc[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    wm::fill_fragment(acc[j][0], 0.0f);
    wm::fill_fragment(acc[j][1], 0.0f);
  }
  float bsum = 0.0f;
  const int khalf = warp >> 3, job = warp & 7;
  const bool is_dh = job >= 4;
  const int rt1 = (job >> 1) & 1, ct1 = job & 1;
  const int kbeg = khalf * (H / 2);
  float* stage = (is_dh ? dhf : af) + khalf * TC_BM * DW_LDF +
                 rt1 * 16 * DW_LDF + ct1 * 16;

  for (int r0 = row_begin; r0 < row_end; r0 += TC_BM) {
    __syncthreads();  // the last tile's readers of xs, gs, hb, dab are done
    for (int i = tid; i < TC_BM * (H / 8); i += DW_NT) {
      const int r = i / (H / 8), c = (i % (H / 8)) * 8;
      const int row = r0 + r;
      uint4 xv = make_uint4(0u, 0u, 0u, 0u), gv = xv;
      if (row < row_end) {
        xv = *reinterpret_cast<const uint4*>(x + (long long)row * H + c);
        gv = *reinterpret_cast<const uint4*>(g + (long long)row * H + c);
      }
      *reinterpret_cast<uint4*>(xs + r * LDX + c) = xv;
      *reinterpret_cast<uint4*>(gs + r * LDX + c) = gv;
    }
    __syncthreads();
    {
      wm::fragment<wm::accumulator, 16, 16, 16, float> part_acc;
      wm::fill_fragment(part_acc, 0.0f);
      wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a;
      if (is_dh) {
        const bf16* w2t = w2 + (long long)(c0 + ct1 * 16) * H;
        for (int k = kbeg; k < kbeg + H / 2; k += 16) {
          wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> bt;
          wm::load_matrix_sync(a, gs + rt1 * 16 * LDX + k, LDX);
          wm::load_matrix_sync(bt, w2t + k, H);
          wm::mma_sync(part_acc, a, bt, part_acc);
        }
      } else {
        for (int k = kbeg; k < kbeg + H / 2; k += 16) {
          wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> b;
          wm::load_matrix_sync(a, xs + rt1 * 16 * LDX + k, LDX);
          wm::load_matrix_sync(b, w1 + (long long)k * f + c0 + ct1 * 16, f);
          wm::mma_sync(part_acc, a, b, part_acc);
        }
      }
      wm::store_matrix_sync(stage, part_acc, DW_LDF, wm::mem_row_major);
    }
    __syncthreads();
    if constexpr (DROP) {
      // one Philox call per four f columns of a row
      for (int i = tid; i < TC_BM * (DW_FC / 4); i += DW_NT) {
        const int r = i / (DW_FC / 4), c = (i % (DW_FC / 4)) * 4;
        const uint4 bits = drop.bits4(r0 + r, (c0 + c) / 4);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int at = r * DW_LDF + c + j;
          const float a = af[at] + af[TC_BM * DW_LDF + at] + b1[c0 + c + j];
          const float dh = dhf[at] + dhf[TC_BM * DW_LDF + at];
          const float m = drop.keep(smx::word(bits, j));
          hb[r * DW_LDB + c + j] = __float2bfloat16(smx::activate(act, a) * m);
          dab[r * DW_LDB + c + j] =
              __float2bfloat16(dh * smx::dactivate(act, a) * m);
        }
      }
    } else {
      for (int i = tid; i < TC_BM * DW_FC; i += DW_NT) {
        const int r = i / DW_FC, c = i % DW_FC;
        const int at = r * DW_LDF + c;
        const float a = af[at] + af[TC_BM * DW_LDF + at] + b1[c0 + c];
        const float dh = dhf[at] + dhf[TC_BM * DW_LDF + at];
        hb[r * DW_LDB + c] = __float2bfloat16(smx::activate(act, a));
        dab[r * DW_LDB + c] = __float2bfloat16(dh * smx::dactivate(act, a));
      }
    }
    __syncthreads();
    if (tid < DW_FC) {
#pragma unroll
      for (int r = 0; r < TC_BM; ++r) {
        bsum += __bfloat162float(dab[r * DW_LDB + tid]);
      }
    }
    if (warp < 8) {
      // dw1[h rows, chunk] += x^T da: (m, k) = xs[k][m]
#pragma unroll
      for (int ks = 0; ks < TC_BM; ks += 16) {
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> b0, b1f;
        wm::load_matrix_sync(b0, dab + ks * DW_LDB, DW_LDB);
        wm::load_matrix_sync(b1f, dab + ks * DW_LDB + 16, DW_LDB);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::col_major> a;
          wm::load_matrix_sync(a, xs + ks * LDX + (warp + 8 * j) * 16, LDX);
          wm::mma_sync(acc[j][0], a, b0, acc[j][0]);
          wm::mma_sync(acc[j][1], a, b1f, acc[j][1]);
        }
      }
    } else {
      // dw2[chunk, h columns] += h^T g: (m, k) = hb[k][m]
#pragma unroll
      for (int ks = 0; ks < TC_BM; ks += 16) {
        wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::col_major> a0, a1;
        wm::load_matrix_sync(a0, hb + ks * DW_LDB, DW_LDB);
        wm::load_matrix_sync(a1, hb + ks * DW_LDB + 16, DW_LDB);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> b;
          wm::load_matrix_sync(b, gs + ks * LDX + (warp - 8 + 8 * j) * 16, LDX);
          wm::mma_sync(acc[j][0], a0, b, acc[j][0]);
          wm::mma_sync(acc[j][1], a1, b, acc[j][1]);
        }
      }
    }
  }
  if (warp < 8) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float* o = dw1 + (long long)(warp + 8 * j) * 16 * f + c0;
      wm::store_matrix_sync(o, acc[j][0], f, wm::mem_row_major);
      wm::store_matrix_sync(o + 16, acc[j][1], f, wm::mem_row_major);
    }
  } else {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float* o = dw2 + (long long)c0 * H + (warp - 8 + 8 * j) * 16;
      wm::store_matrix_sync(o, acc[j][0], H, wm::mem_row_major);
      wm::store_matrix_sync(o + 16LL * H, acc[j][1], H, wm::mem_row_major);
    }
  }
  if (tid < DW_FC) db1[c0 + tid] = bsum;
}

template <int NJ, bool DROP>
int launch_dx_tc(const void* x, const void* g, const void* w1, const float* b1,
                 const void* w2, void* dx, int n, int f, int act,
                 smx::Dropout drop, cudaStream_t stream) {
  const size_t smem = dx_smem_bytes<NJ>();
  cudaError_t err = cudaFuncSetAttribute(
      ffn_bwd_dx_tc_kernel<NJ, DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ffn_bwd_dx_tc_kernel<NJ, DROP><<<(n + TC_BM - 1) / TC_BM, NT, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g),
      static_cast<const bf16*>(w1), b1, static_cast<const bf16*>(w2),
      static_cast<bf16*>(dx), n, f, act, drop);
  return static_cast<int>(cudaGetLastError());
}

template <int NJ, bool DROP>
int launch_dw_tc(const void* x, const void* g, const void* w1, const float* b1,
                 const void* w2, float* out, int n, int f, int act, int splits,
                 int rows_per_split, smx::Dropout drop, cudaStream_t stream) {
  const size_t smem = dw_smem_bytes<NJ>();
  cudaError_t err = cudaFuncSetAttribute(
      ffn_bwd_dw_tc_kernel<NJ, DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ffn_bwd_dw_tc_kernel<NJ, DROP>
      <<<dim3(f / DW_FC, splits), DW_NT, smem, stream>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(g),
          static_cast<const bf16*>(w1), b1, static_cast<const bf16*>(w2), out,
          n, f, act, rows_per_split, drop);
  return static_cast<int>(cudaGetLastError());
}

bool aligned32(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 31u) == 0;
}

bool bad_shape(int n, int h, int f, int act) {
  return h > MAXC * NT || h <= 0 || f <= 0 || n <= 0 || act < 0 || act > 3;
}

template <bool DROP>
int bwd_dx(const void* x, const void* g, const void* w1, const float* b1,
           const void* w2, void* dx, int n, int h, int f, int act,
           smx::Dropout drop, int dtype, int device, void* stream) {
  if (bad_shape(n, h, f, act)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == smx::kBF16) {
    if (f % DX_FC != 0 || !aligned32(x) || !aligned32(g) || !aligned32(w1) ||
        !aligned32(w2)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (h == 768) {
      return launch_dx_tc<6, DROP>(x, g, w1, b1, w2, dx, n, f, act, drop, s);
    }
    if (h == 1024) {
      return launch_dx_tc<8, DROP>(x, g, w1, b1, w2, dx, n, f, act, drop, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = (size_t)(2 * h + FC) * BM * sizeof(float);
  err = cudaFuncSetAttribute(ffn_bwd_dx_kernel<DROP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ffn_bwd_dx_kernel<DROP><<<(n + BM - 1) / BM, NT, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<const float*>(w1), b1, static_cast<const float*>(w2),
      static_cast<float*>(dx), n, h, f, act, drop);
  return static_cast<int>(cudaGetLastError());
}

// out: (2 * h * f + f) float32 = dw1 | dw2 | db1.  splits row ranges of
// rows_per_split rows (a multiple of 32) cover n; with splits > 1, ws holds
// splits such records.
template <bool DROP>
int bwd_dw(const void* x, const void* g, const void* w1, const float* b1,
           const void* w2, float* out, float* ws, int n, int h, int f, int act,
           int splits, int rows_per_split, smx::Dropout drop, int dtype,
           int device, void* stream) {
  if (bad_shape(n, h, f, act) || splits < 1 || splits > 65535 ||
      rows_per_split <= 0 || rows_per_split % TC_BM != 0 ||
      (long long)splits * rows_per_split < n ||
      (long long)(splits - 1) * rows_per_split >= n ||
      (splits > 1 && ws == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* target = splits > 1 ? ws : out;
  int rc;
  if (dtype == smx::kBF16) {
    if (f % DX_FC != 0 || !aligned32(x) || !aligned32(g) || !aligned32(w1) ||
        !aligned32(w2) || !aligned32(target)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (h == 768) {
      rc = launch_dw_tc<6, DROP>(x, g, w1, b1, w2, target, n, f, act, splits,
                                 rows_per_split, drop, s);
    } else if (h == 1024) {
      rc = launch_dw_tc<8, DROP>(x, g, w1, b1, w2, target, n, f, act, splits,
                                 rows_per_split, drop, s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    if (f % WFC != 0) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = (size_t)(2 * h + 2 * WFC) * BM * sizeof(float);
    err = cudaFuncSetAttribute(ffn_bwd_dw_kernel<DROP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    ffn_bwd_dw_kernel<DROP><<<dim3(f / WFC, splits), NT, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<const float*>(w1), b1, static_cast<const float*>(w2),
        target, n, h, f, act, rows_per_split, drop);
    rc = static_cast<int>(cudaGetLastError());
  }
  if (rc != 0 || splits == 1) return rc;
  const long long size = 2LL * h * f + f;
  ffn_bwd_reduce_kernel<<<(unsigned)((size + NT - 1) / NT), NT, 0, s>>>(
      ws, out, size, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int smx_ffn_bwd_dx(const void* x, const void* g, const void* w1,
                              const float* b1, const void* w2, void* dx, int n,
                              int h, int f, int act, int dtype, int device,
                              void* stream) {
  return bwd_dx<false>(x, g, w1, b1, w2, dx, n, h, f, act, smx::Dropout{},
                       dtype, device, stream);
}

extern "C" int smx_ffn_bwd_dw(const void* x, const void* g, const void* w1,
                              const float* b1, const void* w2, float* out,
                              float* ws, int n, int h, int f, int act,
                              int splits, int rows_per_split, int dtype,
                              int device, void* stream) {
  return bwd_dw<false>(x, g, w1, b1, w2, out, ws, n, h, f, act, splits,
                       rows_per_split, smx::Dropout{}, dtype, device, stream);
}

// The dropout twins: k0, k1 the site's key, threshold and scale of the
// activation mask (stream 0), from the host.
extern "C" int smx_ffn_dropout_bwd_dx(const void* x, const void* g,
                                      const void* w1, const float* b1,
                                      const void* w2, void* dx, int n, int h,
                                      int f, int act, uint32_t k0, uint32_t k1,
                                      uint32_t threshold, float scale,
                                      int dtype, int device, void* stream) {
  return bwd_dx<true>(
      x, g, w1, b1, w2, dx, n, h, f, act,
      smx::make_dropout(k0, k1, smx::kStreamAct, threshold, scale), dtype,
      device, stream);
}

extern "C" int smx_ffn_dropout_bwd_dw(const void* x, const void* g,
                                      const void* w1, const float* b1,
                                      const void* w2, float* out, float* ws,
                                      int n, int h, int f, int act, int splits,
                                      int rows_per_split, uint32_t k0,
                                      uint32_t k1, uint32_t threshold,
                                      float scale, int dtype, int device,
                                      void* stream) {
  return bwd_dw<true>(
      x, g, w1, b1, w2, out, ws, n, h, f, act, splits, rows_per_split,
      smx::make_dropout(k0, k1, smx::kStreamAct, threshold, scale), dtype,
      device, stream);
}
