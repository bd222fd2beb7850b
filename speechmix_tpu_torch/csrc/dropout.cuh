// The port's dropout generator, shared by every kernel that draws a mask:
// Philox-4x32-10 (Salmon et al., SC'11; the generator of curand), keyed on
// an element's global coordinates, so that every consumer regenerates the
// same bit whatever its tiling: the forward kernels, the backward kernels,
// K10 (dropout_mask.cu) and the plain PyTorch version in
// speechmix_tpu_torch/ops/kernels/dropout.py, which repeats this arithmetic
// with integer tensor operations and must agree bit for bit.
//
// Element (row, col) of a mask (row: 64-bit, col: 32-bit) takes word col % 4
// of philox(counter = (col / 4, row mod 2^32, row / 2^32, stream),
// key = (k0, k1)).  An attention mask over (B, H, Tq, Tk) uses
// row = (b * H + h) * Tq + q and col = k.  `stream` separates the masks of
// one site: 0 the activation (and attention-probability) mask, 1 the output
// mask.  The rule of the TPU package's _dropout_scale_from_bits
// (speechmix_tpu/ops/pallas/flash_attention_kernel.py) turns bits into the
// multiplier: keep iff bits >= threshold = min(floor(rate * 2^32), 2^32 - 1),
// and a kept element is scaled by the f32 value of 1 / (1 - rate).  The
// host computes threshold and scale, so the kernel and the plain version
// use the same two numbers.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace smx {

constexpr uint32_t kStreamAct = 0;   // activation / attention-probability mask
constexpr uint32_t kStreamOut = 1;   // output mask before the residual

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ uint32_t word(const uint4& b, int j) {
  return j == 0 ? b.x : j == 1 ? b.y : j == 2 ? b.z : b.w;
}

// One mask: the site's key, the mask's stream, and the host's threshold
// and scale.  Passed to kernels by value.
struct Dropout {
  uint32_t k0, k1, stream, threshold;
  float scale;

  // the 32-bit words of columns 4 * group .. 4 * group + 3 of `row`
  __device__ __forceinline__ uint4 bits4(long long row, int group) const {
    const unsigned long long r = static_cast<unsigned long long>(row);
    return philox4x32_10(make_uint4(static_cast<uint32_t>(group),
                                    static_cast<uint32_t>(r),
                                    static_cast<uint32_t>(r >> 32), stream),
                         k0, k1);
  }
  __device__ __forceinline__ float keep(uint32_t bits) const {
    return bits >= threshold ? scale : 0.0f;
  }
  // the multiplier of one element (one Philox call for one word of four)
  __device__ __forceinline__ float at(long long row, int col) const {
    return keep(word(bits4(row, col >> 2), col & 3));
  }
};

// The multipliers m[i][c] of the four elements one lane holds of an
// 8-column group of a wgmma accumulator (hopper.cuh): rows row + 8 i,
// columns col + c, col = 8 j + 2 (lane % 4) + the tile's first column.  Lanes
// 2q and 2q + 1 hold the four columns of one Philox group in rows row and
// row + 8: each draws one row and hands the other the two words it needs,
// one call per four elements.  Every lane of the warp must call it.
__device__ __forceinline__ void accum_mask(const Dropout& d, long long row,
                                           int col, int lane,
                                           float (&m)[2][2]) {
  const bool odd = lane & 1;
  const uint4 b = d.bits4(row + (odd ? 8 : 0), col >> 2);
  const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? b.x : b.z, 1);
  const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? b.y : b.w, 1);
  m[0][0] = d.keep(odd ? r0 : b.x);
  m[0][1] = d.keep(odd ? r1 : b.y);
  m[1][0] = d.keep(odd ? b.z : r0);
  m[1][1] = d.keep(odd ? b.w : r1);
}

inline Dropout make_dropout(uint32_t k0, uint32_t k1, uint32_t stream,
                            uint32_t threshold, float scale) {
  Dropout d;
  d.k0 = k0;
  d.k1 = k1;
  d.stream = stream;
  d.threshold = threshold;
  d.scale = scale;
  return d;
}

}  // namespace smx
