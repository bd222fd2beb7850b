// K10: dropout_mask — an (n, cols) float32 mask of {0, 1 / (1 - rate)} from
// the port's counter-based generator (dropout.cuh): element (row, col) is
// kept iff its Philox word is >= threshold.
//
// Replaces the TPU kernel speechmix_tpu/ops/pallas/ffn_kernel.py:
// dropout_mask (_mask_kernel), which regenerates a fused kernel's mask for
// the backward's recompute.  The port's backward functions call it for the
// output mask of K12's backward (the (N, H) out-mask) and K11's backward,
// and the plain dropout sites (feature projection, embeddings, the decoder's
// plain cross-attention probabilities, blocks under the row gate) draw their
// masks from it.  On the TPU the bits depend on the grid carve-up; here they
// depend on (key, stream, row, col) only, so any tiling regenerates them.
//
// out: (n, cols) float32, 16-byte aligned when cols % 4 == 0.  One thread
// per four columns of a row: one Philox-4x32-10 call (ten rounds of two
// 32-bit multiplies, about 60 integer operations) and one 16-byte store.
//
// What bounds it on the H100: the store of 4 * n * cols bytes (a (12800,
// 3072) mask is 157 MB, 0.047 ms at 3.35 TB/s) against 15 integer
// operations per element; the integer pipes (64 32-bit multiply-adds per SM
// per clock) put the Philox arithmetic near the same time, so the kernel
// should sit near the memory bound.

#include <stdint.h>

#include "dropout.cuh"

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
    dropout_mask_kernel(float* __restrict__ out, long long n, int cols,
                        smx::Dropout d) {
  const int groups = (cols + 3) / 4;
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  if (i >= n * groups) return;
  const long long row = i / groups;
  const int c = (int)(i % groups) * 4;
  const uint4 b = d.bits4(row, c / 4);
  const float v[4] = {d.keep(b.x), d.keep(b.y), d.keep(b.z), d.keep(b.w)};
  float* o = out + row * cols + c;
  if (cols % 4 == 0) {
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c + j < cols) o[j] = v[j];
    }
  }
}

}  // namespace

extern "C" int smx_dropout_mask(float* out, long long n, int cols,
                                uint32_t k0, uint32_t k1, uint32_t stream,
                                uint32_t threshold, float scale, int device,
                                void* stream_ptr) {
  if (n <= 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (cols % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15u) != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const long long threads = n * ((cols + 3) / 4);
  if ((threads + NT - 1) / NT > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  dropout_mask_kernel<<<(unsigned)((threads + NT - 1) / NT), NT, 0,
                        static_cast<cudaStream_t>(stream_ptr)>>>(
      out, n, cols, smx::make_dropout(k0, k1, stream, threshold, scale));
  return static_cast<int>(cudaGetLastError());
}
